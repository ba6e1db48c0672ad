"""Cross-family generalization of netG (and netC) checkpoints (port of the
JAX package's ``scripts/eval_crossfam.py``).

The committed nets train on the capsule family; held-out capsule seeds
measure in-domain quality only. This app reads the silhouette IOU (and
with netC the texture PSNR) on bodies the training generator cannot emit:

  capsule   — held-out seeds of the training family (the in-domain row)
  sq        — superquadric-limb bodies (boxy cross-sections, flat end
              caps; ``training/datasets/superquadric.py``), shaded renders
  sq_flat   — the same bodies, shading-free flat-colour renders
  ellipsoid — the PPL fixture's flat silhouette of its analytic
              ellipsoid (geometry only: its colours are not the shading
              model ``gt_texture_canvas`` paints)

Fine 257 in bf16 (the bench profile) on the card; ``--cpu`` runs the CPU
at the reduced 129 profile in f32; ``--fine_res`` below 257 takes the
reduced profile at that resolution. The bodies and the fixture's
silhouette are the JAX package's, committed in ``data/eval_golden.npz``.
One JSON line per checkpoint, the script's keys.

Run (on the card; ``--cpu`` for the CPU):
    python -m monoport_tpu_torch.apps.eval_crossfam [--cpu]
        [--fine_res 129] [ckpt.npz ...]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from .. import evaluate
from ..config import get_cfg_defaults
from ..training.datasets import superquadric as sq
from ..training.datasets.capsule import render_front
from ..utils import compile_cache
from ..weights import build_net, load_params, resolve_device
from .eval_netc import DEFAULT_NETC
from .eval_netg import DEFAULT_NETG

FAMILIES = ("capsule", "sq", "sq_flat")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("ckpt", nargs="*", default=[DEFAULT_NETG])
    p.add_argument("--cpu", action="store_true",
                   help="the CPU (default: the card, which must exist)")
    p.add_argument("--fine_res", type=int, default=None,
                   help="ray grid (default: 129 on cpu, 257 otherwise)")
    p.add_argument("--seeds", type=int, nargs="*",
                   default=list(evaluate.HELD_OUT_SEEDS))
    p.add_argument("--no_tex", action="store_true",
                   help="skip the netC texture PSNR")
    p.add_argument("--netc", default=DEFAULT_NETC,
                   help="netC checkpoint for the texture PSNR")
    return p.parse_args(argv)


def fine_res(args) -> int:
    return args.fine_res or (129 if args.cpu else 257)


def build_engine(netG, netC, fine: int, device):
    """The bench profile in bf16 at 257, else the reduced profile in f32
    at ``fine`` (``eval_crossfam.py:95-110``)."""
    if fine >= 257:
        return evaluate.bench_engine(netG, netC, torch.bfloat16, device)
    return evaluate.reduced_engine(netG, netC, torch.float32, device, fine)


def family_readings(engine, seeds, device, golden: dict) -> dict:
    """{family: [(readings, frame) of each seed]} (``frame_readings``;
    the ellipsoid: one, geometry only)."""
    fams = {fam: [] for fam in FAMILIES}
    for seed in seeds:
        caps = evaluate.capsule_body(seed, device, golden)
        fams["capsule"].append(evaluate.frame_readings(
            engine, render_front(caps, 512)[0], evaluate.capsule_occ(caps)))
        body = evaluate.sq_body(seed, device, golden)
        for fam, flat in (("sq", False), ("sq_flat", True)):
            fams[fam].append(evaluate.frame_readings(
                engine, sq.render_front(body, 512, flat=flat)[0],
                evaluate.sq_occ(body), flat=flat))
    fams["ellipsoid"] = [evaluate.frame_readings(
        engine, evaluate.fixture_image(device, golden),
        evaluate.ellipsoid_occupancy, texture=False)]
    return fams


def summary(fams: dict) -> dict:
    """The script's keys: each family's mean and least IOU, and its mean
    and least PSNR where it has one (rounded as the script rounds)."""
    res = {}
    for fam, rows in fams.items():
        ious = [r["iou"] for r, _ in rows]
        res[fam] = round(float(np.mean(ious)), 4)
        res[fam + "_min"] = round(float(np.min(ious)), 4)
    for fam, rows in fams.items():
        psnrs = [r["psnr"] for r, _ in rows if r["psnr"] is not None]
        if psnrs:
            res[fam + "_tex_psnr"] = round(float(np.mean(psnrs)), 2)
            res[fam + "_tex_psnr_min"] = round(float(np.min(psnrs)), 2)
    return res


def main(argv=None) -> list:
    args = parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    compile_cache.enable()
    fine = fine_res(args)
    cfg = get_cfg_defaults()
    netC = None
    if not args.no_tex and os.path.exists(args.netc):
        netC = build_net(cfg.netC, load_params(args.netc)[0], device)
    golden = evaluate.load_golden()
    lines = []
    for path in args.ckpt:
        netG = build_net(cfg.netG, load_params(path)[0], device)
        engine = build_engine(netG, netC, fine, device)
        res = {"ckpt": os.path.basename(path), "fine_res": fine}
        res.update(summary(family_readings(engine, args.seeds, device,
                                           golden)))
        print(json.dumps(res), flush=True)
        lines.append(res)
    return lines


if __name__ == "__main__":
    main()

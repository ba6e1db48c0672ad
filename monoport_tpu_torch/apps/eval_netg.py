"""Held-out silhouette IOU of netG checkpoints against the analytic ground
truth (port of the JAX package's ``scripts/eval_netg.py``).

The bench profile (``evaluate.bench_engine``, bf16) on the card, the same
metric as ``bench.py``'s ``real_model_vs_gt_iou``: each held-out body's
frontal frame, its ``valid`` against ``evaluate.gt_silhouette`` (64
z-slices at 257). With ``--cpu``: the CPU and the reduced 129 profile in
f32 (``evaluate.reduced_engine``), as ``eval_crossfam.py --cpu``. The
bodies are the JAX package's draws committed in ``data/eval_golden.npz``.

Run (on the card; ``--cpu`` for the CPU):
    python -m monoport_tpu_torch.apps.eval_netg [ckpt.npz ...]
"""

from __future__ import annotations

import argparse
import os

import torch

from .. import evaluate
from ..config import get_cfg_defaults
from ..training.datasets.capsule import render_front
from ..utils import compile_cache
from ..weights import DATA, build_net, load_params, resolve_device

DEFAULT_NETG = os.path.normpath(os.path.join(DATA, "netg_capsule.npz"))


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("ckpt", nargs="*", default=[DEFAULT_NETG],
                   help="netG checkpoints (default: the committed one)")
    p.add_argument("--cpu", action="store_true",
                   help="the CPU at the reduced 129 profile (default: the "
                   "card at the bench profile; it must exist)")
    return p.parse_args(argv)


def app_device(args) -> torch.device:
    """The eval apps' device: the card, or with ``--cpu`` the CPU."""
    return resolve_device("cpu" if args.cpu else None)


def make_engine(netG, netC, args):
    """The eval apps' engine: the bench profile in bf16 on the card, or
    with ``--cpu`` the reduced 129 profile in f32 on the CPU."""
    if args.cpu:
        return evaluate.reduced_engine(netG, netC, torch.float32, "cpu")
    return evaluate.bench_engine(netG, netC, torch.bfloat16,
                                 app_device(args))


def eval_ckpt(path: str, args) -> dict:
    """{seed: IOU} of the netG checkpoint at ``path``."""
    device = app_device(args)
    netG = build_net(get_cfg_defaults().netG, load_params(path)[0], device)
    engine = make_engine(netG, None, args)
    golden = evaluate.load_golden()
    ious = {}
    for seed in evaluate.HELD_OUT_SEEDS:
        caps = evaluate.capsule_body(seed, device, golden)
        image = render_front(caps, 512)[0]
        readings, _ = evaluate.frame_readings(engine, image,
                                              evaluate.capsule_occ(caps))
        ious[seed] = readings["iou"]
    return ious


def main(argv=None) -> dict:
    args = parse_args(argv)
    app_device(args)
    compile_cache.enable()
    results = {}
    for path in args.ckpt:
        ious = eval_ckpt(path, args)
        mean = sum(ious.values()) / len(ious)
        print(f"{path}: " + " ".join(f"seed{k}={v:.4f}"
                                     for k, v in ious.items())
              + f" mean={mean:.4f}", flush=True)
        results[path] = ious
    return results


if __name__ == "__main__":
    main()

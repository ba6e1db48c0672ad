"""Held-out texture PSNR of a netG / netC checkpoint pair against the
renderer's shading model (port of the JAX package's
``scripts/eval_netc.py``).

The frames of ``apps/eval_netg`` with netC: ``evaluate.texture_psnr``
(``gt_texture_canvas`` at the reconstructed surface, ``visualize``,
``masked_psnr`` over the frame's mask), the metric of ``bench.py``'s
``real_tex_psnr_db``. netC must be retrained whenever netG changes (its
feature prior moves), so it is read beside the netG it was trained on.

Run (on the card; ``--cpu`` for the CPU at the reduced 129 profile):
    python -m monoport_tpu_torch.apps.eval_netc [netg.npz [netc.npz
        [seed ...]]]
"""

from __future__ import annotations

import argparse
import os

from .. import evaluate
from ..config import get_cfg_defaults
from ..training.datasets.capsule import render_front
from ..utils import compile_cache
from ..weights import DATA, build_net, load_params
from .eval_netg import DEFAULT_NETG, app_device, make_engine

DEFAULT_NETC = os.path.normpath(os.path.join(DATA, "netc_capsule.npz"))


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("netg", nargs="?", default=DEFAULT_NETG)
    p.add_argument("netc", nargs="?", default=DEFAULT_NETC)
    p.add_argument("seeds", type=int, nargs="*",
                   default=list(evaluate.HELD_OUT_SEEDS))
    p.add_argument("--cpu", action="store_true",
                   help="the CPU at the reduced 129 profile (default: the "
                   "card at the bench profile; it must exist)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """-> {seed: (PSNR dB, mean |err|)}."""
    args = parse_args(argv)
    device = app_device(args)
    compile_cache.enable()
    cfg = get_cfg_defaults()
    netG = build_net(cfg.netG, load_params(args.netg)[0], device)
    netC = build_net(cfg.netC, load_params(args.netc)[0], device)
    engine = make_engine(netG, netC, args)
    golden = evaluate.load_golden()
    rows = {}
    for seed in args.seeds:
        caps = evaluate.capsule_body(seed, device, golden)
        readings, _ = evaluate.frame_readings(
            engine, render_front(caps, 512)[0], evaluate.capsule_occ(caps))
        rows[seed] = (readings["psnr"], readings["mae"])
        print(f"seed{seed}: psnr={readings['psnr']:.2f}dB "
              f"mae={readings['mae']:.4f}", flush=True)
    mean = sum(r[0] for r in rows.values()) / len(rows)
    print(f"{args.netg} + {args.netc}: mean psnr={mean:.2f}dB", flush=True)
    return rows


if __name__ == "__main__":
    main()

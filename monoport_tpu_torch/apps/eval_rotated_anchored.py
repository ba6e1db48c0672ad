"""Quality of the anchored rotated refine against the exact per-point
path, on the committed weights (port of the JAX package's
``scripts/eval_rotated_anchored.py``).

The anchored query (``MonoPortNet.query_taps_anchored``, kernel 3) mixes
features between K anchors along each refine ray: exact geometry,
approximate features wherever the bilinear sample is nonlinear across the
segment. At each orbit pose of ``evaluate.POSES``, the rotated frame's
silhouette, depth and texture with ``rot_anchors`` 'auto' and 3 against
``rot_anchors=None`` (the same march and compaction: the only difference
is the refine levels' feature mix), and each path's silhouette IOU against
the analytic ground truth in view space (``evaluate.rotated_anchored``).
``--texels`` sweeps the 'auto' planner's tolerance instead.

The profile of the script's ``build()``: fine 129, march (17, 33),
compaction 0.625; bf16 on the card, f32 with ``--cpu`` (the script's CPU
run). Body 31337, the JAX draw committed in ``data/eval_golden.npz``.

Run (on the card; ``--cpu`` for the CPU):
    python -m monoport_tpu_torch.apps.eval_rotated_anchored [--texels ...]
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from .. import evaluate
from ..training.datasets.capsule import render_front
from ..utils import compile_cache
from ..weights import load_default_networks, resolve_device


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--texels", type=float, nargs="*", default=None,
                   help="sweep rot_anchor_texels tolerances at "
                   "rot_anchors='auto' instead of the default "
                   "(None, 'auto'@1.0, pinned-3) mode comparison")
    p.add_argument("--cpu", action="store_true",
                   help="the CPU in f32 (default: the card in bf16; it "
                   "must exist)")
    return p.parse_args(argv)


def rounded(out: dict) -> dict:
    """The script's rounding: IOU and depth to 4 digits, texture to 5."""
    return {k: (round(v, 5 if "_tex_mad_" in k else 4)
                if isinstance(v, float) else v) for k, v in out.items()}


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    dtype = torch.float32 if args.cpu else torch.bfloat16
    compile_cache.enable()
    t0 = time.time()
    netG, netC = load_default_networks(device)
    caps = evaluate.capsule_body(evaluate.BENCH_SEED, device)
    image = render_front(caps, 512)[0]
    out, _ = evaluate.rotated_anchored(netG, netC, image, caps, dtype,
                                       device, texels=args.texels)
    out = rounded(out)
    for yaw, pitch in evaluate.POSES:
        tag = f"y{int(yaw)}p{int(pitch)}"
        print(tag, {k: v for k, v in out.items() if k.startswith(tag)},
              flush=True)
    out["wall_s"] = round(time.time() - t0, 1)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

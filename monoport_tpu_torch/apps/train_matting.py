"""Train MatteNet on synthetic human composites made on the device, and
save its weights in the JAX package's npz format (port of
``monoport_tpu/apps/train_matting.py``).

Adam from flax-distributed initial weights; a fresh batch a step
(``training/matting.synth_batch``); every ``--chunk`` steps the chunk's
mean loss is read (one host sync a chunk). At the end, the alpha IOU on
held-out composites, and ``save_params`` (f16, ``__width__``), which
``Segmentation.load_default`` of either package reads.

Run (on the card; ``--cpu`` for the CPU):
    python -m monoport_tpu_torch.apps.train_matting --steps 3000 \\
        --out mattenet.npz
"""

from __future__ import annotations

import argparse
import time

import torch

from ..parallel.train_step import timed_convolutions
from ..pipeline.segmentation import MatteNet
from ..training.matting import (alpha_iou, make_train_fns, save_params,
                                synth_batch)
from ..utils import compile_cache
from ..weights import resolve_device


def run_chunks(runs: list, state, generator: torch.Generator, steps: int,
               chunk: int, device: torch.device) -> dict:
    """``steps`` steps in chunks of ``chunk``, the chunks taking the
    ``(label, run_fn)`` of ``runs`` in turn over one state; each chunk's
    mean loss is read once, after its last step. -> {'chunk_losses',
    'chunk_seconds' (CUDA events on the card, the host clock elsewhere),
    'chunk_steps', 'chunk_labels'}."""
    out = {"chunk_losses": [], "chunk_seconds": [], "chunk_steps": [],
           "chunk_labels": []}
    t0 = time.time()
    done = turn = 0
    while done < steps:
        n = min(chunk, steps - done)
        label, run_fn = runs[turn % len(runs)]
        if device.type == "cuda":
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            events[0].record()
        start = time.perf_counter()
        state, loss = run_fn(state, generator, n)
        if device.type == "cuda":
            events[1].record()
        loss = float(loss)                       # the chunk's one host read
        out["chunk_seconds"].append(
            events[0].elapsed_time(events[1]) / 1e3
            if device.type == "cuda" else time.perf_counter() - start)
        out["chunk_losses"].append(loss)
        out["chunk_steps"].append(n)
        out["chunk_labels"].append(label)
        done += n
        turn += 1
        print(f"step {done}/{steps} {label} mean loss {loss:.4f} "
              f"({time.time() - t0:.0f}s)", flush=True)
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=3000)
    parser.add_argument("--chunk", type=int, default=100,
                        help="steps between host reads of the loss")
    parser.add_argument("--size", type=int, default=256)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--width", type=int, default=16)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (default: the card, which "
                        "must exist)")
    parser.add_argument("--out", default="mattenet.npz")
    args = parser.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    compile_cache.enable()
    timed_convolutions(device)

    net = MatteNet(width=args.width).to(device)
    init_fn, run_fn = make_train_fns(net, args.size, args.batch, args.lr)
    state = init_fn(torch.Generator().manual_seed(args.seed))
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    result = run_chunks([(f"size {args.size}", run_fn)], state, gen,
                        args.steps, args.chunk, device)

    # held-out alpha IOU on fresh composites
    net.eval()
    with torch.no_grad():
        images, alpha_gt = synth_batch(
            torch.Generator(device=device).manual_seed(args.seed + 10_000),
            8, args.size)
        logits = net(images * 2.0 - 1.0)[..., 0]
        iou = float(alpha_iou(torch.sigmoid(logits), alpha_gt))
    print(f"held-out alpha IOU @{args.size}: {iou:.4f}", flush=True)

    save_params(args.out, net, args.width)
    print(f"saved {args.out}", flush=True)
    return {"iou": iou, "params": sum(p.numel() for p in net.parameters()),
            **result}


if __name__ == "__main__":
    main()

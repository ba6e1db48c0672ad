"""Train the netG on the capsule-human dataset, made on the device, and save
its weights in the JAX package's npz format (port of
``monoport_tpu/apps/train_capsule_netG.py``).

Adam on a cosine schedule (to 5% of ``--lr`` at ``--steps``), from
flax-distributed initial weights or ``--init_from`` an npz; every
``--chunk`` steps the chunk's mean loss is read (one host sync a chunk).
At the end, the point IOU on a held-out body, and ``save_params``.

Run (on the card; ``--device cpu`` for the CPU):
    python -m monoport_tpu_torch.apps.train_capsule_netG --steps 1500 \\
        --out netg_capsule.npz
"""

from __future__ import annotations

import argparse
import functools
import time

import torch

from ..config import get_cfg_defaults
from ..models import MonoPortNet
from ..parallel.train_step import (Optimizer, ScaleByAdam,
                                   ScaleByLearningRate, cosine_decay_schedule,
                                   create_train_state, init_params,
                                   make_train_step, timed_convolutions)
from ..training.datasets.capsule import (render_front, sample_points,
                                         skeleton3d, synth_train_batch)
from ..utils import compile_cache
from ..utils.params_io import save_params
from ..weights import load_params, resolve_device, torch_state_from_flax


def run_chunks(step_fn, state, batch_fn, steps: int, chunk: int,
               device: torch.device, label: str) -> dict:
    """``steps`` train steps in chunks; each chunk's mean loss is read
    once, after its last step. -> {'chunk_losses', 'chunk_seconds'
    (CUDA events on the card, the host clock elsewhere), 'chunk_steps'}."""
    losses_out, seconds, sizes = [], [], []
    t0 = time.time()
    done = 0
    while done < steps:
        n = min(chunk, steps - done)
        if device.type == "cuda":
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            events[0].record()
        start = time.perf_counter()
        losses = []
        for _ in range(n):
            state, loss = step_fn(state, batch_fn())
            losses.append(loss)
        if device.type == "cuda":
            events[1].record()
        mean = float(torch.stack(losses).mean())
        seconds.append(events[0].elapsed_time(events[1]) / 1e3
                       if device.type == "cuda"
                       else time.perf_counter() - start)
        losses_out.append(mean)
        sizes.append(n)
        done += n
        print(f"step {done}/{steps} mean {label} {mean:.4f} "
              f"({time.time() - t0:.0f}s)", flush=True)
    return {"chunk_losses": losses_out, "chunk_seconds": seconds,
            "chunk_steps": sizes}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=1500)
    parser.add_argument("--chunk", type=int, default=50)
    parser.add_argument("--size", type=int, default=512)
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--points", type=int, default=4096)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--hard", type=int, default=1,
                        help="the hard curriculum: wider scales, harder "
                        "poses, clothing displacement, textured "
                        "appearance (the plain look stays in distribution)")
    parser.add_argument("--sigma", type=float, default=None,
                        help="surface-sample sigma (default: 0.035 hard, "
                        "0.05 plain)")
    parser.add_argument("--family", default="capsule",
                        choices=["capsule", "mixed"],
                        help="mixed: half hard-capsule, half superquadric "
                        "bodies with a flat-render share")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None,
                        help="torch device; default cuda (no CPU fallback)")
    parser.add_argument("--init_from", default=None,
                        help="npz checkpoint to continue training from")
    parser.add_argument("--out", default="netg_capsule.npz")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    compile_cache.enable()
    timed_convolutions(device)

    net = MonoPortNet(get_cfg_defaults().netG)
    init_params(net, torch.Generator().manual_seed(args.seed))
    if args.init_from:
        # strict: continuing training requires the same architecture
        net.load_state_dict(torch_state_from_flax(
            load_params(args.init_from)[0]))
        print(f"continuing from {args.init_from}", flush=True)
    net.to(device)
    n_params = sum(p.numel() for p in net.parameters())
    print(f"netG params: {n_params / 1e6:.2f}M", flush=True)
    tx = Optimizer(ScaleByAdam(), ScaleByLearningRate(
        cosine_decay_schedule(args.lr, args.steps, alpha=0.05)))
    state = create_train_state(net, tx)

    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    if args.family == "mixed":
        from ..training.datasets.superquadric import mixed_train_batch
        batch_fn = functools.partial(mixed_train_batch, gen, args.batch,
                                     args.size, args.points,
                                     sigma=args.sigma)
    else:
        batch_fn = functools.partial(synth_train_batch, gen, args.batch,
                                     args.size, args.points,
                                     hard=bool(args.hard), sigma=args.sigma)
    result = run_chunks(make_train_step(net), state, batch_fn, args.steps,
                        args.chunk, device, "loss")

    # held-out point-classification IOU on a fresh body
    net.eval()
    with torch.no_grad():
        hgen = torch.Generator(device=device)
        caps = skeleton3d(hgen.manual_seed(args.seed + 31337))
        image, _ = render_front(caps, args.size)
        pts, labels = sample_points(hgen.manual_seed(2), caps, 8192)
        pred = net(image[None], pts[None],
                   torch.eye(4, device=device)[None])
    p = pred[0, :, 0].cpu().numpy() > 0.5
    g = labels[:, 0].cpu().numpy() > 0.5
    iou = float((p & g).sum() / max((p | g).sum(), 1))
    print(f"held-out point IOU: {iou:.4f}", flush=True)

    save_params(args.out, net)
    print(f"saved {args.out}", flush=True)
    return {"iou": iou, "params": n_params, **result}


if __name__ == "__main__":
    main()

"""End-to-end learned reconstruction on synthetic data (port of the JAX
package's ``scripts/demo_synthetic.py``).

Trains a small netG (a 2-stack, 128-wide hourglass and the head 129-256-
128-1) on procedural blob scenes with exact occupancy labels
(``training/datasets/synthetic.SyntheticBlobDataset``; Adam 2e-3, chunks
of 50 steps through ``make_scan_train_step``), then reconstructs a
training scene and the held-out last scene with the dense engine (the
hierarchy (17, 33, 65), every level one batch through the per-point MLP
kernel) and writes:

  <out>/recon_norm.png   — the held-out scene's normal-shaded render
  <out>/mesh.obj         — its marching-tetrahedra mesh
  <out>/metrics.json     — occupancy IOU against the ground truth (held
                           out and training scene), mesh counts

The proof that the whole system reconstructs with no checkpoint at all.
The head's widths go to ``MonoPortNet`` as ``head_channels``: no head is
added to the package's registry.

Run (on the card; ``--cpu`` for the CPU):
    python -m monoport_tpu_torch.apps.demo_synthetic [--steps 300]
        [--out out/]
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import struct
import time
import zlib

import numpy as np
import torch

from ..config import CN
from ..engine import EngineCfg, ReconEngine
from ..models import MonoPortNet
from ..parallel.train_step import (create_train_state, make_optimizer,
                                   make_scan_train_step, timed_convolutions)
from ..recon.dense import grid_points
from ..recon.hierarchy import HierarchicalRecon
from ..recon.marching import extract_mesh
from ..training.datasets import SyntheticBlobDataset
from ..training.metrics import occupancy_iou
from ..utils import compile_cache
from ..utils.mesh import save_obj_mesh
from ..weights import resolve_device

DEMO_HEAD = (129, 256, 128, 1)
CHUNK = 50          # steps a call of the scan step (one host read a chunk)
BATCH = 4
# the train-step batch's keys and the item keys they stack
# (``SyntheticBlobDataset.as_train_batch``)
BATCH_KEYS = {"images": "image", "points": "samples_geo", "calibs": "calib",
              "labels": "labels_geo"}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--out", default="out")
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true",
                   help="the CPU (default: the card, which must exist)")
    return p.parse_args(argv)


def demo_net() -> MonoPortNet:
    opt = CN()
    opt.projection = "orthogonal"
    opt.backbone = CN({"IMF": "PIFuHGFilters", "num_stack": 2,
                       "num_hourglass": 2, "hourglass_dim": 128,
                       "norm": "group", "hg_down": "ave_pool"})
    opt.normalizer = CN({"IMF": "PIFuNomalizer"})
    opt.head = CN({"IMF": "PIFuNetGMLP"})
    opt.loss = CN({"IMF": "MSE"})
    return MonoPortNet(opt, head_channels=DEMO_HEAD)


def write_png(path: str, rgb: np.ndarray) -> None:
    """[H, W, 3] uint8 as an 8-bit RGB PNG (zlib, no imaging library)."""
    h, w, _ = rgb.shape
    rows = b"".join(b"\x00" + rgb[i].tobytes() for i in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows, 6))
                + chunk(b"IEND", b""))


def recon_iou(ds: SyntheticBlobDataset, index: int, engine: ReconEngine,
              device) -> tuple[dict, float]:
    """The dense frame of scene ``index`` and its volume's occupancy IOU
    against the scene's exact occupancy on the 65^3 lattice."""
    item = ds[index]
    image = torch.as_tensor(item["image"][None], device=device)
    out = engine.frame(image, calib=item["calib"][None])
    centers, radii = ds._blobs(np.random.RandomState(ds.seed + index))
    pts = grid_points(65).numpy()
    gt = ds.occupancy(pts, centers, radii).reshape(65, 65, 65)
    return out, float(occupancy_iou(out["sdf"],
                                    torch.as_tensor(gt, device=device)))


def main(argv=None) -> dict:
    """-> metrics.json's keys, the chunks' last losses ('losses') and the
    training's steps a second ('steps_per_s', the host's numpy draws of
    the scenes included)."""
    args = parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    compile_cache.enable()
    timed_convolutions(device)

    net = demo_net().to(device)
    ds = SyntheticBlobDataset(size=args.size, num_sample_geo=1024,
                              length=256, seed=args.seed)
    state = create_train_state(net, make_optimizer("adam", 2e-3),
                               torch.Generator().manual_seed(0))
    step = make_scan_train_step(net)

    # a scene is a function of its index: each is drawn once (the JAX
    # script draws it again at every visit, to the same arrays)
    item = functools.lru_cache(maxsize=None)(ds.__getitem__)
    rng = np.random.RandomState(args.seed)
    done, losses = 0, []
    t0 = time.perf_counter()
    while done < args.steps:
        draws = [[item(int(i)) for i in rng.randint(0, len(ds) - 1, BATCH)]
                 for _ in range(min(CHUNK, args.steps - done))]
        stacked = {k: torch.as_tensor(np.stack([[it[src] for it in d]
                                                for d in draws]),
                                      device=device)
                   for k, src in BATCH_KEYS.items()}
        state, chunk_losses = step(state, stacked)
        done += len(draws)
        losses.append(float(chunk_losses[-1]))     # the chunk's host read
        print(f"step {done}: loss {losses[-1]:.4f}", flush=True)
    train_s = time.perf_counter() - t0

    engine = ReconEngine(net, None, recon=HierarchicalRecon(
        resolutions=(17, 33, 65), budgets=(0, 8192, 32768)),
        config=EngineCfg.flat(render_size=256), device=device)
    _, train_iou = recon_iou(ds, 0, engine, device)
    out, iou = recon_iou(ds, len(ds) - 1, engine, device)

    os.makedirs(args.out, exist_ok=True)
    img = torch.nan_to_num(out["render_norm"].float(), nan=1.0)
    write_png(os.path.join(args.out, "recon_norm.png"),
              (img.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy())
    verts, faces = extract_mesh(out["sdf"], max_cells=32768)
    save_obj_mesh(os.path.join(args.out, "mesh.obj"), verts, faces)

    metrics = {"iou": iou, "train_iou": train_iou,
               "verts": int(len(verts)), "faces": int(len(faces))}
    with open(os.path.join(args.out, "metrics.json"), "w") as f:
        json.dump(metrics, f)
    print("metrics:", metrics, flush=True)
    return {**metrics, "losses": losses, "steps_per_s": done / train_s}


if __name__ == "__main__":
    main()

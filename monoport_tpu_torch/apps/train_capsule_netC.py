"""Train the colour net (netC) on capsule humans, with the committed
capsule netG frozen as the geometry-feature prior (port of
``monoport_tpu/apps/train_capsule_netC.py``).

Surface points get ground-truth colours from the shading model the render
painted into the image, so netC does real pixel-aligned colour inference;
base colours are jittered per body. The global-norm clip (1.0) before Adam
is load-bearing: the ResnetFilter's output is not normalised, and plain
Adam at lr >= 1e-3 saturates the tanh head. ``--mixed`` is the committed
netC's cross-family curriculum (half capsule, half superquadric bodies,
a ``--flat_prob`` shading-free share whose colour labels drop the depth
cue too). At the end: the colour L1 and PSNR on a held-out batch, and
``save_params``.

Run (on the card; ``--device cpu`` for the CPU):
    python -m monoport_tpu_torch.apps.train_capsule_netC --steps 3000 \\
        --mixed 1 --out netc_capsule.npz
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..config import get_cfg_defaults
from ..models import MonoPortNet
from ..parallel.train_step import (ClipByGlobalNorm, Optimizer, ScaleByAdam,
                                   ScaleByLearningRate, cosine_decay_schedule,
                                   create_train_state, init_params,
                                   make_train_step, timed_convolutions)
from ..training.datasets import capsule
from ..training.metrics import masked_psnr
from ..weights import (DATA, build_net, load_params, resolve_device,
                       torch_state_from_flax)
from ..utils import compile_cache
from ..utils.params_io import save_params
from .train_capsule_netG import run_chunks


class ColourBatches:
    """netC batches (images, surface points, colours, calibs) drawn from
    ``gen``, the curriculum of the JAX app's ``make_batch``."""

    def __init__(self, gen: torch.Generator, batch: int, size: int,
                 points: int, hard: bool, mixed: bool, flat_prob: float):
        if mixed and batch < 2:
            raise ValueError("--mixed needs batch >= 2")
        self.gen, self.batch, self.size, self.points = gen, batch, size, points
        self.hard, self.mixed, self.flat_prob = hard, mixed, flat_prob

    def _rand(self, *shape):
        return capsule._rand(self.gen, *shape)

    def _plain_anchor(self, app: dict):
        """Half the stream keeps the plain look (the default base with a
        brightness jitter, no texture, bare body): without it the texture
        curriculum makes netC paint faint patterns on plain bodies."""
        plain = self._rand() < 0.5
        keep = 1.0 - plain.float()
        base_plain = capsule.default_base(self.gen.device) \
            * capsule._uniform(self._rand(3), 0.8, 1.15)
        return {"base": torch.where(plain, base_plain, app["base"]),
                "amp": app["amp"] * keep, "freq": app["freq"],
                "phase": app["phase"]}, keep

    def _flat(self):
        """The shading-free share (--mixed only): the render drops the
        depth cue and the colour labels drop it with it."""
        return (self._rand() < self.flat_prob) if self.mixed else False

    def capsule_item(self):
        gen = self.gen
        if self.hard:
            caps = capsule.clothe(gen, capsule.skeleton3d(
                gen, scale_range=(0.45, 1.0), pose_spread=1.35,
                z_spread=0.35), amp=(0.0, 0.30))
            app, keep = self._plain_anchor(capsule.sample_appearance(gen))
            amp_v, freq, phase = caps[3]
            caps = (caps[0], caps[1], caps[2], (amp_v * keep, freq, phase))
            flat = self._flat()
            image, _ = capsule.render_front(caps, self.size, appearance=app,
                                            flat=flat)
            pts = capsule.sample_surface_points(gen, caps, self.points)
            return image, pts, capsule.surface_color(pts, appearance=app,
                                                     flat=flat)
        caps = capsule.skeleton3d(gen)
        base = capsule.default_base(gen.device) \
            * capsule._uniform(self._rand(3), 0.7, 1.2)
        image, _ = capsule.render_front(caps, self.size, base_color=base)
        pts = capsule.sample_surface_points(gen, caps, self.points)
        return image, pts, capsule.surface_color(pts, base_color=base)

    def superquadric_item(self):
        """The superquadric half of --mixed (same appearance and shading
        model, so ``capsule.surface_color`` is its colour truth too)."""
        from ..training.datasets import superquadric as sq

        body = sq.sq_body(self.gen)
        app, _ = self._plain_anchor(capsule.sample_appearance(self.gen))
        flat = self._flat()
        image, _ = sq.render_front(body, self.size, appearance=app,
                                   flat=flat)
        pts = sq.sample_surface_points(self.gen, body, self.points)
        return image, pts, capsule.surface_color(pts, appearance=app,
                                                 flat=flat)

    def __call__(self) -> dict:
        n_caps = max(1, self.batch // 2) if self.mixed else self.batch
        items = [self.capsule_item() for _ in range(n_caps)]
        items += [self.superquadric_item()
                  for _ in range(self.batch - n_caps)]
        image, pts, colours = (torch.stack(x) for x in zip(*items))
        calib = torch.eye(4, device=self.gen.device).expand(
            self.batch, 4, 4).contiguous()
        return {"images": image, "points": pts, "labels": colours,
                "calibs": calib}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=3000)
    parser.add_argument("--chunk", type=int, default=150)
    parser.add_argument("--size", type=int, default=512)
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--points", type=int, default=4096)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--hard", type=int, default=1,
                        help="netG's curriculum: clothed bodies + textured "
                        "appearance (netC must read colour from the image)")
    parser.add_argument("--mixed", type=int, default=0,
                        help="cross-family curriculum: capsule / "
                        "superquadric bodies half and half, with a "
                        "--flat_prob shading-free share")
    parser.add_argument("--flat_prob", type=float, default=0.3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None,
                        help="torch device; default cuda (no CPU fallback)")
    parser.add_argument("--netg", default=os.path.join(DATA,
                                                       "netg_capsule.npz"))
    parser.add_argument("--init_from", default=None,
                        help="npz checkpoint to continue training from")
    parser.add_argument("--out", default="netc_capsule.npz")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    compile_cache.enable()
    timed_convolutions(device)

    cfg = get_cfg_defaults()
    netG = build_net(cfg.netG, load_params(args.netg)[0], device)
    netC = MonoPortNet(cfg.netC)
    init_params(netC, torch.Generator().manual_seed(args.seed))
    if args.init_from:
        netC.load_state_dict(torch_state_from_flax(
            load_params(args.init_from)[0]))
        print(f"continuing from {args.init_from}", flush=True)
    netC.to(device)
    tx = Optimizer(ClipByGlobalNorm(1.0), ScaleByAdam(), ScaleByLearningRate(
        cosine_decay_schedule(args.lr, args.steps, alpha=0.05)))
    state = create_train_state(netC, tx)

    def with_prior(batch: dict) -> dict:
        with torch.no_grad():        # netG is frozen: no gradients into it
            batch["feat_prior"] = netG.filter(batch["images"])[-1][-1]
        return batch

    draw = ColourBatches(
        torch.Generator(device=device).manual_seed(args.seed + 1),
        args.batch, args.size, args.points, bool(args.hard),
        bool(args.mixed), args.flat_prob)
    result = run_chunks(make_train_step(netC), state,
                        lambda: with_prior(draw()), args.steps, args.chunk,
                        device, "L1")

    netC.eval()
    draw.gen = torch.Generator(device=device).manual_seed(args.seed + 777)
    batch = with_prior(draw())
    with torch.no_grad():
        pred = netC(batch["images"], batch["points"], batch["calibs"],
                    feat_prior=batch["feat_prior"])
    err = float(torch.abs(pred - batch["labels"]).mean())
    psnr, _ = masked_psnr(pred.cpu().numpy() * 0.5 + 0.5,
                          batch["labels"].cpu().numpy() * 0.5 + 0.5,
                          np.ones(pred.shape[:2], bool))
    print(f"held-out colour L1 (on the [-1,1] scale): {err:.4f}, "
          f"PSNR {psnr:.2f} dB", flush=True)
    save_params(args.out, netC)
    print(f"saved {args.out}", flush=True)
    return {"l1": err, "psnr": psnr, **result}


if __name__ == "__main__":
    main()

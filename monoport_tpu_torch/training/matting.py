"""MatteNet training: synthetic human composites made on the device, and
the train loop (port of ``monoport_tpu/training/matting.py``).

A composite is a 2D articulated "capsule human" (torso, head, two
segments for each limb; random pose, scale and position) with a random
low-frequency colour field and an edge-darkening shade, over a textured
background with round distractor blobs, plus sensor noise; about 15% of
the frames hold no person, so the matte must also reject person-less
scenes.

Every generator is split in two, as ``training/datasets/capsule.py``'s
are: a draw from a ``torch.Generator`` on its device
(``composite_draws``) and a deterministic builder from the draws
(``skeleton_from_uniforms``, ``texture_from_uniforms``,
``composite_from_draws``), which the tests feed the JAX package's own
draws. Uniforms are mapped as JAX maps them, ``u * (hi - lo) + lo`` in
f32; a Bernoulli draw is a uniform below its probability, as
``jax.random.bernoulli``. The builders take any leading batch axes.

``make_train_fns`` draws and steps on the device with no host sync inside
a chunk: the chunk's mean loss comes back as a device tensor.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.constants import device_constant
from ..parallel.train_step import (TrainState, create_train_state,
                                   init_params, loss_step, make_optimizer)
from ..pipeline.segmentation import MatteNet, matting_loss
from ..utils.params_io import save_params as _save_params
from ..weights import flax_params_from_torch, load_params as _load_params
from .datasets.capsule import _rand, _randn, _uniform

N_SKELETON = 14      # uniforms a skeleton
N_TEXTURE = 15       # uniforms a texture: base 3, freq 2 x 3, phase 3, amp 3
KEEP_P = 0.85        # the share of composites that hold a person


# -- procedural capsule humans ---------------------------------------------
def _grid_array(size: int) -> np.ndarray:
    # correctly rounded; jnp.linspace's f32 arithmetic is within an ulp
    ax = np.linspace(-1.0, 1.0, size).astype(np.float32)
    gx, gy = np.meshgrid(ax, -ax, indexing="xy")     # row 0 = top = +y
    return np.stack([gx, gy], axis=-1)


def pixel_grid(size: int, device) -> torch.Tensor:
    """[S, S, 2] (x, y) over [-1, 1]^2, row 0 at the top (+y); uploaded
    once a size and device."""
    return device_constant(_grid_array, (size,), torch.device(device),
                           torch.float32)


def _norm(v: torch.Tensor) -> torch.Tensor:
    # jnp.linalg.norm's sum of squares (not torch's scaled reduction)
    return torch.sqrt((v * v).sum(-1))


def skeleton_from_uniforms(u: torch.Tensor):
    """[..., 14] uniforms in [0, 1) -> capsules (a [..., 11, 2], b [..., 11,
    2], r [..., 11]): a humanoid in math convention (y up) within
    [-1, 1]^2."""
    def U(k, lo, hi):
        return _uniform(u[..., k], lo, hi)

    scale = U(0, 0.6, 1.05)
    pelvis = torch.stack([U(1, -0.3, 0.3), U(2, -0.35, 0.05)], -1)
    lean = U(3, -0.25, 0.25)
    c, s = torch.cos(lean), torch.sin(lean)

    def rot(x, y):
        """rot(lean) @ [x, y] for constants x, y."""
        return torch.stack([c * x - s * y, s * x + c * y], -1)

    def vec(v):
        return v[..., None]

    up = rot(0.0, 1.0)
    neck = pelvis + up * vec(0.52 * scale)
    head_c = neck + up * vec(0.16 * scale)
    torso_r = U(4, 0.11, 0.17) * scale
    head_r = U(5, 0.085, 0.12) * scale

    def limb(k0, root, base_angle, spread, l1, l2, r):
        a1 = base_angle + U(k0, -spread, spread)
        a2 = a1 + U(k0 + 1, -0.9, 0.9)
        d1 = torch.stack([torch.cos(a1), torch.sin(a1)], -1)
        d2 = torch.stack([torch.cos(a2), torch.sin(a2)], -1)
        j1 = root + d1 * vec(l1 * scale)
        j2 = j1 + d2 * vec(l2 * scale)
        return [(root, j1, r * scale), (j1, j2, r * scale)]

    down = -math.pi / 2 + lean
    segs = [(pelvis, neck, torso_r), (head_c, head_c, head_r)]
    # arms hang from the shoulders with a wide spread
    sh_l = neck - rot(0.10 * scale, 0.0 * scale)
    sh_r = neck + rot(0.10 * scale, 0.0 * scale)
    segs += limb(6, sh_l, down - 0.5, 1.1, 0.26, 0.24, 0.048)
    segs += limb(8, sh_r, down + 0.5, 1.1, 0.26, 0.24, 0.048)
    hip_l = pelvis - rot(0.07 * scale, 0.0 * scale)
    hip_r = pelvis + rot(0.07 * scale, 0.0 * scale)
    segs += limb(10, hip_l, down - 0.12, 0.35, 0.30, 0.30, 0.062)
    segs += limb(12, hip_r, down + 0.12, 0.35, 0.30, 0.30, 0.062)
    a = torch.stack([sg[0] for sg in segs], -2)
    b = torch.stack([sg[1] for sg in segs], -2)
    r = torch.stack([sg[2] for sg in segs], -1)
    return a, b, r


def capsule_sdf(grid: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                r: torch.Tensor) -> torch.Tensor:
    """grid [S, S, 2] x capsules (a, b [..., K, 2], r [..., K]) -> the
    distance to the nearest capsule [..., S, S]."""
    p = grid[:, :, None, :] - a[..., None, None, :, :]      # [..., S,S,K,2]
    ab = (b - a)[..., None, None, :, :]
    denom = torch.clamp((ab * ab).sum(-1), min=1e-8)
    t = torch.clamp((p * ab).sum(-1) / denom, 0.0, 1.0)     # [..., S,S,K]
    d = _norm(p - t[..., None] * ab) - r[..., None, None, :]
    return d.amin(-1)


def texture_from_uniforms(u: torch.Tensor, grid: torch.Tensor,
                          contrast: float = 1.0) -> torch.Tensor:
    """[..., 15] uniforms -> a random low-frequency RGB field over grid
    [S, S, 2]: [..., S, S, 3] in [0, 1]."""
    one = lambda t: t[..., None, None, :]                     # [..., 1,1,3]
    base = one(_uniform(u[..., 0:3], 0.15, 0.85))
    freq = _uniform(u[..., 3:9], 0.5, 4.0)
    phase = one(_uniform(u[..., 9:12], 0.0, 6.28))
    amp = one(_uniform(u[..., 12:15], 0.05, 0.35))
    wave = torch.sin(2 * math.pi * (grid[..., :1] * one(freq[..., 0:3])
                                    + grid[..., 1:] * one(freq[..., 3:6]))
                     + phase)
    return torch.clamp(base + contrast * amp * wave, 0.0, 1.0)


def blob_mask(grid: torch.Tensor, centres: torch.Tensor,
              radii: torch.Tensor, size: int) -> torch.Tensor:
    """Soft mask [..., S, S] of the union of discs (centres [..., N, 2],
    radii [..., N]) with a ~2 pixel edge."""
    bd = _norm(grid[:, :, None] - centres[..., None, None, :, :]) \
        - radii[..., None, None, :]
    return torch.clamp(0.5 - bd.amin(-1) * (size / 4.0), 0.0, 1.0)


def composite_draws(gen: torch.Generator, batch: int, size: int) -> dict:
    """The random draws of ``batch`` composites, on the generator's
    device."""
    return {"skeleton": _rand(gen, batch, N_SKELETON),
            "fg": _rand(gen, batch, N_TEXTURE),
            "bg": _rand(gen, batch, N_TEXTURE),
            "noise": _randn(gen, batch, size, size, 3),
            "blob_c": _rand(gen, batch, 3, 2),
            "blob_r": _rand(gen, batch, 3),
            "blob_tex": _rand(gen, batch, N_TEXTURE),
            "keep": _rand(gen, batch)}


def composite_from_draws(d: dict, size: int):
    """-> (images [B, S, S, 3] in [0, 1], alpha [B, S, S] in [0, 1])."""
    grid = pixel_grid(size, d["keep"].device)
    dist = capsule_sdf(grid, *skeleton_from_uniforms(d["skeleton"]))
    alpha = torch.clamp(0.5 - dist * (size / 4.0), 0.0, 1.0)   # ~2 px edge
    # ~15% person-free frames
    alpha = alpha * (d["keep"] < KEEP_P).to(alpha.dtype)[:, None, None]
    fg = texture_from_uniforms(d["fg"], grid)
    # the shading of a rounded body: darker towards the silhouette's edge
    shade = 0.7 + 0.3 * torch.clamp(-dist * 6.0, 0.0, 1.0)
    bg = texture_from_uniforms(d["bg"], grid, contrast=1.4)
    # non-humanoid distractor blobs: the net must key on the articulated
    # silhouette, not on any coherent textured region
    blob_m = blob_mask(grid, _uniform(d["blob_c"], -0.9, 0.9),
                       _uniform(d["blob_r"], 0.08, 0.3), size)[..., None]
    bg = bg * (1 - blob_m) \
        + texture_from_uniforms(d["blob_tex"], grid)[..., :3] * blob_m
    img = alpha[..., None] * fg * shade[..., None] \
        + (1.0 - alpha[..., None]) * bg
    img = img + d["noise"] * 0.02
    return torch.clamp(img, 0.0, 1.0), alpha


def synth_batch(gen: torch.Generator, batch: int, size: int):
    """[B, S, S, 3] images in [0, 1] + [B, S, S] alpha mattes, made on the
    generator's device."""
    return composite_from_draws(composite_draws(gen, batch, size), size)


def synth_composite(gen: torch.Generator, size: int):
    """One composite: (image [S, S, 3], alpha [S, S])."""
    images, alpha = synth_batch(gen, 1, size)
    return images[0], alpha[0]


# -- training ----------------------------------------------------------------
def make_train_fns(net: MatteNet, size: int, batch: int,
                   learning_rate: float = 1e-3):
    """-> (init_fn(generator) -> state, run_fn(state, generator, n_steps)
    -> (state, mean loss)).

    ``init_fn`` draws flax-distributed weights into ``net`` from a CPU
    generator (``init_params``) and returns a state over it with optax's
    Adam. ``run_fn`` runs ``n_steps`` steps, a fresh batch a step drawn
    from ``generator`` on the net's device; the mean loss is a device
    tensor (one host read a chunk is the caller's)."""
    tx = make_optimizer("adam", learning_rate)

    def init_fn(generator: torch.Generator) -> TrainState:
        init_params(net, generator)
        return create_train_state(net, tx)

    def run_fn(state: TrainState, generator: torch.Generator, n_steps: int):
        losses = [loss_step(state, matting_loss,
                            *synth_batch(generator, batch, size))
                  for _ in range(n_steps)]
        return state, torch.stack(losses).mean()

    return init_fn, run_fn


def alpha_iou(pred: torch.Tensor, gt: torch.Tensor,
              thresh: float = 0.5) -> torch.Tensor:
    """Mean IOU of thresholded mattes over the batch. A person-free frame
    (empty gt) scores 1 when the prediction is also near-empty (< 1% of
    its area): a correct rejection, not a vacuous 0/0."""
    p = pred > thresh
    g = gt > thresh
    inter = (p & g).sum(dim=(1, 2))
    union = (p | g).sum(dim=(1, 2))
    iou = inter.float() / torch.clamp(union, min=1).float()
    empty_ok = (g.sum(dim=(1, 2)) == 0) & (p.float().mean(dim=(1, 2)) < 0.01)
    return torch.where(empty_ok, 1.0, iou).mean()


# -- checkpoints (the JAX package's npz: f16, '__width__') -------------------
def save_params(path: str, net: MatteNet, width: int) -> None:
    """MatteNet's parameters as the JAX app saves them: the flax variables
    (keys under ``params/``), f16, with the width."""
    params = flax_params_from_torch(net.state_dict())["params"]
    _save_params(path, {"params": params}, meta={"width": width})


def load_params(path: str):
    """-> (flax variables of f32 numpy arrays, width) from ``save_params``
    output (``weights.load_module`` takes the variables)."""
    params, meta = _load_params(path)
    return params, meta["width"]

"""DetectNet training: synthetic multi-person scenes made on the device and
the CenterNet-style loss (port of ``monoport_tpu/training/detection.py``).

A scene: up to ``MAX_PEOPLE`` articulated capsule humans
(``training/matting.py``'s skeleton; slot presence 90 / 50 / 35 / 25%) at
independent scales (0.25-1.1) and positions across the frame, so they
overlap and occlude, over a textured background with round blobs and two
single-capsule distractors (person-ish, not labelled). Ground truth is one
xyxy pixel box and a validity flag a slot: static shapes.

As in ``training/matting.py``, each generator is a draw on a
``torch.Generator`` (``scene_draws``) and a builder from the draws
(``scene_from_draws``), which the tests feed the JAX package's draws.

Loss (``detection_loss``): the penalty-reduced focal loss on a Gaussian
centre heatmap, plus L1 on the log box size and on the sub-cell offset at
the ground-truth centre cells.
"""

from __future__ import annotations

import torch

from ..ops.constants import device_constant, float_array
from ..parallel.train_step import (Optimizer, ScaleByAdam,
                                   ScaleByLearningRate, TrainState,
                                   cosine_decay_schedule, create_train_state,
                                   init_params, loss_step)
from ..pipeline.detection import DetectNet, gaussian_heatmap
from .datasets.capsule import _rand, _randn, _uniform
from .matting import (N_SKELETON, N_TEXTURE, blob_mask, capsule_sdf,
                      pixel_grid, skeleton_from_uniforms,
                      texture_from_uniforms)

MAX_PEOPLE = 4
PRESENT_P = (0.9, 0.5, 0.35, 0.25)   # each slot's presence probability
HEAT_BIAS = -2.19                     # the heat head's initial bias


def _person_alphas(d: dict, grid: torch.Tensor, size: int) -> torch.Tensor:
    """Each slot's randomly placed and scaled person -> alpha [B, P, S, S]
    (before its presence draw)."""
    a, b, r = skeleton_from_uniforms(d["skeleton"])          # [B,P,11,2]
    s = _uniform(d["scale"], 0.25, 1.1)[..., None, None]
    t = torch.stack([_uniform(d["shift"][..., 0], -0.65, 0.65),
                     _uniform(d["shift"][..., 1], -0.35, 0.35)], -1)
    t = t[..., None, :]
    dist = capsule_sdf(grid, a * s + t, b * s + t, r * s[..., 0])
    return torch.clamp(0.5 - dist * (size / 4.0), 0.0, 1.0)


def _alpha_bbox(alpha: torch.Tensor, thresh: float = 0.5):
    """[..., S, S] alpha -> xyxy box in pixels [..., 4] (0s when empty) and
    a found flag [...]."""
    s_y, s_x = alpha.shape[-2:]
    mask = alpha > thresh
    any_row = mask.any(dim=-1)
    any_col = mask.any(dim=-2)
    rows = torch.arange(s_y, device=alpha.device)
    cols = torch.arange(s_x, device=alpha.device)
    big = torch.iinfo(torch.int32).max
    y1 = torch.where(any_row, rows, big).amin(-1)
    y2 = torch.where(any_row, rows, -1).amax(-1)
    x1 = torch.where(any_col, cols, big).amin(-1)
    x2 = torch.where(any_col, cols, -1).amax(-1)
    found = any_row.any(dim=-1)
    box = torch.stack([x1, y1, x2, y2], -1).float()
    return torch.where(found[..., None], box, 0.0), found


def scene_draws(gen: torch.Generator, batch: int, size: int) -> dict:
    """The random draws of ``batch`` scenes, on the generator's device."""
    p = MAX_PEOPLE
    return {"bg": _rand(gen, batch, N_TEXTURE),
            "blob_c": _rand(gen, batch, 5, 2),
            "blob_r": _rand(gen, batch, 5),
            "blob_tex": _rand(gen, batch, N_TEXTURE),
            "dist_a": _rand(gen, batch, 2, 2),
            "dist_d": _rand(gen, batch, 2, 2),
            "dist_r": _rand(gen, batch, 2),
            "dist_tex": _rand(gen, batch, N_TEXTURE),
            "skeleton": _rand(gen, batch, p, N_SKELETON),
            "scale": _rand(gen, batch, p),
            "shift": _rand(gen, batch, p, 2),
            "keep": _rand(gen, batch, p),
            "person_tex": _rand(gen, batch, p, N_TEXTURE),
            "noise": _randn(gen, batch, size, size, 3)}


def scene_from_draws(d: dict, size: int):
    """-> (images [B, S, S, 3] in [0, 1], boxes [B, MAX_PEOPLE, 4] xyxy
    pixels, valid [B, MAX_PEOPLE] bool)."""
    dev = d["keep"].device
    grid = pixel_grid(size, dev)
    bg = texture_from_uniforms(d["bg"], grid, contrast=1.4)
    blob_m = blob_mask(grid, _uniform(d["blob_c"], -0.9, 0.9),
                       _uniform(d["blob_r"], 0.06, 0.3), size)[..., None]
    bg = bg * (1 - blob_m) \
        + texture_from_uniforms(d["blob_tex"], grid)[..., :3] * blob_m
    # capsule distractors: elongated, person-ish, textured, not labelled
    da = _uniform(d["dist_a"], -0.8, 0.8)
    db = da + _uniform(d["dist_d"], -0.5, 0.5)
    dd = capsule_sdf(grid, da, db, _uniform(d["dist_r"], 0.04, 0.12))
    dist_m = torch.clamp(0.5 - dd * (size / 4.0), 0.0, 1.0)[..., None]
    bg = bg * (1 - dist_m) \
        + texture_from_uniforms(d["dist_tex"], grid)[..., :3] * dist_m

    present = d["keep"] < device_constant(float_array, (PRESENT_P,), dev,
                                          torch.float32)
    alphas = _person_alphas(d, grid, size) \
        * present.to(torch.float32)[..., None, None]
    fg = texture_from_uniforms(d["person_tex"], grid)     # [B,P,S,S,3]
    img = bg
    for i in range(MAX_PEOPLE):                          # later slots on top
        alpha = alphas[:, i, ..., None]
        d_shade = 1.0 - alpha          # a cheap edge-darkening stand-in
        img = alpha * fg[:, i] * (0.7 + 0.3 * (1 - d_shade)) \
            + (1.0 - alpha) * img
    boxes, found = _alpha_bbox(alphas)
    img = img + d["noise"] * 0.02
    return torch.clamp(img, 0.0, 1.0), boxes, present & found


def synth_det_batch(gen: torch.Generator, batch: int, size: int):
    """-> images [B, S, S, 3], boxes [B, K, 4], valid [B, K], made on the
    generator's device."""
    return scene_from_draws(scene_draws(gen, batch, size), size)


def synth_scene(gen: torch.Generator, size: int):
    """One scene: (image [S, S, 3], boxes [K, 4], valid [K])."""
    images, boxes, valid = synth_det_batch(gen, 1, size)
    return images[0], boxes[0], valid[0]


# -- loss ---------------------------------------------------------------------
def detection_loss(net: DetectNet, images: torch.Tensor,
                   gt_boxes: torch.Tensor,
                   gt_valid: torch.Tensor) -> torch.Tensor:
    """Focal heatmap + L1 size / offset loss (the CenterNet recipe).
    gt_boxes [B, K, 4] xyxy pixels, gt_valid [B, K] bool."""
    heat, size_p, off_p = net(images * 2.0 - 1.0)
    b, g = heat.shape[:2]
    stride = images.shape[1] // g

    cx = (gt_boxes[..., 0] + gt_boxes[..., 2]) / 2.0 / stride    # [B,K]
    cy = (gt_boxes[..., 1] + gt_boxes[..., 3]) / 2.0 / stride
    w = (gt_boxes[..., 2] - gt_boxes[..., 0]) / stride
    h = (gt_boxes[..., 3] - gt_boxes[..., 1]) / stride

    gt_heat = gaussian_heatmap(cx, cy, w, h, gt_valid, g)         # [B,G,G]
    p = torch.clamp(torch.sigmoid(heat[..., 0]), 1e-5, 1.0 - 1e-5)
    pos = (gt_heat >= 0.999).to(p.dtype)
    focal = -(pos * (1 - p) ** 2 * torch.log(p)
              + (1 - pos) * (1 - gt_heat) ** 4 * p ** 2 * torch.log(1 - p))
    n_pos = torch.clamp(pos.sum(), min=1.0)
    loss_heat = focal.sum() / n_pos

    # the centre cell: truncated toward zero (as astype), then clipped
    ix = torch.clamp(cx.to(torch.int32), 0, g - 1).long()        # [B,K]
    iy = torch.clamp(cy.to(torch.int32), 0, g - 1).long()
    bi = torch.arange(b, device=images.device)[:, None]
    sz_at = size_p[bi, iy, ix]                                    # [B,K,2]
    off_at = off_p[bi, iy, ix]
    v = gt_valid.to(p.dtype)[..., None]
    # log-extent targets (decode exponentiates): a 0.25x instance trains
    # as strongly as a large one
    gt_sz = torch.log(torch.clamp(torch.stack([w, h], -1), min=0.25))
    l1_sz = (torch.abs(sz_at - gt_sz) * v).sum() / n_pos
    gt_off = torch.stack([cx - (ix + 0.5), cy - (iy + 0.5)], -1)
    l1_off = (torch.abs(off_at - gt_off) * v).sum() / n_pos
    return loss_heat + 0.5 * l1_sz + l1_off


# -- train loop ---------------------------------------------------------------
@torch.no_grad()
def init_detectnet(net: DetectNet, generator: torch.Generator) -> DetectNet:
    """flax-distributed initial weights (``init_params``), the heat head's
    bias at ``HEAT_BIAS`` (a prior of ~0.1 a cell), as the JAX module
    initialises it."""
    init_params(net, generator)
    net.Conv_0.bias.fill_(HEAT_BIAS)
    return net


def make_train_fns(net: DetectNet, size: int, batch: int,
                   learning_rate: float = 1e-3, total_steps: int = 0):
    """-> (init_fn(generator) -> state, run_fn(state, generator, n_steps)
    -> (state, mean loss)), as ``training/matting.make_train_fns``.
    ``total_steps`` > 0 adds a cosine decay to 5% of the peak rate; its
    count is the state's step, so run_fns of several sizes can share one
    state and one schedule."""
    lr = (cosine_decay_schedule(learning_rate, total_steps, alpha=0.05)
          if total_steps else learning_rate)
    tx = Optimizer(ScaleByAdam(), ScaleByLearningRate(lr))

    def init_fn(generator: torch.Generator) -> TrainState:
        init_detectnet(net, generator)
        return create_train_state(net, tx)

    def run_fn(state: TrainState, generator: torch.Generator, n_steps: int):
        losses = [loss_step(state, detection_loss,
                            *synth_det_batch(generator, batch, size))
                  for _ in range(n_steps)]
        return state, torch.stack(losses).mean()

    return init_fn, run_fn


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """xyxy box IOU, elementwise over leading dims."""
    x1 = torch.maximum(a[..., 0], b[..., 0])
    y1 = torch.maximum(a[..., 1], b[..., 1])
    x2 = torch.minimum(a[..., 2], b[..., 2])
    y2 = torch.minimum(a[..., 3], b[..., 3])
    inter = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)

    def area(z):
        return torch.clamp(z[..., 2] - z[..., 0], min=0) \
            * torch.clamp(z[..., 3] - z[..., 1], min=0)

    return inter / torch.clamp(area(a) + area(b) - inter, min=1e-6)

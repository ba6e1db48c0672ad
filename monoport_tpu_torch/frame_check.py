"""The operating points and the full-width golden frames.

``rtl_config`` builds the frontal real-time operating point of
``configs/rtl.yaml`` in code (the card machine has no PyYAML):
``mode='ray'``, ``fine_res`` 257, 6 taps, a 192^2 window, march levels
(33, 65), bf16 compute by default. ``quality_config`` builds the exact
full-volume profile of ``configs/quality.yaml``: ``mode='dense'``, the
hierarchy (17, 33, 65, 129, 257) with budgets (0, 16384, 65536, 131072,
262144).

``data/frame_golden.npz`` holds the JAX engine's f32 frame at that point
on the committed weights, for the held-out capsule render of
``tests/test_trained_pipeline.py``; ``data/frame_golden_rotated.npz`` the
same image seen by the orbit camera at ``ROTATED_POSE`` (``rotated_calib``),
the rotated defaults of ``RotatedCfg`` / ``TextureCfg``, with the anchor
plan and ``compact_dropped`` of that frame; ``data/frame_golden_dense.npz``
the frontal frame of ``quality_config`` with its ``recon_counts`` and its
257^3 volume ``sdf`` at every ``SDF_STRIDE``-th voxel (65^3), without the
image, which is the frontal golden's (all written by
``python tests/test_torch_frame_golden.py --write``). ``data/serve_golden.npz``
holds the JAX demo app's f32 stages on one raw capsule frame (``python
tests/test_torch_app.py --write``); ``compare_display`` holds a served
frame's packed display to it. ``data/backbone_golden.npz`` holds the JAX
package's f32 outputs of the alternative netG backbones (HRNet and Yolov4
with BatchNorm, on seeded weights; ``python tests/test_torch_backbones.py
--write``) for the frontal golden's image, every ``BACKBONE_STRIDE``-th
pixel in f16; ``compare_backbone`` holds a port backbone's output to it.
``data/train_golden.npz`` holds one full-width train step of the JAX
package on the committed nets (``python tests/test_torch_training.py
--write``): the batches, the loss, each gradient leaf's L2 norm and its dot
product with ``projection_vector``, and three steps' losses;
``grad_summary`` gives the same numbers for the port's gradients.
``compare_to_golden`` holds a port frame to a golden with fractions, not a
max error: the 4-stack backbone sums in another order on each device, and
a crossing near a knife-edge amplifies that.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from .config import get_cfg_defaults
from .engine import EngineCfg, RayCfg
from .recon.calib import pifu_calib
from .recon.hierarchy import HierarchicalRecon
from .render.camera import orbit_extrinsic

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "frame_golden.npz")
GOLDEN_ROTATED = os.path.join(os.path.dirname(__file__), "data",
                              "frame_golden_rotated.npz")
GOLDEN_DENSE = os.path.join(os.path.dirname(__file__), "data",
                            "frame_golden_dense.npz")
GOLDEN_SERVE = os.path.join(os.path.dirname(__file__), "data",
                            "serve_golden.npz")
GOLDEN_BACKBONE = os.path.join(os.path.dirname(__file__), "data",
                               "backbone_golden.npz")
GOLDEN_TRAIN = os.path.join(os.path.dirname(__file__), "data",
                            "train_golden.npz")
GOLDEN_SOFTONEHOT = os.path.join(os.path.dirname(__file__), "data",
                                 "frame_golden_softonehot.npz")
GOLDEN_PERCEPTION_TRAIN = os.path.join(os.path.dirname(__file__), "data",
                                       "perception_train_golden.npz")
BACKBONE_STRIDE = 4                  # the backbone golden's pixel subsampling
ROTATED_POSE = (20.0, 10.0)          # orbit yaw, pitch in degrees
SDF_STRIDE = 4                       # the dense golden's volume subsampling
QUALITY_RESOLUTIONS = (17, 33, 65, 129, 257)
QUALITY_BUDGETS = (0, 16384, 65536, 131072, 262144)


class Limits(NamedTuple):
    """Agreement a frame must reach with the golden. Fractions are taken
    over the subject, not the canvas: ``valid`` disagreement over the
    union of the two silhouettes (so 1 - IOU), depth over pixels valid in
    both, each render over pixels that are subject (not white background)
    in either frame."""
    valid_disagree_max: float   # of the silhouettes' union
    depth_atol: float           # fine voxels
    norm_atol: float            # render_norm, display units (max over RGB)
    tex_atol: float             # render_tex, display units (max over RGB)
    within_min: float           # fraction of the pixels that must be within


# the f32 frame: the JAX engine's own math, summed in another order
F32_LIMITS = Limits(0.005, 2e-3, 2e-3, 2e-3, 0.995)
# the bf16 frame against the f32 golden: about twice the 99.5th-percentile
# errors measured on an H100 (depth 0.283 fine voxels, render_norm 0.0254,
# render_tex 8.5e-4; 1 - IOU 0.097%, held to 1%)
BF16_LIMITS = Limits(0.01, 0.6, 0.05, 2e-3, 0.995)
# the bf16 rotated frame against its f32 golden, set the same way (measured
# on an H100: depth 0.290 fine voxels, render_norm 0.0309, render_tex
# 8.1e-4; 1 - IOU 0.22%, held to 1%)
BF16_ROTATED_LIMITS = Limits(0.01, 0.6, 0.06, 2e-3, 0.995)
# the bf16 dense frame (the depth-peeled 257^3 hierarchy) against its f32
# golden, set the same way. A peeled depth interpolates two voxels, so it
# is coarser than a ray frame's (measured on an H100: depth 1.088 voxels,
# render_norm 0.0599, render_tex 1.13e-3; 1 - IOU 0.12%, held to 1%)
BF16_DENSE_LIMITS = Limits(0.01, 2.0, 0.12, 2.5e-3, 0.995)


# the f32 served frame against the serve golden: its input is the port's
# own matte, 1.5e-4 from the JAX app's on the CPU, which moves the depth by
# up to 3.9e-3 fine voxels (p99.5 2.4e-3, 98.6% within 2e-3); the renders
# and the silhouette as F32_LIMITS
F32_SERVE_LIMITS = F32_LIMITS._replace(depth_atol=5e-3)
# the seeded soft-onehot netG's f32 frame (``soft_netg_state`` of
# tests/torch_reference_state.py) against its golden: its silhouette is
# where a random feature term f passes a threshold, and near it the depth
# moves with f; the port's f32 features on the CPU, 8e-5 of their largest
# value from JAX's f64 (JAX's f32 ones 2e-5), put 1.0% of the pixels past
# 2e-3 fine voxels (p99.5 3.6e-3, p99.9 1.2e-2): depth held at 1e-2, the
# rest as F32_LIMITS (measured on the CPU: renders within 7.3e-3 on
# 99.8%, the silhouettes equal)
F32_SOFT_LIMITS = F32_LIMITS._replace(depth_atol=1e-2)


def rtl_config(compute_dtype: torch.dtype = torch.bfloat16):
    """(HierarchicalRecon, EngineCfg) of the real-time operating point."""
    c = get_cfg_defaults()
    recon = HierarchicalRecon(resolutions=(17, 33, 65),
                              budgets=(0, 4096, 16384),
                              boundary_tau=c.recon.boundary_tau,
                              dilate=c.recon.dilate,
                              balance_value=c.recon.balance_value,
                              select="uncertain")
    cfg = EngineCfg(compute_dtype=compute_dtype,
                    ray=RayCfg(mode="ray", fine_res=257, taps=6, window=192,
                               march_levels=tuple(c.recon.march_levels)))
    return recon, cfg


def quality_config(compute_dtype: torch.dtype = torch.float32):
    """(HierarchicalRecon, EngineCfg) of the exact full-volume profile."""
    c = get_cfg_defaults()
    recon = HierarchicalRecon(resolutions=QUALITY_RESOLUTIONS,
                              budgets=QUALITY_BUDGETS,
                              boundary_tau=c.recon.boundary_tau,
                              dilate=c.recon.dilate,
                              balance_value=c.recon.balance_value,
                              select="uncertain")
    return recon, EngineCfg(compute_dtype=compute_dtype,
                            ray=RayCfg(mode="dense"))


def rotated_calib(yaw_deg: float = ROTATED_POSE[0],
                  pitch_deg: float = ROTATED_POSE[1]) -> np.ndarray:
    """[1, 4, 4] calib of the orbit camera at (yaw, pitch) over an identity
    intrinsic: the free-viewpoint pose of the rotated golden."""
    return pifu_calib(orbit_extrinsic(yaw_deg, pitch_deg), np.eye(4))


def load_golden(path: str = GOLDEN) -> dict:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _subject(render: np.ndarray) -> np.ndarray:
    """Pixels of a render that are not white background (``visualize``)."""
    return ~(render >= 1.0).all(axis=-1)


def compare_to_golden(out: dict, golden: dict,
                      limits: Limits = F32_LIMITS) -> dict:
    """Agreement of a frame's outputs with the golden; ``ok`` is the
    verdict against ``limits``, the rest are the measured fractions, the
    99.5th-percentile and the largest errors."""
    get = lambda k: out[k].detach().float().cpu().numpy()
    valid = out["valid"].detach().cpu().numpy()
    gv = golden["valid"]
    union = max(int((valid | gv).sum()), 1)
    depth_err = np.abs(get("depth") - golden["depth"])[valid & gv]
    res = {"valid_disagree": float((valid != gv).sum() / union),
           "valid_fraction": float(gv.mean())}
    errs = {"depth": (depth_err, limits.depth_atol)}
    for key, atol in (("render_norm", limits.norm_atol),
                      ("render_tex", limits.tex_atol)):
        if key not in out:                   # a frame without netC
            continue
        img = get(key)
        subject = _subject(img) | _subject(golden[key])
        errs[key] = (np.abs(img - golden[key]).max(axis=-1)[subject], atol)
    for key, (err, atol) in errs.items():
        if not err.size:
            err = np.zeros(1)
        res[f"{key}_within"] = float((err <= atol).mean())
        res[f"{key}_p995_err"] = float(np.quantile(err, 0.995))
        res[f"{key}_max_err"] = float(err.max())
    res["ok"] = bool(res["valid_disagree"] < limits.valid_disagree_max
                     and all(res[f"{k}_within"] >= limits.within_min
                             for k in errs)
                     and all(np.isfinite(get(k)).all() for k in errs))
    return res


def compare_display(d: dict, golden: dict,
                    limits: Limits = F32_LIMITS) -> dict:
    """A served frame (the demo pipeline's output: ``display_host``, the
    fetched [S, S, 8] uint8 packed display, and the frame's ``depth`` /
    ``valid``) against the serve golden's, by ``compare_to_golden`` with the
    render tolerances widened by one uint8 step (two renders within 1e-5
    may truncate to neighbouring levels)."""
    def maps(packed, depth, valid):
        planes = torch.from_numpy(np.asarray(packed, np.float32) / 255.0)
        return {"valid": torch.as_tensor(valid), "depth": torch.as_tensor(
            depth), "render_norm": planes[..., 0:3],
            "render_tex": planes[..., 3:6]}
    out = maps(d["display_host"], d["depth"], d["valid"])
    ref = {k: v.numpy() for k, v in maps(
        golden["display_packed"], golden["depth"], golden["valid"]).items()}
    step = 1.0 / 255.0
    return compare_to_golden(out, ref, limits._replace(
        norm_atol=limits.norm_atol + step, tex_atol=limits.tex_atol + step))


def compare_sdf(out: dict, golden: dict, atol: float = 2e-3,
                within_min: float = F32_LIMITS.within_min) -> dict:
    """Agreement of a dense frame's volume with the golden's subsampled
    one: occupancy within ``atol`` on at least ``within_min`` of the
    voxels (a voxel whose band membership flips holds the interpolated
    value in one frame and the queried one in the other)."""
    k = SDF_STRIDE
    err = np.abs(out["sdf"][::k, ::k, ::k].detach().float().cpu().numpy()
                 - golden["sdf"])
    res = {"sdf_within": float((err <= atol).mean()),
           "sdf_p995_err": float(np.quantile(err, 0.995)),
           "sdf_max_err": float(err.max())}
    res["ok"] = bool(res["sdf_within"] >= within_min
                     and np.isfinite(err).all())
    return res


# the f32 backbone against its golden: the largest error of a level over
# the level's largest magnitude, about twice what an H100 measures (up to
# 4.27e-4; the golden's f16 rounding alone is up to 2^-11 of it)
BACKBONE_LIMIT = 1e-3


def backbone_levels(stages) -> dict:
    """A backbone's [[B, h, w, C] level, ...] stages (torch or numpy) ->
    {'s<stage>_l<level>': the first image's [h, w, C] f32 numpy array}."""
    return {f"s{i}_l{j}": (y.detach().float().cpu().numpy()
                           if isinstance(y, torch.Tensor)
                           else np.asarray(y, np.float32))[0]
            for i, ys in enumerate(stages) for j, y in enumerate(ys)}


def subsample(level: np.ndarray) -> np.ndarray:
    """A level as the backbone golden stores it."""
    return level[::BACKBONE_STRIDE, ::BACKBONE_STRIDE].astype(np.float16)


def compare_backbone(levels: dict, golden: dict, imf: str,
                     limit: float = BACKBONE_LIMIT) -> dict:
    """``backbone_levels`` of a port backbone against the golden's levels
    of ``imf``: each level's shape and its largest error over its largest
    magnitude, held to ``limit``."""
    res, ok = {}, True
    names = sorted(k.split("/", 1)[1] for k in golden
                   if k.startswith(imf + "/"))
    if names != sorted(levels):
        return {"ok": False, "levels": sorted(levels), "golden": names}
    for name in names:
        want = golden[f"{imf}/{name}"].astype(np.float32)
        got = levels[name][::BACKBONE_STRIDE, ::BACKBONE_STRIDE]
        if got.shape != want.shape:
            return {"ok": False, name: [got.shape, want.shape]}
        scale = float(np.abs(want).max())
        rel = float(np.abs(got - want).max()) / scale
        res[name] = {"shape": list(levels[name].shape), "max_abs": scale,
                     "max_err_rel": rel}
        ok = ok and np.isfinite(got).all() and rel <= limit
    return {"ok": bool(ok), "limit": limit, "levels": res}


def projection_vector(name: str, shape) -> np.ndarray:
    """The seeded vector a gradient leaf (flax name and layout) is
    projected on in the train golden."""
    seed = sum(name.encode()) % (2 ** 31)
    return np.random.RandomState(seed).standard_normal(shape)


def grad_summary(grads: dict, prefix: str = "") -> dict:
    """A gradient tree in the flax layout (nested dicts) -> each leaf's L2
    norm and its dot product with ``projection_vector``, by its
    '/'-joined name (f64)."""
    out = {}
    for key, leaf in grads.items():
        name = f"{prefix}{key}"
        if isinstance(leaf, dict):
            out.update(grad_summary(leaf, name + "/"))
            continue
        leaf = np.asarray(leaf, np.float64)
        out[name] = (float(np.linalg.norm(leaf)), float(
            (leaf * projection_vector(name, leaf.shape)).sum()))
    return out

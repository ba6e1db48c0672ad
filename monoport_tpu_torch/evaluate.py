"""Reconstruction quality against the ground truth (the evaluation layer
of the JAX package's ``scripts/eval_netg.py``, ``eval_netc.py``,
``eval_crossfam.py``, ``eval_rotated_anchored.py`` and of the quality
section of ``bench.py``'s ``bench_real``).

Plain functions on tensors with an explicit device, shared by the
evaluation apps (``apps/eval_*``) and ``chip_smoke.py``'s quality phase:

* ``gt_silhouette``: the analytic silhouette of an occupancy function on
  the fine ray lattice, the union of ``n_z`` z-slices; with a calib, on
  the view-space lattice of a rotated frame (each lattice point's
  occupancy at its calib image);
* ``silhouette_iou``: a frame's ``valid`` against it;
* ``texture_psnr``: netC's ``render_tex`` against the renderer's shading
  model painted at the reconstructed surface (``gt_texture_canvas``,
  ``visualize``), over the frame's mask;
* ``ray_vs_dense``: path exactness, the frame's maps against netG's own
  dense 257^3 volume, queried through the engine's per-point head (kernel
  2) and depth-peeled;
* ``bench_quality``: ``bench_real``'s four quality keys at the bench
  profile (``frame_check.rtl_config``);
* ``rotated_anchored``: the anchored rotated refine against the exact
  per-point path at the orbit poses.

Bodies. The port cannot draw the JAX package's held-out bodies
(``skeleton3d(PRNGKey(seed))``, ``sq_body(PRNGKey(seed))``) without JAX,
so ``data/eval_golden.npz`` commits them, with the PPL fixture's
silhouette (PIL draws it; the card has no PIL) and the JAX package's f32
readings of the same evaluations (``GOLDEN_WRITER``). A seed the file
lacks raises; no other body is drawn under its number.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from . import frame_check
from .engine import EngineCfg, ReconEngine
from .recon.calib import pifu_calib
from .recon.depth_peel import depth_peel, visualize
from .recon.hierarchy import HierarchicalRecon
from .render.camera import orbit_extrinsic
from .training.datasets import superquadric as sq
from .training.datasets.capsule import capsule_occupancy, gt_texture_canvas
from .training.datasets.fixture import RADII
from .training.metrics import masked_psnr

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "eval_golden.npz")
GOLDEN_WRITER = "python tests/test_torch_eval.py --write"
HELD_OUT_SEEDS = (31337, 4242, 777)   # bench body, test body, extra
BENCH_SEED = 31337
# the fixture's flat fill colour (``fixture._render_rgba``)
FIXTURE_RGB = (90, 140, 200)
# the dense oracle of ``ray_vs_dense`` (``bench.py:742``): default budgets
DENSE_RESOLUTIONS = (17, 33, 65, 129, 257)
# eval_rotated_anchored's orbit poses (yaw, pitch) and modes
POSES = ((10.0, 0.0), (20.0, 10.0), (35.0, 10.0), (60.0, 15.0))
ROTATED_MODES = (None, "auto", 3)
BENCH_KEYS = ("real_model_vs_gt_iou", "real_ray_vs_dense_iou",
              "real_depth_err_med_voxels", "real_tex_psnr_db")


# -- the committed bodies ---------------------------------------------------
def load_golden(path: str = GOLDEN) -> dict:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _arrays(golden: dict, prefix: str, names, seed: int, device) -> dict:
    missing = [n for n in names if f"{prefix}/{seed}/{n}" not in golden]
    if missing:
        raise KeyError(
            f"{os.path.basename(GOLDEN)} holds no {prefix} body for seed "
            f"{seed}: the port cannot draw the JAX package's body; write it "
            f"with `{GOLDEN_WRITER}` (HELD_OUT_SEEDS)")
    return {n: torch.as_tensor(golden[f"{prefix}/{seed}/{n}"],
                               device=device) for n in names}


def capsule_body(seed: int, device, golden: Optional[dict] = None) -> tuple:
    """The JAX package's ``skeleton3d(PRNGKey(seed))``: (a, b, r)."""
    arr = _arrays(golden or load_golden(), "capsule", ("a", "b", "r"), seed,
                  device)
    return arr["a"], arr["b"], arr["r"]


def sq_body(seed: int, device, golden: Optional[dict] = None) -> dict:
    """The JAX package's ``superquadric.sq_body(PRNGKey(seed))``."""
    return _arrays(golden or load_golden(), "sq",
                   ("a", "b", "r", "e1", "e2", "aniso", "elong"), seed,
                   device)


def fixture_image(device, golden: Optional[dict] = None) -> torch.Tensor:
    """The PPL fixture's frontal render in the netG input contract (rgb *
    2 - 1, background zeroed), [512, 512, 3], from its committed
    silhouette."""
    mask = (golden or load_golden())["fixture/mask"]
    rgb = np.asarray(FIXTURE_RGB, np.float32) / np.float32(255.0)
    image = (rgb * 2.0 - 1.0) * mask[..., None]
    return torch.as_tensor(image.astype(np.float32), device=device)


def ellipsoid_occupancy(pts: torch.Tensor) -> torch.Tensor:
    """The fixture's analytic ellipsoid: 1 inside, 0 outside."""
    radii = torch.tensor(RADII, dtype=torch.float32, device=pts.device)
    return ((pts / radii) ** 2).sum(-1).le(1.0).float()


def capsule_occ(caps) -> Callable:
    return lambda pts: capsule_occupancy(pts, caps)


def sq_occ(body: dict) -> Callable:
    return lambda pts: sq.sq_occupancy(pts, body)


# -- metrics ----------------------------------------------------------------
def gt_silhouette(occ_fn: Callable, res: int, n_z: int = 64, calib=None,
                  device=None) -> torch.Tensor:
    """[res, res] bool: the union over ``n_z`` z-slices in [-1, 1] of
    ``occ_fn(points) > 0.5`` on the [-1, 1]^2 lattice (x first), on
    ``device``. With a host [1, 4, 4] ``calib`` the lattice is the view
    space of a rotated frame and each point is taken to its calib image
    first (eval_rotated_anchored's ``gt_silhouette_view``; that product is
    the JAX script's numpy f32 one)."""
    sil = torch.zeros((res, res), dtype=torch.bool, device=device)
    if calib is None:
        ax = torch.linspace(-1.0, 1.0, res, device=device)
        gx, gy = torch.meshgrid(ax, ax, indexing="ij")
        for z in torch.linspace(-1.0, 1.0, n_z).tolist():
            sil |= occ_fn(torch.stack([gx, gy, torch.full_like(gx, z)],
                                      -1)) > 0.5
        return sil
    c = np.asarray(calib, np.float32).reshape(-1, 4, 4)[0]
    ax = np.linspace(-1, 1, res, dtype=np.float32)
    gx, gy = np.meshgrid(ax, ax, indexing="ij")
    for z in np.linspace(-1, 1, n_z, dtype=np.float32):
        p = np.stack([gx, gy, np.full_like(gx, z), np.ones_like(gx)],
                     -1).reshape(-1, 4)
        world = (p @ c.T)[:, :3].reshape(res, res, 3)
        sil |= occ_fn(torch.as_tensor(world, device=device)) > 0.5
    return sil


def silhouette_iou(valid: torch.Tensor, gt: torch.Tensor) -> float:
    """IOU of two [R, R] silhouettes (an empty union reads 0)."""
    got, gt = valid.bool(), gt.to(valid.device).bool()
    return float((got & gt).sum()) / max(int((got | gt).sum()), 1)


def texture_psnr(out: dict, engine: ReconEngine, res: int,
                 flat: bool = False, appearance=None) -> tuple[float, float]:
    """(PSNR dB, mean |err|) of a frame's ``render_tex`` against the GT
    texture canvas at its reconstructed surface (``bench.py:780-793``)."""
    canvas = gt_texture_canvas(out["depth"].float(), out["valid"], res,
                               flat=flat, appearance=appearance)
    gt_vis, _ = visualize(canvas, engine.render_size)
    mask = out["mask"]
    mask = (mask[..., 0] if mask.ndim == 3 else mask).float() > 0.5
    return masked_psnr(out["render_tex"].float().cpu().numpy(),
                       gt_vis.cpu().numpy(), mask.cpu().numpy())


def frame_readings(engine: ReconEngine, image: torch.Tensor,
                   occ_fn: Callable, n_z: int = 64, flat: bool = False,
                   texture: bool = True) -> tuple[dict, dict]:
    """One frontal frame of ``image`` ([H, W, 3], the same image for netC)
    and its readings: {'iou': against ``gt_silhouette`` at the engine's
    fine lattice, 'psnr' / 'mae': ``texture_psnr`` when ``texture`` and
    the engine has netC, else None}. -> (readings, the frame)."""
    with_c = texture and engine.netC is not None
    image = image[None]
    out = engine.frame(image, image if with_c else None)
    gt = gt_silhouette(occ_fn, engine.fine_res, n_z, device=engine.device)
    readings = {"iou": silhouette_iou(out["valid"], gt), "psnr": None,
                "mae": None}
    if with_c:
        readings["psnr"], readings["mae"] = texture_psnr(
            out, engine, engine.fine_res, flat=flat)
    return readings, out


def ray_vs_dense(engine: ReconEngine, image: torch.Tensor, calib=None,
                 out: Optional[dict] = None) -> dict:
    """``bench_real``'s path-exactness keys (``bench.py:742-767``): the
    frame's maps (``out``, or a frame of ``image`` [1, H, W, 3]) against
    netG's own dense volume (``DENSE_RESOLUTIONS``, select 'uncertain'),
    queried through the engine's per-point head on the engine's features
    and depth-peeled: the silhouettes' IOU and the median depth error in
    fine voxels over pixels valid in both. A depth that is not finite
    (``depth_peel``'s 0/0 on the volume's near face, a fault of the
    reference kept as it is) is left out of the median."""
    if calib is None:
        calib = np.eye(4, dtype=np.float32)[None]
    if out is None:
        out = engine.frame(image, None, calib)
    feats = engine._filter_g(
        image.to(device=engine.device, dtype=engine.compute_dtype))
    calib_t = torch.as_tensor(np.asarray(calib, np.float32),
                              device=engine.device)
    dense = HierarchicalRecon(resolutions=DENSE_RESOLUTIONS,
                              select="uncertain")
    vol = dense(engine._query_occ_fn(feats, calib_t), device=engine.device)
    oracle = depth_peel(vol, "front", 0.5)
    got, want = out["valid"], oracle.valid
    both = got & want
    err = (out["depth"].float() - oracle.depth).abs()[both]
    err = err[torch.isfinite(err)]
    return {"real_ray_vs_dense_iou": silhouette_iou(got, want),
            "real_depth_err_med_voxels":
                float(err.median()) if err.numel() else float("nan")}


# -- profiles ---------------------------------------------------------------
def bench_engine(netG, netC, dtype: torch.dtype, device) -> ReconEngine:
    """The bench profile (``eval_netg.py:52-58``, ``bench.py:189-205``):
    ``frame_check.rtl_config`` — fine 257, 6 taps, 192^2 window, march
    (33, 65), recon (17, 33, 65) with budgets (0, 4096, 16384)."""
    recon, cfg = frame_check.rtl_config(dtype)
    return ReconEngine(netG, netC, recon=recon, config=cfg, device=device)


def reduced_engine(netG, netC, dtype: torch.dtype, device,
                   fine_res: int = 129) -> ReconEngine:
    """The reduced CPU profile of ``tests/test_trained_pipeline.py`` and
    ``eval_crossfam.py --cpu``: recon (17, 33) with budgets (0, 4096),
    then ``ray_refine`` at ``fine_res``, 6 taps, a 96^2 window."""
    recon = HierarchicalRecon(resolutions=(17, 33), budgets=(0, 4096),
                              select="uncertain")
    cfg = EngineCfg.flat(mode="ray", fine_res=fine_res, ray_taps=6,
                         ray_window=96, compute_dtype=dtype)
    return ReconEngine(netG, netC, recon=recon, config=cfg, device=device)


def rotated_engine(netG, netC, anchors, dtype: torch.dtype, device,
                   texels: float = 1.0) -> ReconEngine:
    """eval_rotated_anchored's profile (its ``build()``, ``:43-61``):
    fine 129, 6 taps, 96^2 window, march (17, 33), compaction 0.625,
    ``rot_anchors=anchors`` at ``rot_anchor_texels=texels``."""
    recon = HierarchicalRecon(resolutions=(17, 33), budgets=(0, 4096),
                              select="uncertain")
    cfg = EngineCfg.flat(mode="ray", fine_res=129, ray_taps=6, ray_window=96,
                         march_levels=(17, 33), compact_rotated=0.625,
                         rot_anchors=anchors, rot_anchor_texels=texels,
                         compute_dtype=dtype)
    return ReconEngine(netG, netC, recon=recon, config=cfg, device=device)


def bench_quality(netG, netC, image: torch.Tensor, caps,
                  dtype: torch.dtype, device) -> tuple[dict, dict]:
    """``bench_real``'s quality keys (``bench.py:799-808``, unrounded) for
    ``image`` ([H, W, 3], the render of the capsule body ``caps``) at the
    bench profile: ``real_model_vs_gt_iou`` (64 z-slices at 257),
    ``real_ray_vs_dense_iou``, ``real_depth_err_med_voxels`` and, with
    netC, ``real_tex_psnr_db`` and ``real_tex_mae``. -> (keys, the
    frame)."""
    engine = bench_engine(netG, netC, dtype, device)
    readings, out = frame_readings(engine, image, capsule_occ(caps))
    keys = {"real_model_vs_gt_iou": readings["iou"]}
    keys.update(ray_vs_dense(engine, image[None], out=out))
    if readings["psnr"] is not None:
        keys["real_tex_psnr_db"] = readings["psnr"]
        keys["real_tex_mae"] = readings["mae"]
    return keys, out


def pose_calib(yaw: float, pitch: float) -> np.ndarray:
    """[1, 4, 4] calib of the orbit camera over an identity intrinsic."""
    return pifu_calib(orbit_extrinsic(yaw, pitch),
                      np.eye(4, dtype=np.float32))


def rotated_anchored(netG, netC, image: torch.Tensor, caps,
                     dtype: torch.dtype, device,
                     texels=None) -> tuple[dict, dict]:
    """eval_rotated_anchored's readings (``:88-146``): at each orbit pose,
    the per-point path's silhouette IOU against the view-space ground
    truth, and for each anchored mode its silhouette IOU against the
    per-point path's and the ground truth, the depth MAD and 95th
    percentile and the texture MAD over the per-point frame, its plan and
    dropped rays. Modes: ``ROTATED_MODES``, or with ``texels`` the 'auto'
    plan at each tolerance ('tx<t>'). -> (the script's keys, unrounded,
    without ``wall_s``; {(pose tag, mode): the anchors of each refine
    level, None = exact per-point, the exact mode's levels included}).

    ``image`` is [H, W, 3]."""
    if texels:
        modes = (None,) + tuple(f"tx{t:g}" for t in texels)
        engines = {None: rotated_engine(netG, netC, None, dtype, device)}
        engines.update({f"tx{t:g}": rotated_engine(
            netG, netC, "auto", dtype, device, texels=t) for t in texels})
    else:
        modes = ROTATED_MODES
        engines = {k: rotated_engine(netG, netC, k, dtype, device)
                   for k in modes}
    image = image[None]
    out, plans = {}, {}
    for yaw, pitch in POSES:
        calib = pose_calib(yaw, pitch)
        tag = f"y{int(yaw)}p{int(pitch)}"
        frames = {}
        for k, eng in engines.items():
            if eng._calib_taps_ok(calib):
                raise ValueError(f"pose {tag} is not a rotated calib")
            plans[(tag, k)] = (eng._rot_anchor_plan(calib, image.shape[1])
                               or (None,) * len(eng._refine_pairs()))
            frames[k] = eng.frame(image, image, calib)
        for k in modes[1:]:
            if isinstance(k, str):
                out[f"{tag}_plan_{k}"] = str(
                    engines[k]._rot_anchor_plan(calib, image.shape[1]))
        gt = gt_silhouette(capsule_occ(caps), 129, 48, calib=calib,
                           device=device)
        vd = frames[None]["valid"]
        out[f"{tag}_iou_gt_pp"] = silhouette_iou(vd, gt)
        for k in modes[1:]:
            va = frames[k]["valid"]
            out[f"{tag}_iou_anch{k}_vs_pp"] = silhouette_iou(va, vd)
            out[f"{tag}_iou_gt_anch{k}"] = silhouette_iou(va, gt)
            dd = (frames[k]["depth"].float()
                  - frames[None]["depth"].float()).abs()[va & vd]
            dd = dd.double().cpu().numpy()
            out[f"{tag}_depth_mad_anch{k}"] = float(dd.mean())
            out[f"{tag}_depth_p95_anch{k}"] = float(np.percentile(dd, 95))
            tex = (frames[k]["render_tex"].float()
                   - frames[None]["render_tex"].float()).abs()
            out[f"{tag}_tex_mad_anch{k}"] = float(tex.double().mean())
            dropped = frames[k].get("compact_dropped")
            if dropped is not None:
                out[f"{tag}_dropped_anch{k}"] = dropped.cpu().tolist()
    return out, plans

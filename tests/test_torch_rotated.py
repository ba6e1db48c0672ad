"""PyTorch port, rotated (free-viewpoint) slice against monoport_tpu on the
CPU, f32:

* ``MonoPortNet.query_taps_anchored`` vs the JAX method under a rotated
  affine calib and for a perspective net, through the plain head and
  through the anchored MLP (``apply_anchor`` / ``apply_anchor_xla``), and
  the identities the JAX tests hold (frontal calib = ``query_taps``;
  features linear in uv are exact);
* the compacted refine (``_compact_rays``, ``refine_from_maps(compact=)``,
  ``ray_pyramid`` with a per-level fn list) on an analytic sphere, windowed
  and not, with an overflowing budget;
* the host-side planner and budget helpers vs the JAX engine;
* small rotated engine frames (64^2 image, levels (9, 17), fine 33, netG
  and netC with the weights carried across) vs the JAX engine.

Tolerances: heads atol 2e-5 / rtol 1e-4; depth 2e-4 fine voxels, renders
2e-3. The engine frames allow a stated fraction of flipped pixels: a
random-init net outputs occupancy ~0.5 everywhere, so a last-bit
difference in a sum's order flips the ``> 0.5`` test on a few knife-edge
rays (the allowance tests/test_torch_engine.py makes)."""

import functools
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from monoport_tpu.config import CN as JCN
from monoport_tpu.engine import EngineCfg as JaxEngineCfg
from monoport_tpu.engine import ReconEngine as JaxEngine
from monoport_tpu.models import MonoPortNet as JaxNet
from monoport_tpu.ops.pallas import fused_ray_mlp as jray
from monoport_tpu.recon.hierarchy import HierarchicalRecon as JaxRecon
from monoport_tpu_torch import frame_check, weights
from monoport_tpu_torch import engine as tengine
from monoport_tpu_torch.config import CN
from monoport_tpu_torch.engine import (EngineCfg, RayCfg, ReconEngine,
                                       RotatedCfg, TextureCfg)
from monoport_tpu_torch.ops.cuda import fused_ray_mlp as tray
from monoport_tpu_torch.recon import ray_refine as trr
from monoport_tpu_torch.recon.hierarchy import HierarchicalRecon

jrr = importlib.import_module("monoport_tpu.recon.ray_refine")
jengine = importlib.import_module("monoport_tpu.engine")
torch.set_num_threads(2)
FLIP_FRACTION = 0.005

# rotated view calib: z terms in both image rows plus an x/y-mixing z row
ROT_CALIB = np.asarray([[[0.93, 0.02, 0.30, 0.05],
                         [-0.05, 0.99, 0.17, -0.02],
                         [0.24, -0.12, 0.92, 0.01],
                         [0.0, 0.0, 0.0, 1.0]]], np.float32)
# camera 3 units in front of the volume: the z-divide is well conditioned
PERSP_CALIB = np.asarray([[[0.9, 0.02, 0.05, 0.02],
                           [-0.03, 1.05, 0.08, -0.01],
                           [0.1, -0.05, 1.0, 3.0],
                           [0.0, 0.0, 0.0, 1.0]]], np.float32)
INPLANE_CALIB = np.asarray([[[0.9, 0.3, 0.0, 0.0],
                             [-0.3, 0.9, 0.0, -0.01],
                             [0.1, -0.05, 1.0, 0.0],
                             [0.0, 0.0, 0.0, 1.0]]], np.float32)


def _opts(kind, projection="orthogonal"):
    o = {"projection": projection, "normalizer": {"IMF": "PIFuNomalizer"}}
    if kind == "G":
        o.update(backbone={"IMF": "PIFuHGFilters", "num_stack": 1,
                           "num_hourglass": 1, "hourglass_dim": 64,
                           "norm": "group", "hg_down": "ave_pool"},
                 head={"IMF": "PIFuNetGMLP"}, loss={"IMF": "MSE"})
    else:
        o.update(backbone={"IMF": "PIFuResBlkFilters"},
                 head={"IMF": "PIFuNetCMLP"}, loss={"IMF": "L1"})
    return o


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(1)
    image = rng.rand(1, 64, 64, 3).astype(np.float32)
    pts = jnp.zeros((1, 8, 3), jnp.float32)
    calib = np.eye(4, dtype=np.float32)[None]
    jg, jc = JaxNet(JCN(_opts("G"))), JaxNet(JCN(_opts("C")))
    pg = jg.init(jax.random.PRNGKey(0), jnp.asarray(image), pts, calib)
    pc = jc.init(jax.random.PRNGKey(1), jnp.asarray(image), pts, calib,
                 feat_prior=jnp.zeros((1, 32, 32, 64)))
    tree = lambda p: jax.tree.map(lambda a: np.asarray(a, np.float32),
                                  p["params"])
    tg = weights.build_net(CN(_opts("G")), tree(pg), device="cpu")
    tc = weights.build_net(CN(_opts("C")), tree(pc), device="cpu")
    # the perspective net shares netG's weights (projection has none)
    jp = JaxNet(JCN(_opts("G", "perspective")))
    tp = weights.build_net(CN(_opts("G", "perspective")), tree(pg),
                           device="cpu")
    return {"image": image, "jax": (jg, jc, pg, pc), "port": (tg, tc),
            "persp": (jp, tp)}


# -- query_taps_anchored ----------------------------------------------------

def _rays(r=37, t=6, spread=0.45, seed=1):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(-spread, spread, (1, r, 2)).astype(np.float32)
    z0 = rng.uniform(-0.4, 0.1, (1, r, 1)).astype(np.float32)
    return xy, (z0 + np.linspace(0, 0.3, t, dtype=np.float32)).astype(
        np.float32)


def _linear_feats(h, w, c, seed=0):
    """[1, h, w, c] feature map linear in (u, v): bilinear sampling, and
    so the anchored lerp, is exact on it."""
    rng = np.random.RandomState(seed)
    a, b, d = (rng.randn(c).astype(np.float32) for _ in range(3))
    u = np.linspace(-1, 1, w, dtype=np.float32)[None, :, None]
    v = np.linspace(-1, 1, h, dtype=np.float32)[:, None, None]
    return (a * u + b * v + d)[None].astype(np.float32)


@pytest.mark.parametrize("head", ["plain", "anchor_mlp"])
@pytest.mark.parametrize("kind,k", [("affine", 2), ("affine", 3),
                                    ("affine", 1), ("perspective", 3)])
def test_query_taps_anchored_matches_jax(setup, kind, k, head):
    jg, _, pg, _ = setup["jax"]
    tg = setup["port"][0]
    calib = ROT_CALIB
    if kind == "perspective":
        jg, tg = setup["persp"]
        calib = PERSP_CALIB
    feat = np.random.RandomState(3).randn(1, 16, 16, 64).astype(np.float32)
    xy, z = _rays(spread=0.9)            # some taps leave the image
    jhead = thead = None
    if head == "anchor_mlp":
        packed = jray.pack_ray_mlp_params(
            pg["params"]["surface_classifier"], dtype=jnp.float32)
        jhead = functools.partial(jray.apply_anchor_xla, packed,
                                  last_op="sigmoid",
                                  compute_dtype=jnp.float32)
        tp = tray.pack_ray_mlp_params(tg.surface_classifier,
                                      dtype=torch.float32)
        thead = functools.partial(tray.apply_anchor, tp)
    want = jg.apply(pg, [[jnp.asarray(feat)]], jnp.asarray(xy),
                    jnp.asarray(z), jnp.asarray(calib),
                    method="query_taps_anchored", anchors=k,
                    head_anchor_fn=jhead)
    with torch.no_grad():
        got = tg.query_taps_anchored(
            [[torch.from_numpy(feat)]], torch.from_numpy(xy),
            torch.from_numpy(z), torch.from_numpy(calib), anchors=k,
            head_anchor_fn=thead)
    assert got.shape == (1, 37, 6, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_anchored_on_a_frontal_calib_is_query_taps(setup, k):
    """A z-free calib gives zero-length chords (alpha 0, no division by
    zero): every anchor is the ray's own sample."""
    tg = setup["port"][0]
    feat = torch.from_numpy(
        np.random.RandomState(3).randn(1, 16, 16, 64).astype(np.float32))
    xy, z = (torch.from_numpy(a) for a in _rays())
    calib = torch.from_numpy(INPLANE_CALIB)
    with torch.no_grad():
        want = tg.query_taps([[feat]], xy, z, calib)
        got = tg.query_taps_anchored([[feat]], xy, z, calib, anchors=k)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("kind", ["affine", "perspective"])
def test_anchored_linear_features_exact(setup, kind):
    """On feature maps linear in uv the anchored query equals the
    per-point query: the geometry is exact and the lerp lossless."""
    tg, calib = setup["port"][0], ROT_CALIB
    if kind == "perspective":
        tg, calib = setup["persp"][1], PERSP_CALIB
    feat = torch.from_numpy(_linear_feats(16, 16, 64))
    xy, z = (torch.from_numpy(a) for a in _rays(r=29, spread=0.4))
    t = z.shape[-1]
    pts = torch.cat([xy[:, :, None].expand(1, 29, t, 2), z[..., None]],
                    dim=-1).reshape(1, 29 * t, 3)
    calib = torch.from_numpy(calib)
    with torch.no_grad():
        want = tg.query([[feat]], pts, calib)[0].reshape(1, 29, t, 1)
        got = tg.query_taps_anchored([[feat]], xy, z, calib, anchors=2)
    torch.testing.assert_close(got, want, atol=3e-5, rtol=1e-4)


# -- compacted refine on an analytic sphere ---------------------------------

CENTER = np.asarray([0.0, -0.1, 0.05], np.float32)


def _jax_occ(pts, radius=0.42):
    d = jnp.linalg.norm(pts - CENTER, axis=-1)
    return jax.nn.sigmoid((radius - d) * 40.0)[..., None]


def _torch_occ(pts, radius=0.42):
    d = torch.linalg.vector_norm(pts - torch.from_numpy(CENTER), dim=-1)
    return torch.sigmoid((radius - d) * 40.0)[..., None]


def _jax_taps(xy, z, radius=0.42):
    t = z.shape[-1]
    pts = jnp.concatenate([jnp.broadcast_to(
        xy[:, :, None], xy.shape[:2] + (t, 2)), z[..., None]], -1)
    return _jax_occ(pts, radius)[..., 0]


def _torch_taps(xy, z, radius=0.42):
    t = z.shape[-1]
    pts = torch.cat([xy[:, :, None].expand(-1, -1, t, 2), z[..., None]], -1)
    return _torch_occ(pts, radius)[..., 0]


def _check_maps(got, want):
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(want.depth),
                               atol=2e-4, rtol=0)
    np.testing.assert_allclose(got.normal.numpy(), np.asarray(want.normal),
                               atol=2e-3, rtol=0)


def test_compact_budget_sizing():
    for compact, h, w in ((None, 33, 33), (1.0, 33, 33), (0.625, 33, 33),
                          (0.99, 16, 16), (0.5, 192, 192), (0.5, 65, 65),
                          (0.05, 24, 24)):
        assert trr._compact_rays(compact, h, w) == jrr._compact_rays(
            compact, h, w)
    assert trr._compact_rays(0.5, 192, 192) == 18432
    assert trr._compact_rays(0.5, 65, 65) == 2304


def test_valid_indices_is_a_static_flatnonzero():
    rng = np.random.RandomState(0)
    valid = rng.rand(97) > 0.6
    for budget in (8, int(valid.sum()), 64, 97):
        want = jnp.flatnonzero(jnp.asarray(valid), size=budget, fill_value=97)
        got = trr._valid_indices(torch.from_numpy(valid), budget)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("per_level", [False, True])
@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("compact", [0.625, 0.05])
def test_compact_pyramid_matches_jax(compact, window, per_level):
    """compact 0.05 (a 256-ray budget) on a sphere of ~400 rays overflows
    at the fine level: the dropped counts are equal and dropped rays keep
    the coarse silhouette. ``per_level``: the 33-level runs a taps fn, the
    17-level exact per-point."""
    jt, tt, jstate, tstate = [], [], [], []
    kw = dict(levels=(9, 17), taps=4, window=window, compact=compact)
    radius = 0.7 if compact == 0.05 else 0.42
    jocc, tocc, jtaps, ttaps = (functools.partial(f, radius=radius) for f in
                                (_jax_occ, _torch_occ, _jax_taps,
                                 _torch_taps))
    jfn, tfn = ([None, jtaps], [None, ttaps]) if per_level else (None, None)
    want = jrr.ray_pyramid(jocc, 33, query_taps_fn=jfn, march_taps=False,
                           telemetry=jt, compact_state=jstate, **kw)
    got = trr.ray_pyramid(tocc, 33, query_taps_fn=tfn, march_taps=False,
                          telemetry=tt, compact_state=tstate, **kw)
    _check_maps(got, want)
    assert len(tt) == len(jt) == 2
    assert [int(d) for d in tt] == [int(d) for d in jt]
    assert (int(tt[-1]) > 0) == (compact == 0.05)
    assert len(tstate) == len(jstate) == (1 if window else 0)
    if window:
        assert set(tstate[0]) == set(jstate[0])
        for key in ("idx", "safe"):
            np.testing.assert_array_equal(tstate[0][key].numpy(),
                                          np.asarray(jstate[0][key]))
        np.testing.assert_allclose(tstate[0]["z"].numpy(),
                                   np.asarray(jstate[0]["z"]), atol=2e-4)
        assert int(tstate[0]["dropped"]) == int(jstate[0]["dropped"])
    if compact == 0.05:
        dense = trr.ray_pyramid(tocc, 33, levels=(9, 17), taps=4,
                                window=window)
        vd, vt = dense.valid.numpy(), got.valid.numpy()
        assert (vd & vt).sum() / max(vd.sum(), 1) > 0.95   # no holes


def test_compact_refine_equals_dense_at_valid_rays():
    dense = trr.ray_pyramid(_torch_occ, 33, levels=(9, 17), taps=4)
    comp = trr.ray_pyramid(_torch_occ, 33, levels=(9, 17), taps=4,
                           compact=0.625)
    vd = dense.valid.numpy()
    np.testing.assert_array_equal(vd, comp.valid.numpy())
    np.testing.assert_array_equal(dense.depth.numpy()[vd],
                                  comp.depth.numpy()[vd])


def test_pyramid_rejects_a_misshapen_fn_list():
    with pytest.raises(ValueError):
        trr.ray_pyramid(_torch_occ, 33, levels=(9, 17),
                        query_taps_fn=[None, _torch_taps])    # march_taps
    with pytest.raises(ValueError):
        trr.ray_pyramid(_torch_occ, 33, levels=(9, 17), march_taps=False,
                        query_taps_fn=[_torch_taps])


# -- host-side helpers of the engine ----------------------------------------

def _engines(setup, persp=False, **flat):
    """(JAX engine, port engine) of one small configuration, given by the
    JAX package's flat knob names."""
    jg, jc, _, _ = setup["jax"]
    tg, tc = setup["port"]
    if persp:
        jg, tg = setup["persp"]
    kw = dict(render_size=32, mode="ray", fine_res=33, ray_taps=5,
              march_levels=(9, 17), ray_window=24, compact_rotated=0.75)
    kw.update(flat)
    jeng = JaxEngine(jg, jc, recon=JaxRecon(resolutions=(9, 17),
                                            budgets=(0, 2048)),
                     config=JaxEngineCfg.flat(**kw))
    cfg = EngineCfg(
        render_size=kw["render_size"],
        ray=RayCfg(mode=kw["mode"], fine_res=kw["fine_res"],
                   taps=kw["ray_taps"], window=kw["ray_window"],
                   march_levels=kw["march_levels"],
                   use_ray_query=kw.get("use_ray_query", True)),
        rotated=RotatedCfg(compact=kw["compact_rotated"],
                           anchors=kw.get("rot_anchors", "auto"),
                           anchor_texels=kw.get("rot_anchor_texels", 1.5)),
        texture=TextureCfg(reuse_compact=kw.get("tex_reuse_compact", True),
                           stride=kw.get("tex_stride", 1),
                           bf16=kw.get("tex_bf16", False),
                           pallas_head=kw.get("tex_pallas_head", False)))
    teng = ReconEngine(tg, tc, recon=HierarchicalRecon(resolutions=(9, 17),
                                                       budgets=(0, 2048)),
                       config=cfg, device="cpu")
    return jeng, teng


@pytest.mark.parametrize("yaw,pitch,plan", [
    (20.0, 10.0, (5, 3)), (45.0, 0.0, (None, 4)), (10.0, 0.0, (3, 2)),
    (90.0, 0.0, (None, 5))])
def test_rot_anchor_plan_at_the_operating_point(setup, yaw, pitch, plan):
    jeng, teng = _engines(setup, fine_res=257, ray_taps=6,
                          march_levels=(33, 65), ray_window=192,
                          compact_rotated=0.5)
    calib = frame_check.rotated_calib(yaw, pitch)
    assert teng._rot_anchor_plan(calib, 512) == plan
    assert jeng._rot_anchor_plan(calib, 512) == plan
    assert teng._refine_pairs() == jeng._refine_pairs() == [(33, 65),
                                                            (65, 257)]


def test_rot_anchor_plan_options_match_jax(setup):
    for flat, persp, calib in (({"rot_anchors": 2}, False, ROT_CALIB),
                               ({"rot_anchors": None}, False, ROT_CALIB),
                               ({"rot_anchor_texels": 0.5}, False, ROT_CALIB),
                               ({}, True, PERSP_CALIB), ({}, False, ROT_CALIB)):
        jeng, teng = _engines(setup, persp=persp, **flat)
        assert teng._rot_anchor_plan(calib, 64) == jeng._rot_anchor_plan(
            calib, 64), flat


def test_budget_helpers_match_jax(setup):
    assert tengine.COMPACT_LADDER == jengine.COMPACT_LADDER
    for hint, ceiling in ((0.1, 0.5), (0.25, 0.5), (0.26, 0.5), (0.4, 0.5),
                          (0.9, 0.5), (0.3, 0.25), (0.7, 0.75)):
        assert tengine._snap_budget(hint, ceiling) == jengine._snap_budget(
            hint, ceiling)
    jeng, teng = _engines(setup)
    for frac in (0.0, 0.0624, 0.3):
        assert teng.compact_hint_from_valid(frac) == pytest.approx(
            jeng.compact_hint_from_valid(frac))
    for dropped in ([0, 0], [0, 0, 0], [3, 0, 7]):
        assert teng.compact_report(
            {"compact_dropped": torch.tensor(dropped)}) == \
            jeng.compact_report({"compact_dropped": np.asarray(dropped)})
    assert teng.compact_report({}) == jeng.compact_report({})


def test_copied_calib_helpers_match_jax():
    from monoport_tpu.recon.calib import pifu_calib
    from monoport_tpu.render.camera import orbit_extrinsic
    for yaw, pitch in ((20.0, 10.0), (45.0, 0.0), (-30.0, 5.0)):
        np.testing.assert_array_equal(
            frame_check.rotated_calib(yaw, pitch),
            pifu_calib(orbit_extrinsic(yaw, pitch), np.eye(4)))


# -- the slice as a whole: small rotated engine frames ----------------------

FRAMES = {
    "anchors2": (dict(rot_anchors=2), ROT_CALIB),
    "per_point": (dict(rot_anchors=None), ROT_CALIB),
    "auto_plan": (dict(), ROT_CALIB),
    "tex_stride2": (dict(rot_anchors=2, tex_stride=2), ROT_CALIB),
    "no_reuse": (dict(rot_anchors=2, tex_reuse_compact=False), ROT_CALIB),
    "overflow": (dict(rot_anchors=2, compact_rotated=0.3), ROT_CALIB),
    "inplane_taps": (dict(), INPLANE_CALIB),
    "dense_rotated": (dict(rot_anchors=2, compact_rotated=None), ROT_CALIB),
    "no_ray_query": (dict(use_ray_query=False),
                     np.eye(4, dtype=np.float32)[None]),
    "tex_kernel_head": (dict(rot_anchors=2, tex_pallas_head=True), ROT_CALIB),
    "tex_bf16": (dict(rot_anchors=2, tex_bf16=True), ROT_CALIB),
}


def _compare_frames(got, want):
    assert set(got) == set(want)
    va, vb = got["valid"].numpy(), np.asarray(want["valid"])
    assert vb.mean() > 0.05                  # the random net does hit
    assert (va != vb).mean() < FLIP_FRACTION
    for key, atol in (("depth", 2e-4), ("render_norm", 2e-3),
                      ("render_tex", 2e-3)):
        a = got[key].numpy().astype(np.float64)
        b = np.asarray(want[key], np.float64)
        assert np.isfinite(a).all(), key
        frac = (np.abs(a - b) > atol).mean()
        assert frac < FLIP_FRACTION, (key, frac)


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_rotated_frame_matches_jax_engine(setup, name):
    flat, calib = FRAMES[name]
    _, _, pg, pc = setup["jax"]
    jeng, teng = _engines(setup, **flat)
    image = setup["image"]
    want = jeng.frame(pg, jnp.asarray(image), pc, jnp.asarray(image),
                      jnp.asarray(calib))
    before = (tray.apply_ray.launches, tray.apply_anchor.launches)
    got = teng.frame(torch.from_numpy(image), torch.from_numpy(image), calib)
    # CPU tensors take the plain versions: nothing counts as a launch
    assert (tray.apply_ray.launches, tray.apply_anchor.launches) == before
    _compare_frames(got, want)
    if name == "inplane_taps":
        assert "compact_dropped" not in got
        assert teng._calib_taps_ok(calib) and not teng._calib_grid_ok(calib)
        return
    if name == "dense_rotated":
        assert "compact_dropped" not in got
        assert teng.compact_report(got) == jeng.compact_report(want)
        return
    dropped = got["compact_dropped"]
    assert dropped.dtype == torch.int32
    np.testing.assert_array_equal(dropped.numpy(),
                                  np.asarray(want["compact_dropped"]))
    assert dropped.shape[0] == (2 if name == "tex_stride2" else 3)
    assert bool(dropped.any()) == (name == "overflow")
    assert teng.compact_report(got) == jeng.compact_report(want)


def test_perspective_net_rides_the_anchored_path(setup):
    _, _, pg, pc = setup["jax"]
    jeng, teng = _engines(setup, persp=True)
    assert not teng._calib_taps_ok(np.eye(4, dtype=np.float32)[None])
    image = setup["image"]
    want = jeng.frame(pg, jnp.asarray(image), pc, jnp.asarray(image),
                      jnp.asarray(PERSP_CALIB))
    got = teng.frame(torch.from_numpy(image), torch.from_numpy(image),
                     PERSP_CALIB)
    _compare_frames(got, want)


def test_compact_hint_picks_a_ladder_rung(setup):
    """A hint below the ceiling runs a smaller budget: identical output
    where nothing drops; a hint above it is capped at the ceiling."""
    _, teng = _engines(setup, rot_anchors=2, compact_rotated=0.75)
    image = torch.from_numpy(setup["image"])
    base = teng.frame(image, image, ROT_CALIB)
    capped = teng.frame(image, image, ROT_CALIB, compact_hint=0.99)
    for key in base:
        torch.testing.assert_close(capped[key], base[key], atol=0, rtol=0)
    small = teng.frame(image, image, ROT_CALIB, compact_hint=0.1)  # 0.25
    assert int(small["compact_dropped"].sum()) > 0
    frontal = teng.frame(image, image, compact_hint=0.1)           # ignored
    assert "compact_dropped" not in frontal

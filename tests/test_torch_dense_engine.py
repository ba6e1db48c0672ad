"""PyTorch port, dense/hierarchy slice as a whole: small ReconEngine frames
against monoport_tpu's engine on the CPU, f32 (64^2 image, netG and netC of
tests/test_grid_query.py's ``engine_setup`` with the weights carried
across):

* ``mode='dense'`` (hierarchy + depth peel), frontal and rotated, and with
  a ``direction`` other than front;
* ``mode='ray'`` without ``march_levels`` (hierarchy + ``ray_refine``),
  frontal (grid queries) and rotated (the anchored query of the single
  coarse-to-fine level);
* ``rotated.march=False``: a rotated calib takes the hierarchy while a
  frontal one still marches;
* ``band_report``; ``frames()`` on a one-path clip and on a mixed clip,
  against per-frame ``frame()`` and against the JAX ``frames()``.

Tolerances: depth 2e-4 voxels, renders 2e-3, ``sdf`` 2e-5, each on all but
a stated fraction of pixels / voxels: a random-init net outputs occupancy
~0.5 everywhere, so a last-bit difference flips the ``> 0.5`` test on a few
knife-edge rays (the allowance tests/test_torch_engine.py makes).
``recon_counts`` must be equal. The budgets hold every candidate, so no
overflow decides which voxels are refined."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from monoport_tpu.config import CN as JCN
from monoport_tpu.engine import EngineCfg as JaxEngineCfg
from monoport_tpu.engine import ReconEngine as JaxEngine
from monoport_tpu.models import MonoPortNet as JaxNet
from monoport_tpu.recon.hierarchy import HierarchicalRecon as JaxRecon
from monoport_tpu_torch import weights
from monoport_tpu_torch.config import CN
from monoport_tpu_torch.engine import (EngineCfg, RayCfg, ReconEngine,
                                       RotatedCfg)
from monoport_tpu_torch.ops.cuda import fused_mlp as tmlp
from monoport_tpu_torch.recon.hierarchy import HierarchicalRecon

torch.set_num_threads(2)
FLIP_FRACTION = 0.005
EYE = np.eye(4, dtype=np.float32)[None]
ROT_CALIB = np.asarray([[[0.93, 0.02, 0.30, 0.05],
                         [-0.05, 0.99, 0.17, -0.02],
                         [0.24, -0.12, 0.92, 0.01],
                         [0.0, 0.0, 0.0, 1.0]]], np.float32)
# every non-coarse voxel of a level fits its budget: 17^3 - 9^3 = 4184,
# 33^3 - 17^3 = 31024
RECON = dict(resolutions=(9, 17, 33), budgets=(0, 4352, 31232))
COARSE = dict(resolutions=(9, 17), budgets=(0, 4352))


def _opts(kind):
    o = {"projection": "orthogonal", "normalizer": {"IMF": "PIFuNomalizer"}}
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
    images = rng.rand(3, 64, 64, 3).astype(np.float32)
    pts = jnp.zeros((1, 8, 3), jnp.float32)
    jg, jc = JaxNet(JCN(_opts("G"))), JaxNet(JCN(_opts("C")))
    pg = jg.init(jax.random.PRNGKey(0), jnp.asarray(images[:1]), pts, EYE)
    pc = jc.init(jax.random.PRNGKey(1), jnp.asarray(images[:1]), pts, EYE,
                 feat_prior=jnp.zeros((1, 32, 32, 64)))
    tree = lambda p: jax.tree.map(lambda a: np.asarray(a, np.float32),
                                  p["params"])
    return {"images": images, "jax": (jg, jc, pg, pc),
            "port": (weights.build_net(CN(_opts("G")), tree(pg),
                                       device="cpu"),
                     weights.build_net(CN(_opts("C")), tree(pc),
                                       device="cpu"))}


def _engines(setup, recon=RECON, **flat):
    """(JAX engine, port engine) of one small configuration, given by the
    JAX package's flat knob names."""
    jg, jc, _, _ = setup["jax"]
    tg, tc = setup["port"]
    kw = dict(render_size=32, mode="dense", fine_res=33, ray_taps=5,
              march_levels=None, ray_window=None, direction="front",
              march_rotated=True, rot_anchors="auto", compact_rotated=0.75)
    kw.update(flat)
    jeng = JaxEngine(jg, jc, recon=JaxRecon(**recon),
                     config=JaxEngineCfg.flat(**kw))
    cfg = EngineCfg(
        render_size=kw["render_size"], direction=kw["direction"],
        ray=RayCfg(mode=kw["mode"], fine_res=kw["fine_res"],
                   taps=kw["ray_taps"], window=kw["ray_window"],
                   march_levels=kw["march_levels"]),
        rotated=RotatedCfg(march=kw["march_rotated"],
                           anchors=kw["rot_anchors"],
                           compact=kw["compact_rotated"]))
    teng = ReconEngine(tg, tc, recon=HierarchicalRecon(**recon), config=cfg,
                       device="cpu")
    return jeng, teng


def _close(got, want, key, atol):
    a = got[key].numpy().astype(np.float64)
    b = np.asarray(want[key], np.float64)
    assert a.shape == b.shape, key
    ok = np.isfinite(b)
    np.testing.assert_array_equal(np.isfinite(a), ok, err_msg=key)
    frac = (np.abs(a - b)[ok] > atol).mean()
    assert frac < FLIP_FRACTION, (key, frac)


def _compare_frames(got, want, hierarchy=True):
    assert set(got) == set(want)
    va, vb = got["valid"].numpy(), np.asarray(want["valid"])
    assert vb.mean() > 0.05                  # the random net does hit
    assert (va != vb).mean() < FLIP_FRACTION
    # depth where both hit (a ray with no hit carries no depth); the
    # allowance is a fraction of the canvas, as for the other maps
    d = np.abs(got["depth"].numpy() - np.asarray(want["depth"]))[va & vb]
    assert (d > 2e-4).sum() < FLIP_FRACTION * va.size
    for key in ("render_norm", "render_tex"):
        _close(got, want, key, 2e-3)
    if hierarchy:
        _close(got, want, "sdf", 2e-5)
        assert got["recon_counts"].dtype in (torch.int32, torch.int64)
        np.testing.assert_array_equal(got["recon_counts"].numpy(),
                                      np.asarray(want["recon_counts"]))


# name -> (flat knobs, calib, recon)
FRAMES = {
    "dense_frontal": (dict(), EYE, RECON),
    "dense_rotated": (dict(), ROT_CALIB, RECON),
    "dense_windowed_texture": (dict(ray_window=24), EYE, RECON),
    "dense_left": (dict(direction="left"), EYE, RECON),
    "dense_back_rotated": (dict(direction="back"), ROT_CALIB, RECON),
    "ray_hierarchy_frontal": (dict(mode="ray", ray_window=24), EYE, COARSE),
    "ray_hierarchy_rotated": (dict(mode="ray", rot_anchors=2), ROT_CALIB,
                              COARSE),
    "ray_hierarchy_rotated_per_point": (
        dict(mode="ray", rot_anchors=None, ray_window=24), ROT_CALIB, COARSE),
    "march_off_for_rotated": (
        dict(mode="ray", march_levels=(9, 17), march_rotated=False,
             ray_window=24), ROT_CALIB, COARSE),
}


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_hierarchy_frame_matches_jax_engine(setup, name):
    flat, calib, recon = FRAMES[name]
    _, _, pg, pc = setup["jax"]
    jeng, teng = _engines(setup, recon=recon, **flat)
    image = setup["images"][:1]
    want = jeng.frame(pg, jnp.asarray(image), pc, jnp.asarray(image),
                      jnp.asarray(calib))
    before = tmlp.apply_mlp.launches
    got = teng.frame(torch.from_numpy(image), torch.from_numpy(image), calib)
    assert tmlp.apply_mlp.launches == before      # CPU: the plain version
    _compare_frames(got, want)
    res = recon["resolutions"][-1]
    assert got["sdf"].shape == (res, res, res)
    assert got["recon_counts"].shape == (len(recon["resolutions"]) - 1,)
    assert got["depth"].shape == (33, 33)     # dense: res; ray: fine_res
    assert teng._refine_pairs() == jeng._refine_pairs()
    assert teng._rot_anchor_plan(calib, 64) == jeng._rot_anchor_plan(calib,
                                                                     64)
    assert teng.band_report(got) == jeng.band_report(want)
    assert "OVER" not in teng.band_report(got)


def test_march_off_for_rotated_still_marches_frontal(setup):
    flat, _, recon = FRAMES["march_off_for_rotated"]
    _, _, pg, pc = setup["jax"]
    jeng, teng = _engines(setup, recon=recon, **flat)
    image = setup["images"][:1]
    want = jeng.frame(pg, jnp.asarray(image), pc, jnp.asarray(image),
                      jnp.asarray(EYE))
    got = teng.frame(torch.from_numpy(image), torch.from_numpy(image), EYE)
    assert "sdf" not in got and "recon_counts" not in got
    _compare_frames(got, want, hierarchy=False)
    assert teng.band_report(got) == jeng.band_report(want) \
        == "recon band: no refine levels"


def test_band_report_flags_overflow(setup):
    for select in ("uncertain", "first"):
        recon = dict(resolutions=(9, 17, 33), budgets=(0, 4352, 31232),
                     select=select)
        jeng, teng = _engines(setup, recon=recon)
        for counts in ([4184, 31024], [5000, 100], [1, 40000]):
            want = jeng.band_report({"recon_counts": np.asarray(counts)})
            assert teng.band_report(
                {"recon_counts": torch.tensor(counts)}) == want
            assert ("OVER BUDGET" in want) == (counts != [4184, 31024])


def test_engine_rejects_a_bad_configuration(setup):
    tg, tc = setup["port"]
    for cfg in (EngineCfg(ray=RayCfg(mode="dense", march_levels=(9, 17))),
                EngineCfg(direction="left",
                          ray=RayCfg(mode="ray", march_levels=(9, 17))),
                EngineCfg(ray=RayCfg(mode="volume"))):
        with pytest.raises(ValueError):
            ReconEngine(tg, tc, config=cfg, device="cpu")


CLIPS = {"one_path": (EYE, EYE), "mixed": (EYE, ROT_CALIB, EYE)}


@pytest.mark.parametrize("name", sorted(CLIPS))
def test_frames_matches_frame_and_jax_frames(setup, name):
    """A clip through ``frames()``: each output equals the ``frame()`` of
    that input bit for bit, and the clip agrees with the JAX ``frames()``.
    The march engine of the real-time frames: the mixed clip holds a
    rotated frame between two frontal ones."""
    calibs = np.concatenate(CLIPS[name])
    n = len(calibs)
    _, _, pg, pc = setup["jax"]
    jeng, teng = _engines(setup, recon=COARSE,
                          mode="ray", march_levels=(9, 17), ray_window=24,
                          rot_anchors=2)
    images = setup["images"][:n]
    got = teng.frames(torch.from_numpy(images), torch.from_numpy(images),
                      calibs)
    want = jeng.frames(pg, jnp.asarray(images), pc, jnp.asarray(images),
                       jnp.asarray(calibs))
    assert set(got) == set(want) == {"depth", "valid", "render_norm",
                                     "render_tex", "mask"}
    for i in range(n):
        one = teng.frame(torch.from_numpy(images[i:i + 1]),
                         torch.from_numpy(images[i:i + 1]), calibs[i:i + 1])
        for key in got:
            torch.testing.assert_close(got[key][i], one[key], atol=0, rtol=0)
        _compare_frames({k: v[i] for k, v in got.items()},
                        {k: np.asarray(v)[i, 0] if np.asarray(v).ndim
                         > got[k][i].ndim + 1 else np.asarray(v)[i]
                         for k, v in want.items()}, hierarchy=False)


def test_frames_defaults_and_a_dense_clip(setup):
    """No calibs = identity; no colour stream = no texture; a dense-mode
    clip stacks ``sdf`` and ``recon_counts`` too."""
    _, teng = _engines(setup, recon=COARSE)
    images = torch.from_numpy(setup["images"][:2])
    got = teng.frames(images)
    assert set(got) == {"depth", "valid", "render_norm", "mask", "sdf",
                        "recon_counts"}
    assert got["sdf"].shape == (2, 17, 17, 17)
    assert got["recon_counts"].shape == (2, 1)
    one = teng.frame(images[1:2], None, EYE)
    for key in got:
        torch.testing.assert_close(got[key][1], one[key], atol=0, rtol=0,
                                   equal_nan=True)
    # a rotated-only clip keeps the compaction telemetry
    _, march = _engines(setup, recon=COARSE,
                        mode="ray", march_levels=(9, 17), ray_window=24,
                        rot_anchors=2)
    rot = march.frames(images, images, np.concatenate([ROT_CALIB, ROT_CALIB]))
    assert rot["compact_dropped"].shape == (2, 3)

"""PyTorch port, engine: ReconEngine.frame against monoport_tpu's engine on
the small frontal frame (render_size 32, fine_res 33, 4 taps, march
(9, 17), a 24-ray window) with the small nets of tests/test_grid_query.py,
f32 on the CPU; plus the device rule and a run of every other path. The
rotated and in-plane-rotated frames are in tests/test_torch_rotated.py.

Tolerances: depth 2e-4 fine voxels and render_norm/render_tex 2e-3, on
all but a stated fraction of pixels: a random-init net outputs occupancy
~0.5 everywhere, so a last-bit difference in a sum's order flips the
``> 0.5`` test on a few knife-edge rays (the same allowance
test_grid_query.py makes between two JAX paths)."""

import dataclasses

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
from monoport_tpu_torch.recon.hierarchy import HierarchicalRecon

torch.set_num_threads(2)
FLIP_FRACTION = 0.005
SMALL = dict(render_size=32, fine_res=33, taps=4, march_levels=(9, 17),
             window=24)


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
    return {"image": image, "calib": calib, "jax": (jg, jc, pg, pc),
            "port": (tg, tc)}


def _port_engine(setup, **over):
    tg, tc = setup["port"]
    kw = {**SMALL, **over}
    cfg = EngineCfg(render_size=kw["render_size"],
                    ray=RayCfg(mode=kw.get("mode", "ray"),
                               fine_res=kw["fine_res"], taps=kw["taps"],
                               window=kw["window"],
                               march_levels=kw["march_levels"]))
    if "rotated" in kw:
        cfg = dataclasses.replace(cfg, rotated=kw["rotated"])
    return ReconEngine(tg, tc, recon=HierarchicalRecon(resolutions=(9, 17),
                                                 budgets=(0, 2048)),
                       config=cfg, device="cpu")


def test_frame_matches_jax_engine(setup):
    jg, jc, pg, pc = setup["jax"]
    image, calib = setup["image"], setup["calib"]
    jeng = JaxEngine(jg, jc, recon=JaxRecon(resolutions=(9, 17),
                                            budgets=(0, 2048)),
                     config=JaxEngineCfg.flat(
                         render_size=32, mode="ray", fine_res=33, ray_taps=4,
                         march_levels=(9, 17), ray_window=24))
    want = jeng.frame(pg, jnp.asarray(image), pc, jnp.asarray(image),
                      jnp.asarray(calib))
    got = _port_engine(setup).frame(torch.from_numpy(image),
                                    torch.from_numpy(image), calib)
    assert set(got) == {"depth", "valid", "render_norm", "render_tex", "mask"}
    assert got["depth"].shape == (33, 33)
    assert got["render_tex"].shape == (32, 32, 3)
    va, vb = got["valid"].numpy(), np.asarray(want["valid"])
    assert (va != vb).mean() < FLIP_FRACTION
    assert vb.mean() > 0.05                  # the random net does hit
    for key, atol in (("depth", 2e-4), ("render_norm", 2e-3),
                      ("render_tex", 2e-3)):
        a = got[key].numpy().astype(np.float64)
        b = np.asarray(want[key], np.float64)
        assert np.isfinite(a).all(), key
        frac = (np.abs(a - b) > atol).mean()
        assert frac < FLIP_FRACTION, (key, frac)


def test_engine_without_device_needs_cuda(setup, monkeypatch):
    tg, tc = setup["port"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = EngineCfg(ray=RayCfg(mode="ray", march_levels=(33, 65)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ReconEngine(tg, tc, config=cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        weights.load_default_networks()
    _, _, pg, _ = setup["jax"]
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), pg["params"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        weights.build_net(CN(_opts("G")), params)


def test_other_paths_raise_naming_their_roadmap_item():
    """What the port still lacks raises at construction and names its
    ROADMAP queue: the backbone's other norms and downsamplers, and the
    soft-onehot z features."""
    from monoport_tpu_torch.models.backbones.hourglass import HGFilter
    from monoport_tpu_torch.models.normalizers.depth_normalizer import (
        DepthNormalizer)

    for make in (lambda: HGFilter(num_stack=1, norm="batch"),
                 lambda: HGFilter(num_stack=1, hg_down="conv64"),
                 lambda: DepthNormalizer(soft_onehot=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
            make()


def test_dense_hierarchy_and_clip_paths_run(setup):
    """Rotated and in-plane-rotated calibs run, and so do the paths that
    once raised and named their slice: the hierarchy fallback of rotated
    frames, the dense mode, clips and the volume evaluator (held to the
    JAX package in tests/test_torch_dense_engine.py and
    tests/test_torch_hierarchy.py)."""
    eng = _port_engine(setup)
    image = torch.from_numpy(setup["image"])
    rotated = np.eye(4, dtype=np.float32)[None]
    rotated[0, 0, 2] = 0.3                   # z term in an image row
    inplane = np.eye(4, dtype=np.float32)[None]
    inplane[0, 0, 1] = 0.3                   # taps ok, grid not
    assert eng._calib_taps_ok(inplane) and not eng._calib_grid_ok(inplane)
    assert not eng._calib_taps_ok(rotated)
    for calib in (rotated, inplane):
        out = eng.frame(image, image, calib)
        assert out["depth"].shape == (33, 33)
        assert torch.isfinite(out["render_tex"]).all()
    fallback = _port_engine(setup, rotated=RotatedCfg(march=False))
    assert fallback.frame(image, image)["depth"].shape == (33, 33)
    out = fallback.frame(image, image, rotated)       # the hierarchy
    assert out["depth"].shape == (33, 33)
    assert out["sdf"].shape == (17, 17, 17)
    assert out["recon_counts"].shape == (1,)
    dense = _port_engine(setup, mode="dense", march_levels=None)
    out = dense.frame(image, image)
    assert out["depth"].shape == (17, 17) and out["sdf"].shape == (17,) * 3
    assert out["render_tex"].shape == (32, 32, 3)
    assert "17^3" in dense.band_report(out)
    clip = eng.frames(torch.cat([image, image]))
    assert clip["depth"].shape == (2, 33, 33) and "render_tex" not in clip
    vol = HierarchicalRecon(resolutions=(5, 9), budgets=(0, 1024))(
        lambda pts: torch.sigmoid(4.0 - 8.0 * pts.norm(dim=-1, keepdim=True)))
    assert vol.shape == (9, 9, 9) and 0.0 < float(vol.mean()) < 1.0

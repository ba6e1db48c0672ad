"""Full-width golden frames of the PyTorch port.

``python tests/test_torch_frame_golden.py --write`` runs the JAX engine on
the CPU at the real-time operating point in f32 (XLA twins of the ray
kernels, which in f32 are the kernels' math; matmul precision "highest")
on the committed weights and the held-out capsule render of
tests/test_trained_pipeline.py (same image for netG and netC), and stores
image, calib, depth, valid, render_norm and render_tex as f32: the frontal
frame (identity calib) in ``monoport_tpu_torch/data/frame_golden.npz``,
the rotated frame (the orbit camera at ``frame_check.ROTATED_POSE``, the
rotated defaults of the engine) in ``.../frame_golden_rotated.npz``, with
its anchor plan (0 = a per-point level) and ``compact_dropped``; the dense
frame (``frame_check.quality_config``: ``mode='dense'``, the 257^3
hierarchy, identity calib) in ``.../frame_golden_dense.npz``, with
``recon_counts`` and ``sdf`` at every fourth voxel and without the image
(it is the frontal golden's). ``--write`` takes the names of the goldens
to write (``frontal``, ``rotated``, ``dense``, ``softonehot``; all four
by default; the dense frame alone takes about half a minute).
``softonehot``: the frontal frame of the seeded soft-onehot netG
(``tests/torch_reference_state.soft_netg_state``: the committed netG's
architecture with 64 soft-onehot z bins, head input 320) with the
committed netC, in ``.../frame_golden_softonehot.npz`` with ``sdf`` at
every fourth voxel and ``recon_counts`` (a soft-onehot netG's frontal
frame takes the hierarchy, then ``ray_refine`` per point).

The slow tests run the port's CPU frames, full width, on the stored image and hold them
to the goldens with ``frame_check.compare_to_golden``; ``chip_smoke.py``
does the same with the card's frames."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_reference_state as helper  # noqa: E402
from monoport_tpu_torch import frame_check  # noqa: E402


def write_golden(path: str = frame_check.GOLDEN,
                 rotated_path: str = frame_check.GOLDEN_ROTATED,
                 dense_path: str = frame_check.GOLDEN_DENSE,
                 soft_path: str = frame_check.GOLDEN_SOFTONEHOT,
                 names=("frontal", "rotated", "dense", "softonehot")
                 ) -> dict:
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    from monoport_tpu.config import get_cfg_defaults
    from monoport_tpu.engine import EngineCfg, ReconEngine
    from monoport_tpu.models import MonoPortNet
    from monoport_tpu.recon.hierarchy import HierarchicalRecon
    from monoport_tpu.training.datasets.capsule import (render_front,
                                                        skeleton3d)
    from monoport_tpu.utils.params_io import load_params

    data = os.path.join(os.path.dirname(__file__), os.pardir,
                        "monoport_tpu", "data")
    cfg = get_cfg_defaults()
    netG, netC = MonoPortNet(cfg.netG), MonoPortNet(cfg.netC)
    params_g = {"params": load_params(os.path.join(
        data, "netg_capsule.npz"))[0]}
    params_c = {"params": load_params(os.path.join(
        data, "netc_capsule.npz"))[0]}
    image, _ = render_front(skeleton3d(jax.random.PRNGKey(4242)), 512)
    image = np.asarray(image, np.float32)[None]
    recon = HierarchicalRecon(resolutions=(17, 33, 65),
                              budgets=(0, 4096, 16384), select="uncertain")
    eng = ReconEngine(netG, netC, recon=recon, config=EngineCfg.flat(
        mode="ray", fine_res=257, ray_taps=6, ray_window=192,
        march_levels=tuple(cfg.recon.march_levels),
        compute_dtype=jnp.float32, use_pallas=False))
    goldens = {}
    dense = ReconEngine(netG, netC, recon=HierarchicalRecon(
        resolutions=frame_check.QUALITY_RESOLUTIONS,
        budgets=frame_check.QUALITY_BUDGETS, select="uncertain"),
        config=EngineCfg.flat(mode="dense", compute_dtype=jnp.float32,
                              use_pallas=False))
    eye = np.eye(4, dtype=np.float32)[None]
    soft = ReconEngine(MonoPortNet(helper.soft_netg_opts()), netC,
                       recon=recon, config=eng.config)
    for name, target, calib, engine in (
            ("frontal", path, eye, eng),
            ("rotated", rotated_path, frame_check.rotated_calib(), eng),
            ("dense", dense_path, eye, dense),
            ("softonehot", soft_path, eye, soft)):
        if name not in names:
            continue
        weights_g = (helper.flax_variables(helper.soft_netg_state())
                     if name == "softonehot" else params_g)
        out = engine.frame(weights_g, jnp.asarray(image), params_c,
                           jnp.asarray(image), calib)
        golden = {"image": image, "calib": calib,
                  "depth": np.asarray(out["depth"], np.float32),
                  "valid": np.asarray(out["valid"], bool),
                  "render_norm": np.asarray(out["render_norm"], np.float32),
                  "render_tex": np.asarray(out["render_tex"], np.float32)}
        if name in ("dense", "softonehot"):
            k = frame_check.SDF_STRIDE
            del golden["image"]
            golden["recon_counts"] = np.asarray(out["recon_counts"], np.int32)
            golden["sdf"] = np.asarray(out["sdf"], np.float32)[::k, ::k, ::k]
        if name == "rotated":
            plan = eng._rot_anchor_plan(calib, image.shape[1])
            golden["anchor_plan"] = np.asarray([k or 0 for k in plan],
                                               np.int32)
            golden["compact_dropped"] = np.asarray(out["compact_dropped"],
                                                   np.int32)
        np.savez_compressed(target, **golden)
        goldens[name] = golden
    return goldens


def _cpu_frame(golden: dict, config=frame_check.rtl_config,
               soft: bool = False) -> dict:
    from monoport_tpu_torch.engine import ReconEngine
    from monoport_tpu_torch.weights import load_default_networks

    netG, netC = load_default_networks(device="cpu")
    if soft:
        netG = helper.soft_netg("cpu")
    recon, cfg = config(torch.float32)
    eng = ReconEngine(netG, netC, recon=recon, config=cfg, device="cpu")
    image = torch.from_numpy(golden["image"])
    # the CPU frame's depth agreement depends on torch's thread count (its
    # f32 sums split differently): within 2e-3 on 83.2% of the pixels at 1
    # thread, 98.6% at 4, 99.98% at 8, 99.90% at 16; the port tests cap
    # threads at 2, so pin 8 here
    threads = torch.get_num_threads()
    torch.set_num_threads(8)
    try:
        out = eng.frame(image, image, golden["calib"])
    finally:
        torch.set_num_threads(threads)
    return eng, out


@pytest.mark.slow
def test_cpu_frame_matches_golden():
    golden = frame_check.load_golden()
    _, out = _cpu_frame(golden)
    res = frame_check.compare_to_golden(out, golden)
    assert res["ok"], res


@pytest.mark.slow
def test_cpu_rotated_frame_matches_golden():
    golden = frame_check.load_golden(frame_check.GOLDEN_ROTATED)
    eng, out = _cpu_frame(golden)
    plan = eng._rot_anchor_plan(golden["calib"], golden["image"].shape[1])
    assert [k or 0 for k in plan] == golden["anchor_plan"].tolist() == [5, 3]
    res = frame_check.compare_to_golden(out, golden)
    assert res["ok"], res
    np.testing.assert_array_equal(out["compact_dropped"].numpy(),
                                  golden["compact_dropped"])


@pytest.mark.slow
def test_cpu_dense_frame_matches_golden():
    """The 257^3 hierarchy frame on the CPU (about a minute; the JAX
    golden itself takes half a minute to write): full size, so kept out
    of Tier-1 like the two above."""
    golden = frame_check.load_golden(frame_check.GOLDEN_DENSE)
    golden["image"] = frame_check.load_golden()["image"]
    eng, out = _cpu_frame(golden, frame_check.quality_config)
    res = frame_check.compare_to_golden(out, golden)
    assert res["ok"], res
    sdf = frame_check.compare_sdf(out, golden)
    assert sdf["ok"], sdf
    assert out["sdf"].shape == (257, 257, 257)
    counts = out["recon_counts"].numpy()
    # a voxel on the band's edge may fall on either side of it
    np.testing.assert_allclose(counts, golden["recon_counts"], rtol=2e-3)
    assert "OVER" not in eng.band_report(out)


@pytest.mark.slow
def test_cpu_softonehot_frame_matches_golden():
    """The seeded soft-onehot netG's f32 frontal frame on the CPU: no ray
    query (the hierarchy, then per-point refines), held to the JAX
    golden at ``F32_SOFT_LIMITS``, its volume and ``recon_counts`` too."""
    golden = frame_check.load_golden(frame_check.GOLDEN_SOFTONEHOT)
    golden["image"] = frame_check.load_golden()["image"]
    eng, out = _cpu_frame(golden, soft=True)
    assert eng.head_g is None and eng.head_c is not None
    res = frame_check.compare_to_golden(out, golden,
                                        frame_check.F32_SOFT_LIMITS)
    assert res["ok"], res
    sdf = frame_check.compare_sdf(out, golden)
    assert sdf["ok"], sdf
    np.testing.assert_allclose(out["recon_counts"].numpy(),
                               golden["recon_counts"], rtol=2e-3)


def _synthetic_frame():
    """A 10x10-pixel subject on the golden's canvases: small against the
    canvas, as the real subject is (6% of it)."""
    valid = np.zeros((257, 257), bool)
    valid[100:110, 100:110] = True
    render = np.ones((256, 256, 3), np.float32)
    render[100:110, 100:110] = 0.25
    golden = {"valid": valid, "depth": np.full((257, 257), 128.0, np.float32),
              "render_norm": render, "render_tex": render.copy()}
    out = {k: torch.from_numpy(v.copy()) for k, v in golden.items()}
    return out, golden


@pytest.mark.parametrize("fault", [None, "valid", "depth", "render_norm",
                                   "render_tex"])
def test_compare_to_golden_counts_over_the_subject(fault):
    """One subject pixel in a hundred wrong fails the f32 limits, though it
    is far under 0.5% of the canvas."""
    out, golden = _synthetic_frame()
    if fault == "valid":
        out["valid"][105, 110] = True
    elif fault == "depth":
        out["depth"][105, 105] += 1e-2
    elif fault is not None:
        out[fault][105, 105, 0] += 1e-2
    res = frame_check.compare_to_golden(out, golden)
    assert res["ok"] == (fault is None), res
    if fault == "valid":
        assert res["valid_disagree"] == pytest.approx(1 / 101)


if __name__ == "__main__":
    if sys.argv[1:2] != ["--write"]:
        sys.exit("usage: python tests/test_torch_frame_golden.py --write "
                 "[frontal] [rotated] [dense] [softonehot]")
    chosen = tuple(sys.argv[2:]) or ("frontal", "rotated", "dense",
                                     "softonehot")
    for name, g in write_golden(names=chosen).items():
        print(name, {k: (v.shape, str(v.dtype)) for k, v in g.items()},
              "valid fraction", float(g["valid"].mean()),
              {k: g[k].tolist() for k in ("anchor_plan", "compact_dropped",
                                          "recon_counts") if k in g})

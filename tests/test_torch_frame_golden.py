"""Full-width golden frame of the PyTorch port.

``python tests/test_torch_frame_golden.py --write`` runs the JAX engine on
the CPU at the real-time operating point in f32 (XLA twin of the ray
kernel, which in f32 is the kernel's math; matmul precision "highest") on
the committed weights and the held-out capsule render of
tests/test_trained_pipeline.py (same image for netG and netC, identity
calib), and stores image, calib, depth, valid, render_norm and render_tex
as f32 in ``monoport_tpu_torch/data/frame_golden.npz``.

The slow test runs the port's CPU frame on the stored image and holds it
to the golden with ``frame_check.compare_to_golden``; ``chip_smoke.py``
does the same with the card's f32 frame."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

from monoport_tpu_torch import frame_check  # noqa: E402


def write_golden(path: str = frame_check.GOLDEN) -> dict:
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
    calib = np.eye(4, dtype=np.float32)[None]
    recon = HierarchicalRecon(resolutions=(17, 33, 65),
                              budgets=(0, 4096, 16384), select="uncertain")
    eng = ReconEngine(netG, netC, recon=recon, config=EngineCfg.flat(
        mode="ray", fine_res=257, ray_taps=6, ray_window=192,
        march_levels=tuple(cfg.recon.march_levels),
        compute_dtype=jnp.float32, use_pallas=False))
    out = eng.frame(params_g, jnp.asarray(image), params_c,
                    jnp.asarray(image), calib)
    golden = {"image": image, "calib": calib,
              "depth": np.asarray(out["depth"], np.float32),
              "valid": np.asarray(out["valid"], bool),
              "render_norm": np.asarray(out["render_norm"], np.float32),
              "render_tex": np.asarray(out["render_tex"], np.float32)}
    np.savez_compressed(path, **golden)
    return golden


@pytest.mark.slow
def test_cpu_frame_matches_golden():
    from monoport_tpu_torch.engine import ReconEngine
    from monoport_tpu_torch.weights import load_default_networks

    golden = frame_check.load_golden()
    netG, netC = load_default_networks(device="cpu")
    recon, cfg = frame_check.rtl_config(torch.float32)
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
    res = frame_check.compare_to_golden(out, golden)
    assert res["ok"], res


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
    if "--write" not in sys.argv:
        sys.exit("usage: python tests/test_torch_frame_golden.py --write")
    g = write_golden()
    print({k: (v.shape, str(v.dtype)) for k, v in g.items()},
          "valid fraction", float(g["valid"].mean()))

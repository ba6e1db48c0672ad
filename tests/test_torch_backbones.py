"""PyTorch port, backbones: every entry of the port's registry against the
JAX package's, on the same numpy-seeded weights (``torch_reference_state.
seeded_state``, carried to flax by the inverse of the weights bridge) and
image (JAX's GroupNorm cases in f64, ``jax_apply``); GroupNorm and
BatchNorm (running stats) as cases of one test, the
``conv64`` / ``conv128`` downsamplers of the hourglass, train-mode BatchNorm
(``batch_train``) with its running-stat update against flax's, and
``eval_net``. HRNet runs at 64^2 and Yolov4 at 128^2, as in
tests/test_backbones.py. f32, atol 1e-4 / rtol 1e-4; the running stats at
rtol 1e-5.

The slow test holds the port's three alternative netG backbones of
chip_smoke.py's phase 12 at 512^2 to ``data/backbone_golden.npz``, which
the JAX package writes from the same seeds (``--write``)."""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from monoport_tpu.config import CN as JCN
from monoport_tpu.models import MonoPortNet as JaxNet
from monoport_tpu.models.backbones import BACKBONES as JAX_BACKBONES
from monoport_tpu.models.monoport_net import eval_net as jax_eval_net
from monoport_tpu_torch import frame_check, weights
from monoport_tpu_torch.config import CN
from monoport_tpu_torch.models import BACKBONES, MonoPortNet
from monoport_tpu_torch.models.backbones.hourglass import BatchNorm
from monoport_tpu_torch.models.monoport_net import eval_net

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_reference_state import (ALT_NETGS, alt_netg_state,  # noqa: E402
                                   flax_variables, seeded_state)

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)
HG_SMALL = {"num_stack": 2, "num_hourglass": 1, "hourglass_dim": 32}

# (registry name, norm, backbone options): all nine entries, the
# multi-level HRNet under both norms, and the hourglass's strided-conv
# downsamplers (GroupNorm cases run JAX in f64: the small ones, for time)
CASES = [
    ("PIFuHGFilters", "batch", HG_SMALL),
    # (conv64's ConvBlock(64, 64) has 16-channel norms: no 32 groups)
    ("PIFuHGFilters", "batch", {**HG_SMALL, "hg_down": "conv64"}),
    ("PIFuHGFilters", "group", {**HG_SMALL, "hg_down": "conv128"}),
    ("PIFuResBlkFilters", "batch", {}),
    ("HRNetV2_W18_small_v2", "group", {}),
    ("HRNetV2_W18_small_v2", "batch", {}),
    ("HRNetV2_W18_small_v2_balance", "batch", {}),
    ("HRNetV2_W18_small_v2_balance_gn32", "batch", {}),
    ("HRNetV2_W18_small_v2_balance_last", "batch", {}),
    ("HRNetV2_W18_small_v2_balance_v2", "batch", {}),
    ("HRNetV2_W18_small_v2_deeper", "batch", {}),
    ("Yolov4Filters", "batch", {}),
]


def _size(imf: str) -> int:
    return 128 if imf.startswith("Yolo") else 64


def jax_apply(module, variables, *args, f64=False, **kw):
    """``module.apply`` under jit, compiled without XLA's backend
    optimizations (a third of the compile time of these nets on the CPU;
    the same arithmetic). ``f64``: run it in float64 (flax's GroupNorm
    takes E[x^2] - E[x]^2 in f32, whose cancellation a deep net amplifies
    past 1e-4 where torch's f32 moments stay within it)."""
    fn = jax.jit(lambda v, *a: module.apply(v, *a, **kw))
    if f64:
        with jax.enable_x64(True):
            v, a = jax.tree.map(lambda t: np.asarray(t, np.float64),
                                (variables, args))
            out = fn.lower(v, *a).compile(
                {"xla_backend_optimization_level": 0})(v, *a)
            return jax.tree.map(lambda t: np.asarray(t, np.float32), out)
    lowered = fn.lower(variables, *args)
    return lowered.compile({"xla_backend_optimization_level": 0})(
        variables, *args)


def test_registry_matches_the_jax_package():
    assert set(BACKBONES) == set(JAX_BACKBONES)


@pytest.mark.parametrize("imf,norm,opts", CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2].get('hg_down', '')}"
                              for c in CASES])
def test_backbone_matches_jax(imf, norm, opts):
    opt = {**opts, "norm": norm}
    port = BACKBONES[imf](CN(opt))
    state = seeded_state(port, 7)
    port.load_state_dict(state, strict=True)
    port.eval()
    s = _size(imf)
    x = np.random.RandomState(3).rand(1, s, s, 3).astype(np.float32)
    want = jax_apply(JAX_BACKBONES[imf](JCN(opt)), flax_variables(state), x,
                     f64=norm == "group")
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert [len(g) for g in got] == [len(w) for w in want]
    for gs, ws in zip(got, want):
        for g, w in zip(gs, ws):
            w = np.asarray(w)
            assert g.shape == w.shape and np.abs(w).max() > 0.1
            np.testing.assert_allclose(g.numpy(), w, **TOL)


def _bn_opts(norm: str) -> dict:
    return {"projection": "orthogonal",
            "backbone": {"IMF": "PIFuHGFilters", "num_stack": 1,
                         "num_hourglass": 1, "hourglass_dim": 64,
                         "norm": norm, "hg_down": "ave_pool"},
            "normalizer": {"IMF": "PIFuNomalizer"},
            "head": {"IMF": "PIFuNetGMLP"}, "loss": {"IMF": "MSE"}}


def _bn_batch(seed: int):
    rng = np.random.RandomState(seed)
    return (rng.rand(2, 32, 32, 3).astype(np.float32),
            rng.uniform(-1, 1, (2, 64, 3)).astype(np.float32),
            np.tile(np.eye(4, dtype=np.float32)[None], (2, 1, 1)))


def _stats(state: dict) -> dict:
    return {k: v for k, v in state.items()
            if k.endswith(("running_mean", "running_var"))}


def test_batch_train_matches_flax_and_eval_net_reads_running_stats():
    """One train-mode forward of a 'batch_train' net: its output at atol
    1e-4, the updated running stats at rtol 1e-5 against flax's
    ``apply(..., mutable=['batch_stats'])`` (flax's update takes the biased
    batch variance: torch's BatchNorm2d, with the unbiased one, would be
    off by 1 / (n - 1); atol 1e-5 of the tensor's largest entry, since
    the two packages' convolutions feed the stats inputs ~1e-7 apart);
    then ``eval_net`` reads the running stats, as the JAX package's
    does."""
    net = MonoPortNet(CN(_bn_opts("batch_train")),
                      head_channels=(65, 1024, 512, 256, 128, 1))
    state = seeded_state(net, 11)
    net.load_state_dict(state, strict=True)
    jnet = JaxNet(JCN(_bn_opts("batch_train")))
    variables = flax_variables(state)
    images, points, calibs = _bn_batch(0)
    want, updated = jax_apply(jnet, variables, images, points, calibs,
                              mutable=["batch_stats"])
    net.train()
    got = net.query(net.filter(torch.from_numpy(images)),
                    torch.from_numpy(points), torch.from_numpy(calibs))[0]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    moved = weights.torch_state_from_flax(
        jax.tree.map(np.asarray, {"params": variables["params"],
                                  "batch_stats": updated["batch_stats"]}))
    now = _stats(net.state_dict())
    assert set(now) == set(_stats(moved)) and len(now) > 10
    for k, v in now.items():
        assert not torch.equal(v, state[k]), k
        w = moved[k].numpy()
        np.testing.assert_allclose(v.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(), err_msg=k)
    counts = [m.num_batches_tracked.item() for m in net.modules()
              if isinstance(m, BatchNorm)]
    assert counts and set(counts) == {1}

    # eval: the running stats, a batch of one as in a batch of two
    enet = eval_net(net)
    assert not enet.training
    images, points, calibs = _bn_batch(1)
    jwant = jax_apply(jax_eval_net(jnet), {
        "params": variables["params"],
        "batch_stats": updated["batch_stats"]}, images, points, calibs)
    with torch.no_grad():
        full = enet.query(enet.filter(torch.from_numpy(images)),
                          torch.from_numpy(points),
                          torch.from_numpy(calibs))[0]
        one = enet.query(enet.filter(torch.from_numpy(images[:1])),
                         torch.from_numpy(points[:1]),
                         torch.from_numpy(calibs[:1]))[0]
    np.testing.assert_allclose(full.numpy(), np.asarray(jwant), **TOL)
    np.testing.assert_allclose(one.numpy(), full[:1].numpy(), **TOL)
    assert _stats(enet.state_dict()).keys() == now.keys()
    for k, v in _stats(enet.state_dict()).items():
        assert torch.equal(v, now[k]), k


def test_batch_norm_reads_running_stats_in_train_mode():
    """Norm 'batch' (converted reference weights) is flax's
    ``use_running_average``: running stats in train mode too, no update."""
    bn = BatchNorm(8, use_running_average=True).train()
    with torch.no_grad():
        bn.running_mean.uniform_(-1, 1)
        bn.running_var.uniform_(0.5, 2)
    before = {k: v.clone() for k, v in bn.state_dict().items()}
    x = torch.randn(2, 8, 5, 5, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(bn(x), bn.eval()(x), rtol=0, atol=0)
    for k, v in bn.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_batch_train_updates_the_biased_variance():
    """The running variance takes flax's biased batch variance, not the
    unbiased one torch's BatchNorm2d would (at 2 x 3 x 3 values a channel
    the two differ by 1/17 of the update)."""
    bn = BatchNorm(4, use_running_average=False).train()
    x = torch.randn(2, 4, 3, 3, generator=torch.Generator().manual_seed(1))
    y = bn(x)
    var = x.var(dim=(0, 2, 3), unbiased=False)
    want = 0.9 * torch.ones(4) + 0.1 * var
    torch.testing.assert_close(bn.running_var, want, rtol=1e-6, atol=0)
    unbiased = 0.9 + 0.1 * x.var(dim=(0, 2, 3), unbiased=True)
    assert ((bn.running_var - unbiased).abs() > 1e-3).all()
    torch.testing.assert_close(
        y, (x - x.mean((0, 2, 3))[:, None, None])
        / torch.sqrt(var + 1e-5)[:, None, None], rtol=1e-5, atol=1e-5)


# --- the full-width netGs of chip_smoke's phase 12 --------------------------

def _alt_backbone(imf: str) -> torch.nn.Module:
    """The seeded phase-12 netG's backbone, f32, eval mode, on the CPU."""
    net = BACKBONES[imf](CN({"norm": "batch"}))
    net.load_state_dict(
        {k[len("image_filter."):]: v for k, v in alt_netg_state(imf).items()
         if k.startswith("image_filter.")}, strict=True)
    return net.eval()


@pytest.mark.slow
@pytest.mark.parametrize("imf", ALT_NETGS)
def test_full_width_backbone_matches_golden(imf):
    torch.set_num_threads(8)
    image = torch.from_numpy(frame_check.load_golden()["image"])
    with torch.no_grad():
        got = frame_check.backbone_levels(_alt_backbone(imf)(image))
    res = frame_check.compare_backbone(
        got, frame_check.load_golden(frame_check.GOLDEN_BACKBONE), imf)
    assert res["ok"], res


def write_golden():
    """The JAX package's f32 backbone outputs at 512^2 on the frontal
    golden's image, for the seeded netGs of ``alt_netg_state``: every
    ``BACKBONE_STRIDE``-th pixel of every level, f16."""
    image = jnp.asarray(frame_check.load_golden()["image"])
    arrays = {}
    for imf in ALT_NETGS:
        state = _alt_backbone(imf).state_dict()
        out = jax_apply(JAX_BACKBONES[imf](JCN({"norm": "batch"})),
                        flax_variables(state), image)
        for name, level in frame_check.backbone_levels(out).items():
            arrays[f"{imf}/{name}"] = frame_check.subsample(level)
            print(imf, name, level.shape, float(np.abs(level).max()))
    np.savez_compressed(frame_check.GOLDEN_BACKBONE, **arrays)


if __name__ == "__main__":
    if "--write" in sys.argv:
        write_golden()

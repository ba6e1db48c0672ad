"""PyTorch port, models: the weights bridge, HGFilter, ResnetFilter,
SurfaceClassifier and MonoPortNet's filter/query methods against the JAX
package at small sizes (1 stack, 1 hourglass, hourglass_dim 64, 64^2
images). Both packages get the same flax-initialised weights through
``weights.torch_state_from_flax``; f32, atol 1e-4."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from monoport_tpu.config import CN as JCN
from monoport_tpu.models import MonoPortNet as JaxNet
from monoport_tpu.models.heads import PIFuNetCMLP as JaxNetCMLP
from monoport_tpu_torch import weights
from monoport_tpu_torch.config import CN
from monoport_tpu_torch.models.heads import SurfaceClassifier

torch.set_num_threads(2)
ATOL = 1e-4


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _opts(kind):
    g = {"projection": "orthogonal",
         "normalizer": {"IMF": "PIFuNomalizer"}}
    if kind == "G":
        g.update(backbone={"IMF": "PIFuHGFilters", "num_stack": 1,
                           "num_hourglass": 1, "hourglass_dim": 64,
                           "norm": "group", "hg_down": "ave_pool"},
                 head={"IMF": "PIFuNetGMLP"}, loss={"IMF": "MSE"})
    else:
        g.update(backbone={"IMF": "PIFuResBlkFilters"},
                 head={"IMF": "PIFuNetCMLP"}, loss={"IMF": "L1"})
    return g


@pytest.fixture(scope="module")
def nets():
    """(jax net, flax variables, port net) for a small netG and a netC
    whose prior comes from that netG (head input 256 + 64 + 1)."""
    rng = np.random.RandomState(1)
    image = jnp.asarray(rng.rand(1, 64, 64, 3).astype(np.float32))
    pts = jnp.zeros((1, 8, 3), jnp.float32)
    calib = jnp.eye(4, dtype=jnp.float32)[None]
    jg = JaxNet(JCN(_opts("G")))
    jc = JaxNet(JCN(_opts("C")))
    vg = jg.init(jax.random.PRNGKey(0), image, pts, calib)
    vc = jc.init(jax.random.PRNGKey(1), image, pts, calib,
                 feat_prior=jnp.zeros((1, 16, 16, 64)))
    tg = weights.build_net(CN(_opts("G")), _np_tree(vg["params"]))
    tc = weights.build_net(CN(_opts("C")), _np_tree(vc["params"]))
    return {"image": np.array(image), "G": (jg, vg, tg),
            "C": (jc, vc, tc)}


def _close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


def test_weights_bridge_layouts(nets):
    jg, vg, tg = nets["G"]
    params = _np_tree(vg["params"])
    state = weights.torch_state_from_flax(params)
    k = params["image_filter"]["conv1"]["kernel"]                 # HWIO
    np.testing.assert_array_equal(
        state["image_filter.conv1.weight"].numpy(), k.transpose(3, 2, 0, 1))
    d = params["surface_classifier"]["filters_1"]["kernel"]       # [in, out]
    np.testing.assert_array_equal(
        state["surface_classifier.filters_1.weight"].numpy(), d.T)
    gn = params["image_filter"]["bn1"]["scale"]
    np.testing.assert_array_equal(state["image_filter.bn1.weight"].numpy(),
                                  gn)
    assert weights.head_channels(params) == (65, 1024, 512, 256, 128, 1)
    assert set(state) == set(tg.state_dict())


def test_hgfilter_matches_jax(nets):
    jg, vg, tg = nets["G"]
    image = nets["image"]
    want = jg.apply(vg, jnp.asarray(image), method="filter")
    with torch.no_grad():
        got = tg.image_filter(torch.from_numpy(image))
    assert len(got) == len(want) == 1
    assert got[0][0].shape == (1, 16, 16, 64)
    _close(got[0][0], want[0][0])


def test_resnetfilter_and_prior_filter_match_jax(nets):
    """netC's filter: ResnetFilter + the nearest-resized netG prior."""
    jg, vg, tg = nets["G"]
    jc, vc, tc = nets["C"]
    image = nets["image"]
    prior = np.random.RandomState(5).randn(1, 8, 8, 64).astype(np.float32)
    want = jc.apply(vc, jnp.asarray(image), jnp.asarray(prior),
                    method="filter")
    with torch.no_grad():
        got = tc.filter(torch.from_numpy(image), torch.from_numpy(prior))
    assert got[0][0].shape == (1, 16, 16, 320)
    _close(got[0][0], want[0][0])


def test_surface_classifier_matches_jax():
    """The published netC head (513 -> ... -> 3, tanh) on seeded inputs."""
    head = JaxNetCMLP()
    x = np.random.RandomState(6).randn(1, 50, 513).astype(np.float32)
    variables = head.init(jax.random.PRNGKey(3), jnp.asarray(x))
    want = head.apply(variables, jnp.asarray(x))
    port = SurfaceClassifier((513, 1024, 512, 256, 128, 3), last_op="tanh")
    state = weights.torch_state_from_flax(_np_tree(variables["params"]))
    port.load_state_dict(state)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    _close(got, want, atol=2e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def feats(nets):
    jg, vg, tg = nets["G"]
    image = nets["image"]
    jf = jg.apply(vg, jnp.asarray(image), method="filter")
    with torch.no_grad():
        tf = tg.filter(torch.from_numpy(image))
    return jf, tf


CALIB = np.asarray([[[1.1, 0.0, 0.0, 0.05],
                     [0.0, 0.9, 0.0, -0.03],
                     [0.02, -0.1, 1.05, 0.01],
                     [0.0, 0.0, 0.0, 1.0]]], np.float32)


def test_query_matches_jax(nets, feats):
    jg, vg, tg = nets["G"]
    jf, tf = feats
    pts = np.random.RandomState(7).uniform(-1.2, 1.2, (1, 60, 3)) \
        .astype(np.float32)
    want = jg.apply(vg, jf, jnp.asarray(pts), jnp.asarray(CALIB),
                    method="query")[0]
    with torch.no_grad():
        got = tg.query(tf, torch.from_numpy(pts), torch.from_numpy(CALIB))[0]
    _close(got, want)


def test_query_taps_matches_jax(nets, feats):
    jg, vg, tg = nets["G"]
    jf, tf = feats
    rng = np.random.RandomState(8)
    xy = rng.uniform(-1.2, 1.2, (1, 33, 2)).astype(np.float32)
    z = rng.uniform(-1, 1, (1, 33, 5)).astype(np.float32)
    want = jg.apply(vg, jf, jnp.asarray(xy), jnp.asarray(z),
                    jnp.asarray(CALIB), method="query_taps")
    with torch.no_grad():
        got = tg.query_taps(tf, torch.from_numpy(xy), torch.from_numpy(z),
                            torch.from_numpy(CALIB))
    assert got.shape == (1, 33, 5, 1)
    _close(got, want)


def test_query_taps_grid_matches_jax(nets, feats):
    jg, vg, tg = nets["G"]
    jf, tf = feats
    rng = np.random.RandomState(9)
    xw = rng.uniform(-1, 1, (1, 9)).astype(np.float32)
    yw = rng.uniform(-1, 1, (1, 6)).astype(np.float32)
    zw = rng.uniform(-1, 1, (1, 9, 6, 4)).astype(np.float32)
    want = jg.apply(vg, jf, jnp.asarray(xw), jnp.asarray(yw),
                    jnp.asarray(zw), jnp.asarray(CALIB),
                    method="query_taps_grid")
    with torch.no_grad():
        got = tg.query_taps_grid(tf, torch.from_numpy(xw),
                                 torch.from_numpy(yw), torch.from_numpy(zw),
                                 torch.from_numpy(CALIB))
    assert got.shape == (1, 9, 6, 4, 1)
    _close(got, want)


def test_load_default_networks_full_width():
    """The committed capsule weights load strictly into the published
    widths (CPU; the forward pass at 512^2 is the slow golden test's)."""
    if not os.path.exists(os.path.join(weights.DATA, "netg_capsule.npz")):
        pytest.skip("committed capsule checkpoints absent")
    netG, netC = weights.load_default_networks(device="cpu")
    assert netG.surface_classifier.filter_channels == (
        257, 1024, 512, 256, 128, 1)
    assert netC.surface_classifier.filter_channels == (
        513, 1024, 512, 256, 128, 3)
    n_g = sum(p.numel() for p in netG.parameters())
    n_c = sum(p.numel() for p in netC.parameters())
    assert (n_g, n_c) == (15588098, 9139398)

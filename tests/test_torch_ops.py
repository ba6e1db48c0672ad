"""PyTorch port, ops: sampling, resampling and projection against the JAX
package on the same seeded numpy inputs (f32, atol 1e-5 unless stated)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from monoport_tpu.ops import projection as jproj
from monoport_tpu.ops import resize as jresize
from monoport_tpu.ops import sampling as jsamp
from monoport_tpu_torch.ops import projection as tproj
from monoport_tpu_torch.ops import resize as tresize
from monoport_tpu_torch.ops import sampling as tsamp

torch.set_num_threads(2)
ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


def test_index_matches_jax():
    rng = np.random.RandomState(0)
    feat = rng.rand(2, 16, 24, 8).astype(np.float32)
    # in-range, partially outside and fully outside positions
    uv = rng.uniform(-1.3, 1.3, (2, 50, 2)).astype(np.float32)
    _close(tsamp.index(_t(feat), _t(uv)),
           jsamp.index(jnp.asarray(feat), jnp.asarray(uv)))


def test_bilinear_rows_matches_jax():
    pos = np.random.RandomState(1).uniform(-1.4, 1.4, 37).astype(np.float32)
    _close(tsamp.bilinear_rows(_t(pos), 19),
           jsamp.bilinear_rows(jnp.asarray(pos), 19))


def test_index_grid_matches_jax_and_index():
    """index_grid against the JAX index_grid (1e-5) and against the port's
    own per-point index at the flattened lattice (1e-6, the JAX package's
    own tolerance for this identity)."""
    rng = np.random.RandomState(0)
    feat = rng.rand(2, 16, 24, 8).astype(np.float32)
    u = rng.uniform(-1.4, 1.4, (2, 7)).astype(np.float32)
    v = rng.uniform(-1.4, 1.4, (2, 5)).astype(np.float32)
    got = tsamp.index_grid(_t(feat), _t(u), _t(v))
    assert got.shape == (2, 7, 5, 8)
    _close(got, jsamp.index_grid(jnp.asarray(feat), jnp.asarray(u),
                                 jnp.asarray(v)))
    for b in range(2):
        uu, vv = np.meshgrid(u[b], v[b], indexing="ij")
        uv = np.stack([uu.ravel(), vv.ravel()], -1)[None]
        want = tsamp.index(_t(feat[b:b + 1]), _t(uv))[0].reshape(7, 5, 8)
        _close(got[b], want, atol=1e-6)


@pytest.mark.parametrize("mode,size", [("bilinear", (13, 29)),
                                       ("bicubic", (24, 30)),
                                       ("nearest", (40, 7))])
def test_interpolate_2d_matches_jax(mode, size):
    x = np.random.RandomState(2).randn(2, 12, 15, 4).astype(np.float32)
    _close(tresize.interpolate_2d(_t(x), size, mode),
           jresize.interpolate_2d(jnp.asarray(x), size, mode))


def test_upsample_and_pool_match_jax():
    x = np.random.RandomState(3).randn(1, 8, 10, 3).astype(np.float32)
    _close(tresize.upsample2x_bicubic(_t(x)),
           jresize.upsample2x_bicubic(jnp.asarray(x)))
    _close(tresize.avg_pool_2d(_t(x), 2, 2),
           jresize.avg_pool_2d(jnp.asarray(x), 2, 2))


@pytest.mark.parametrize("name", ["orthogonal", "perspective"])
def test_projection_matches_jax(name):
    rng = np.random.RandomState(4)
    pts = rng.uniform(-1, 1, (2, 30, 3)).astype(np.float32)
    calib = rng.randn(2, 4, 4).astype(np.float32) * 0.3
    calib[:, 2, 3] += 3.0               # keep the perspective divide away from 0
    calib[:, 2, 2] += 1.0
    trans = rng.randn(2, 2, 3).astype(np.float32) * 0.5
    for tr in (None, trans):
        got = tproj.PROJECTIONS[name](_t(pts), _t(calib),
                                      None if tr is None else _t(tr))
        want = jproj.PROJECTIONS[name](jnp.asarray(pts), jnp.asarray(calib),
                                       None if tr is None
                                       else jnp.asarray(tr))
        _close(got, want)

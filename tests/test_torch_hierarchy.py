"""PyTorch port, hierarchy path: ``interpolate_3d``, ``grid_points`` /
``dense_eval``, ``HierarchicalRecon``, ``depth_peel`` and ``ray_refine``
against the JAX package (run eagerly on the CPU) on analytic occupancy
fields at (9, 17, 33).

Both packages query one numpy field, so the queried values are the same
bits and only the packages' own arithmetic differs: volumes within 1e-6,
candidate counts equal, depth within 1e-5 where valid."""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from monoport_tpu.ops.resize import interpolate_3d as jinterp3
from monoport_tpu.recon import dense as jdense
from monoport_tpu.recon.hierarchy import HierarchicalRecon as JRecon
from monoport_tpu_torch.ops.resize import interpolate_3d
from monoport_tpu_torch.recon import dense as tdense
from monoport_tpu_torch.recon import depth_peel as tpeel
from monoport_tpu_torch.recon import ray_refine as trr
from monoport_tpu_torch.recon.hierarchy import HierarchicalRecon

jrr = importlib.import_module("monoport_tpu.recon.ray_refine")
jpeel = importlib.import_module("monoport_tpu.recon.depth_peel")
torch.set_num_threads(2)
RES = (9, 17, 33)


def _sigmoid(x):
    return (1.0 / (1.0 + np.exp(-x.astype(np.float64)))).astype(np.float32)


def _sphere(p):
    return _sigmoid((0.6 - np.linalg.norm(p - [0.1, -0.15, 0.05], axis=-1))
                    * 12.0)


def _two_spheres(p):
    a = 0.35 - np.linalg.norm(p - [-0.4, 0.1, 0.0], axis=-1)
    b = 0.3 - np.linalg.norm(p - [0.45, -0.2, 0.1], axis=-1)
    return _sigmoid(np.maximum(a, b) * 14.0)


def _slab(p):
    """A thin slab, 0.16 thick: under two coarse voxels."""
    inside = np.minimum(0.08 - np.abs(p[..., 2] - 0.03),
                        0.7 - np.abs(p[..., :2]).max(axis=-1))
    return _sigmoid(inside * 25.0)


FIELDS = {"sphere": _sphere, "two_spheres": _two_spheres, "slab": _slab}


def _queries(field):
    """The same numpy field as a JAX and as a torch ``query_fn``."""
    def jq(pts):
        # a callback, so that it also runs under dense_eval's lax.map
        return jax.pure_callback(
            lambda p: field(np.asarray(p, np.float32)),
            jax.ShapeDtypeStruct(pts.shape[:-1], jnp.float32),
            pts)[..., None]

    def tq(pts):
        return torch.from_numpy(field(pts.numpy()))[..., None]
    return jq, tq


def test_interpolate_3d_matches_jax():
    vol = np.random.RandomState(0).rand(9, 9, 9).astype(np.float32)
    for size in ((17, 17, 17), (12, 9, 20)):
        want = jinterp3(jnp.asarray(vol), size)
        got = interpolate_3d(torch.from_numpy(vol), size)
        assert got.shape == size
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=0)


def test_grid_points_and_index_to_world_match_jax():
    b_min, b_max = (-1.0, -0.8, -0.5), (0.9, 1.0, 0.7)
    want = jdense.grid_points(17, b_min, b_max)
    got = tdense.grid_points(17, b_min, b_max)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    idx = np.random.RandomState(1).randint(0, 33, (50, 3))
    np.testing.assert_allclose(
        tdense.index_to_world(torch.from_numpy(idx), 33, b_min, b_max).numpy(),
        np.asarray(jdense.index_to_world(jnp.asarray(idx), 33, b_min, b_max)),
        atol=1e-6, rtol=0)


@pytest.mark.parametrize("chunk", [4096, 5000])
def test_dense_eval_matches_jax(chunk):
    jq, tq = _queries(_sphere)
    want = jdense.dense_eval(jq, 17, chunk=chunk)
    got = tdense.dense_eval(tq, 17, chunk=chunk)
    assert got.shape == (17, 17, 17)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("select", ["uncertain", "first"])
@pytest.mark.parametrize("name", list(FIELDS))
def test_hierarchy_matches_jax(name, select):
    jq, tq = _queries(FIELDS[name])
    kw = dict(resolutions=RES, budgets=(0, 4096, 16384), select=select)
    want, jcounts = JRecon(**kw)(jq, return_counts=True)
    got, counts = HierarchicalRecon(**kw)(tq, return_counts=True)
    assert got.shape == (33, 33, 33) and got.dtype == torch.float32
    assert [int(c) for c in counts] == [int(c) for c in jcounts]
    assert all(c.ndim == 0 for c in counts) and int(counts[-1]) > 100
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("select", ["uncertain", "first"])
def test_hierarchy_overflow_refines_the_same_voxels(select):
    """Budgets far under the band: both packages refine the same voxels
    (the merge order of the two tiers decides which survive)."""
    jq, tq = _queries(_sphere)
    kw = dict(resolutions=RES, budgets=(0, 300, 700), select=select)
    want, jcounts = JRecon(**kw)(jq, return_counts=True)
    got, counts = HierarchicalRecon(**kw)(tq, return_counts=True)
    assert [int(c) for c in counts] == [int(c) for c in jcounts]
    assert int(counts[0]) > 300 and int(counts[1]) > 700
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    # the refined voxels are those whose value is the field's, not the
    # upsampled one: the same set in both
    exact = tdense.dense_eval(tq, 33, chunk=8192).numpy()
    np.testing.assert_array_equal(np.abs(got.numpy() - exact) < 1e-6,
                                  np.abs(np.asarray(want) - exact) < 1e-6)


def test_hierarchy_lossless_against_dense():
    """As tests/test_recon.py holds the JAX hierarchy: the binarization of
    the hierarchy equals the dense oracle's, and the band is exact."""
    _, tq = _queries(_sphere)
    recon = HierarchicalRecon(resolutions=RES, budgets=(0, 4096, 16384))
    occ_h, counts = recon(tq, return_counts=True)
    occ_d = recon.dense(tq, chunk=8192).numpy()
    occ_h = occ_h.numpy()
    assert (occ_h > 0.5).sum() > 100
    np.testing.assert_array_equal(occ_h > 0.5, occ_d > 0.5)
    band = np.abs(occ_d - 0.5) < 0.15
    np.testing.assert_allclose(occ_h[band], occ_d[band], atol=1e-5)
    assert all(int(c) <= b for c, b in zip(counts, (4096, 16384)))


def test_hierarchy_checks_its_config():
    with pytest.raises(ValueError, match="nested"):
        HierarchicalRecon(resolutions=(9, 16), budgets=(0, 10))
    with pytest.raises(ValueError, match="budget"):
        HierarchicalRecon(resolutions=(9, 17), budgets=(0,))


def _peel_volumes():
    _, tq = _queries(_two_spheres)
    vol = tdense.dense_eval(tq, 33, chunk=8192)
    # a volume with empty rays on every side and plateaus of equal values
    rng = np.random.RandomState(2)
    noisy = np.round(rng.rand(17, 17, 17).astype(np.float32) * 4) / 4
    noisy[:, :3] = 0.0
    noisy[:, :, 12:] = 0.25
    return {"two_spheres": vol, "plateaus": torch.from_numpy(noisy)}


@pytest.mark.parametrize("direction", ["front", "back", "left", "right"])
@pytest.mark.parametrize("name", ["two_spheres", "plateaus"])
def test_depth_peel_matches_jax(name, direction):
    vol = _peel_volumes()[name]
    want = jpeel.depth_peel(jnp.asarray(vol.numpy()), direction)
    got = tpeel.depth_peel(vol, direction)
    v = np.asarray(want.valid)
    assert v.any() and not v.all()          # rays with no hit are there
    np.testing.assert_array_equal(got.valid.numpy(), v)
    np.testing.assert_allclose(got.depth.numpy()[v], np.asarray(want.depth)[v],
                               atol=1e-5, rtol=0)
    gn, wn = got.normal.numpy()[v], np.asarray(want.normal)[v]
    np.testing.assert_array_equal(np.isfinite(gn), np.isfinite(wn))
    ok = np.isfinite(wn)
    np.testing.assert_allclose(gn[ok], wn[ok], atol=1e-5, rtol=0)
    # rays with no hit read index 0 in both: the same depth formula, NaN
    # or not
    np.testing.assert_allclose(got.depth.numpy()[~v],
                               np.asarray(want.depth)[~v], atol=1e-5,
                               equal_nan=True)


def test_depth_peel_rejects_an_unknown_direction():
    with pytest.raises(ValueError):
        tpeel.depth_peel(torch.zeros(5, 5, 5), "up")


@pytest.mark.parametrize("window", [None, 40])
def test_ray_refine_matches_jax(window):
    jq, tq = _queries(_sphere)
    kw = dict(resolutions=RES, budgets=(0, 4096, 16384))
    jvol = JRecon(**kw)(jq)
    tvol = HierarchicalRecon(**kw)(tq)
    want = jrr.ray_refine(jq, jvol, 65, taps=6, window=window)
    got = trr.ray_refine(tq, tvol, 65, taps=6, window=window)
    v = np.asarray(want.valid)
    assert v.sum() > 500
    np.testing.assert_array_equal(got.valid.numpy(), v)
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(want.depth),
                               atol=2e-4, rtol=0)
    np.testing.assert_allclose(got.normal.numpy()[v],
                               np.asarray(want.normal)[v], atol=2e-3, rtol=0)

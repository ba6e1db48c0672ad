"""PyTorch port, recon: ray_march, refine_from_maps and ray_pyramid against
the JAX package on an analytic occupancy field (an ellipsoid), through the
per-point, ray-taps and grid query forms; plus shade_normal/visualize.
Depth atol 2e-4 fine voxels, normals 2e-3, silhouettes equal."""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from monoport_tpu_torch.recon import depth_peel as tpeel
from monoport_tpu_torch.recon import ray_refine as trr

# (the JAX recon package re-exports functions named ray_refine and
# depth_peel over the modules of those names)
jrr = importlib.import_module("monoport_tpu.recon.ray_refine")
jpeel = importlib.import_module("monoport_tpu.recon.depth_peel")
torch.set_num_threads(2)
CENTER = np.asarray([0.05, -0.1, 0.02], np.float32)
RADII = np.asarray([0.35, 0.7, 0.3], np.float32)


def _jax_occ(pts):
    d = jnp.linalg.norm((pts - CENTER) / RADII, axis=-1)
    return jax.nn.sigmoid((1.0 - d) * 20.0)[..., None]


def _torch_occ(pts):
    d = torch.linalg.vector_norm((pts - torch.from_numpy(CENTER))
                                 / torch.from_numpy(RADII), dim=-1)
    return torch.sigmoid((1.0 - d) * 20.0)[..., None]


def _torch_taps(xy, z):
    t = z.shape[-1]
    pts = torch.cat([xy[:, :, None].expand(-1, -1, t, 2), z[..., None]], -1)
    return _torch_occ(pts)[..., 0]


def _torch_grid(xw, yw, wz):
    h, w, t = wz.shape
    pts = torch.stack([xw[:, None, None].expand(h, w, t),
                       yw[None, :, None].expand(h, w, t), wz], -1)
    return _torch_occ(pts)[..., 0]


FORMS = {"points": {}, "taps": {"query_taps_fn": _torch_taps},
         "grid": {"query_grid_fn": _torch_grid}}


def _check(got, want, atol_depth=2e-4):
    v = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), v)
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(want.depth),
                               atol=atol_depth, rtol=0)
    np.testing.assert_allclose(got.normal.numpy(), np.asarray(want.normal),
                               atol=2e-3, rtol=0)
    assert v.mean() > 0.1                    # the ellipsoid is hit


@pytest.fixture(scope="module")
def jax_maps():
    """JAX references shared by the query-form cases."""
    return {"march": jrr.ray_march(_jax_occ, 17),
            "pyramid": jrr.ray_pyramid(_jax_occ, 65, levels=(9, 17), taps=4,
                                       window=40)}


@pytest.mark.parametrize("form", sorted(FORMS))
def test_ray_march_matches_jax(form, jax_maps):
    want = jax_maps["march"]
    got = trr.ray_march(_torch_occ, 17, **FORMS[form])
    _check(got, want)


@pytest.mark.parametrize("window", [None, 24, 40])
def test_refine_from_maps_matches_jax(window):
    """Full lattice, a strided window (subject wider than 24 rays) and a
    stride-1 window."""
    coarse_j = jrr.ray_march(_jax_occ, 17)
    coarse_t = trr.ray_march(_torch_occ, 17)
    want = jrr.refine_from_maps(_jax_occ, coarse_j, 17, 65, taps=6,
                                window=window)
    got = trr.refine_from_maps(None, coarse_t, 17, 65, taps=6, window=window,
                               query_grid_fn=_torch_grid)
    _check(got, want)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_ray_pyramid_matches_jax(form, jax_maps):
    want = jax_maps["pyramid"]
    got = trr.ray_pyramid(_torch_occ, 65, levels=(9, 17), taps=4, window=40,
                          **FORMS[form])
    _check(got, want)


def test_shade_and_visualize_match_jax():
    maps_j = jrr.ray_pyramid(_jax_occ, 33, levels=(9, 17), taps=4)
    maps_t = trr.ray_pyramid(_torch_occ, 33, levels=(9, 17), taps=4)
    for size in (32, 50):
        img_j, mask_j = jpeel.visualize(jpeel.shade_normal(maps_j), size)
        img_t, mask_t = tpeel.visualize(tpeel.shade_normal(maps_t), size)
        np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j),
                                   atol=2e-3, rtol=0)
        np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))


def test_compacted_refine_is_a_later_slice():
    """The compacted refine came with the rotated slice: it now runs, and
    equals the JAX package (more cases in tests/test_torch_rotated.py)."""
    coarse_t = trr.ray_march(_torch_occ, 9)
    coarse_j = jrr.ray_march(_jax_occ, 9)
    got = trr.refine_from_maps(_torch_occ, coarse_t, 9, 17, compact=0.5)
    want = jrr.refine_from_maps(_jax_occ, coarse_j, 9, 17, compact=0.5)
    _check(got, want)

"""PyTorch port, mesh extraction: ``marching_tets`` and ``extract_mesh``
against monoport_tpu/recon/marching.py on a sphere and a torus volume (the
same numpy volume to both): valid triangles within 1e-6 in the same order,
mesh counts equal, the welded mesh closed; the ``max_cells`` overflow; and
the OBJ writers."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from monoport_tpu.recon import marching as jmarch
from monoport_tpu.utils import load_obj_mesh_with_color
from monoport_tpu_torch.recon import marching as tmarch
from monoport_tpu_torch.utils import save_obj_mesh, save_obj_mesh_with_color

torch.set_num_threads(2)


def _grid(r):
    a = np.linspace(-1.0, 1.0, r, dtype=np.float32)
    z, y, x = np.meshgrid(a, a, a, indexing="ij")      # vol[z, y, x]
    return x, y, z


def _sigmoid(x):
    return (1.0 / (1.0 + np.exp(-x.astype(np.float64)))).astype(np.float32)


def _sphere(r=33):
    x, y, z = _grid(r)
    return _sigmoid((0.6 - np.sqrt(x * x + y * y + z * z)) * 20.0)


def _torus(r=33):
    x, y, z = _grid(r)
    ring = np.sqrt(x * x + y * y) - 0.55
    return _sigmoid((0.22 - np.sqrt(ring * ring + z * z)) * 20.0)


VOLUMES = {"sphere": _sphere, "torus": _torus}


@pytest.mark.parametrize("name", list(VOLUMES))
def test_marching_tets_matches_jax(name):
    vol = VOLUMES[name]()
    b_min, b_max = (-1.0, -0.9, -0.8), (1.0, 1.1, 0.9)
    want_t, want_v = jmarch.marching_tets(jnp.asarray(vol), 0.5,
                                          max_cells=8192, b_min=b_min,
                                          b_max=b_max)
    got_t, got_v = tmarch.marching_tets(torch.from_numpy(vol), 0.5,
                                        max_cells=8192, b_min=b_min,
                                        b_max=b_max)
    assert got_t.shape == (8192 * 12, 3, 3) and got_v.shape == (8192 * 12,)
    v = np.asarray(want_v)
    assert v.sum() > 500
    np.testing.assert_array_equal(got_v.numpy(), v)
    np.testing.assert_allclose(got_t.numpy()[v], np.asarray(want_t)[v],
                               atol=1e-6, rtol=0)


def _edge_counts(faces):
    edges = np.sort(np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                                    faces[:, [2, 0]]]), axis=1)
    return np.unique(edges, axis=0, return_counts=True)[1]


@pytest.mark.parametrize("name", list(VOLUMES))
def test_extract_mesh_matches_jax_and_is_closed(name):
    vol = VOLUMES[name]()
    jv, jf = jmarch.extract_mesh(jnp.asarray(vol), 0.5, max_cells=8192)
    verts, faces = tmarch.extract_mesh(torch.from_numpy(vol), 0.5,
                                       max_cells=8192)
    assert verts.dtype == np.float32 and faces.dtype == np.int64
    assert verts.shape == jv.shape and faces.shape == jf.shape
    assert len(verts) > 200 and len(faces) > 400
    np.testing.assert_allclose(verts, jv, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(faces, jf)
    # watertight: every edge shared by exactly two triangles
    assert (_edge_counts(faces) == 2).mean() > 0.99


def test_max_cells_overflow_keeps_the_first_cells():
    vol = _sphere()
    want_t, want_v = jmarch.marching_tets(jnp.asarray(vol), 0.5,
                                          max_cells=128)
    got_t, got_v = tmarch.marching_tets(torch.from_numpy(vol), 0.5,
                                        max_cells=128)
    v = np.asarray(want_v)
    assert 0 < v.sum() < 128 * 12
    np.testing.assert_array_equal(got_v.numpy(), v)
    np.testing.assert_allclose(got_t.numpy()[v], np.asarray(want_t)[v],
                               atol=1e-6, rtol=0)
    full = tmarch.marching_tets(torch.from_numpy(vol), 0.5, max_cells=8192)
    assert int(got_v.sum()) < int(full[1].sum())        # a partial surface


def test_extract_mesh_of_an_empty_volume():
    verts, faces = tmarch.extract_mesh(torch.zeros(9, 9, 9))
    assert verts.shape == (0, 3) and faces.shape == (0, 3)


def test_saved_meshes_read_back(tmp_path):
    verts, faces = tmarch.extract_mesh(torch.from_numpy(_sphere(17)), 0.5,
                                       max_cells=4096)
    colors = np.clip(verts * 0.5 + 0.5, 0, 1)
    path = str(tmp_path / "mesh.obj")
    save_obj_mesh_with_color(path, verts, faces, colors)
    v, c, f = load_obj_mesh_with_color(path)
    np.testing.assert_allclose(v, verts, atol=1e-6)
    np.testing.assert_allclose(c, colors, atol=1e-6)
    np.testing.assert_array_equal(f, faces)
    plain = str(tmp_path / "plain.obj")
    save_obj_mesh(plain, verts, faces)
    v2, _, f2 = load_obj_mesh_with_color(plain)
    assert len(v2) == len(verts)
    np.testing.assert_array_equal(f2, faces)

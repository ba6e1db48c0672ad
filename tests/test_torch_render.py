"""PyTorch port, render layer and scene against the JAX package on the CPU:
``rasterize`` and ``sample_texture`` on small scenes (64^2, a few dozen
triangles, perspective w included), the four render passes, the SH
functions, the cameras, the committed floor props, and ``MonoPortScene``
over a few orbit steps and every prop. Tolerances: images and attributes
within 1e-5, masks equal.

``python tests/test_torch_render.py --write`` writes the floor props'
decoded textures, read as the JAX scene reads them (``cv2.imread``), into
``monoport_tpu_torch/data/floor_textures.npz``.
"""

import glob
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

from monoport_tpu.pipeline import scene as jscene  # noqa: E402
from monoport_tpu.render import camera as jcam  # noqa: E402
from monoport_tpu.render import rasterizer as jras  # noqa: E402
from monoport_tpu.render import sh as jsh  # noqa: E402
from monoport_tpu_torch.pipeline import scene as tscene  # noqa: E402
from monoport_tpu_torch.render import camera as tcam  # noqa: E402
from monoport_tpu_torch.render import rasterizer as tras  # noqa: E402
from monoport_tpu_torch.render import sh as tsh  # noqa: E402

torch.set_num_threads(2)
ATOL = 1e-5


def write_floor_textures(path: str = tscene.FLOOR_TEXTURES) -> dict:
    tex = {}
    for obj in sorted(glob.glob(os.path.join(tscene.FLOOR_DIR, "*.obj"))):
        name = os.path.splitext(os.path.basename(obj))[0]
        tex[name] = np.ascontiguousarray(
            jscene.load_floor(obj, obj[:-4] + ".jpg")[2])
    np.savez_compressed(path, **tex)
    return tex


def _scene(seed: int, faces: int = 40, perspective: bool = True):
    rng = np.random.RandomState(seed)
    tris = np.zeros((faces, 3, 4), np.float32)
    tris[..., :3] = rng.uniform(-1.2, 1.2, (faces, 3, 3))
    tris[..., 3] = rng.uniform(0.5, 1.5, (faces, 3)) if perspective else 1.0
    return tris, rng.rand(faces, 3, 5).astype(np.float32)


@pytest.mark.parametrize("seed,chunk", [(0, 64), (1, 16), (2, 7)])
def test_rasterize_matches_jax(seed, chunk):
    tris, attrs = _scene(seed, perspective=seed != 1)
    want = jras.rasterize(jnp.asarray(tris), jnp.asarray(attrs), 64, 48,
                          chunk=chunk)
    got = tras.rasterize(torch.from_numpy(tris), torch.from_numpy(attrs), 64,
                         48, chunk=chunk)
    mask = np.asarray(want[2])
    np.testing.assert_array_equal(got[2].numpy(), mask)
    assert 0.3 < mask.mean() < 1.0
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=ATOL)
    np.testing.assert_allclose(got[1].numpy()[mask],
                               np.asarray(want[1])[mask], atol=ATOL)


def test_rasterize_tie_keeps_the_first_triangle():
    """Two coplanar triangles over the same pixels: the first in the list
    wins within a chunk, and a later chunk must be strictly nearer."""
    tri = np.zeros((1, 3, 4), np.float32)
    tri[0, :, :2] = [[-1, -1], [3, -1], [-1, 3]]
    tri[0, :, 3] = 1.0
    tris = np.concatenate([tri, tri])
    attrs = np.stack([np.full((3, 1), 1.0), np.full((3, 1), 2.0)]).astype(
        np.float32)
    for chunk in (64, 1):
        got = tras.rasterize(torch.from_numpy(tris), torch.from_numpy(attrs),
                             16, 16, chunk=chunk)[0]
        want = jras.rasterize(jnp.asarray(tris), jnp.asarray(attrs), 16, 16,
                              chunk=chunk)[0]
        assert (got.numpy() == 1.0).all()
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sample_texture_matches_jax():
    rng = np.random.RandomState(3)
    tex = rng.rand(16, 12, 3).astype(np.float32)
    uv = rng.uniform(-2.5, 2.5, (200, 2)).astype(np.float32)
    uv[:4] = [[0, 0], [1, 1], [0.5, 1.0], [-1.0, 0.25]]   # wrap edges
    want = jras.sample_texture(jnp.asarray(tex), jnp.asarray(uv))
    got = tras.sample_texture(torch.from_numpy(tex), torch.from_numpy(uv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def _mesh(rng, faces: int = 30):
    verts = rng.uniform(-0.8, 0.8, (faces * 3, 3)).astype(np.float32)
    normals = rng.randn(faces * 3, 3).astype(np.float32)
    uvs = rng.rand(faces * 3, 2).astype(np.float32)
    return verts, normals, uvs


def _uniforms(rng):
    return {"ModelMat": tcam.orbit_extrinsic(20.0, 35.0),
            "PerspMat": tscene.load_intrinsic(),
            "SHCoeffs": rng.randn(9, 3).astype(np.float32) * 0.3}


@pytest.mark.parametrize("kind", ["albedo", "normal", "sh", "prt", "prt_uv"])
def test_render_passes_match_jax(kind):
    rng = np.random.RandomState(4)
    verts, normals, uvs = _mesh(rng)
    tex = (rng.rand(32, 32, 3) * 255).astype(np.uint8)
    uniforms = _uniforms(rng)
    prt = rng.randn(len(verts), 9).astype(np.float32)
    cls = {"albedo": "AlbedoRender", "normal": "NormalRender",
           "sh": "ShRender", "prt": "PrtRender", "prt_uv": "PrtRender"}[kind]
    attribs = {"albedo": [verts, uvs], "normal": [verts, normals],
               "sh": [verts, normals, uvs], "prt": [verts, uvs, prt],
               "prt_uv": [verts, uvs, prt]}[kind]
    name = "TargetTexture" if kind == "albedo" else "AlbedoMap"
    images = []
    for mod, extra in ((jras, {}), (tras, {"device": "cpu"})):
        r = getattr(mod, cls)(width=40, height=32, multi_sample_rate=2,
                              **extra)
        for i, a in enumerate(attribs):
            r.set_attrib(i, a)
        r.set_texture(name, tex)
        if kind == "prt_uv":
            r.draw(uniforms, uv_space=True)
        else:
            r.draw(uniforms)
        images.append(np.asarray(r.get_color()))
    want, got = images
    assert got.shape == want.shape == (32, 40, 3)
    assert (want != 0).any(axis=-1).mean() > 0.1
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_sh_functions_match_jax():
    rng = np.random.RandomState(5)
    dirs = rng.randn(50, 3)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    for fn in ("evaluate_irradiance_basis", "evaluate_sh_basis"):
        want = getattr(jsh, fn)(dirs)
        np.testing.assert_allclose(getattr(tsh, fn)(dirs), want, atol=1e-12)
        np.testing.assert_allclose(
            getattr(tsh, fn)(torch.from_numpy(dirs)).numpy(), want,
            atol=1e-12)
    rot = tcam.make_rotate(0.3, -1.1, 0.7)
    r_sh = tsh.sh_rotation_matrix(rot)
    # two f64 least-squares solvers over the 6-digit basis constants
    np.testing.assert_allclose(r_sh.numpy(), jsh.sh_rotation_matrix(rot),
                               atol=1e-7)
    coeffs = rng.randn(9, 3).astype(np.float32)
    n32 = dirs.astype(np.float32)
    np.testing.assert_allclose(
        tsh.shade_sh(torch.from_numpy(n32), coeffs).numpy(),
        np.asarray(jsh.shade_sh(jnp.asarray(n32), coeffs)), atol=ATOL)


def test_cameras_match_jax():
    for mod_a, mod_b in ((jcam, tcam),):
        for cls in ("BaseCamera", "PerspectiveCamera"):
            a, b = getattr(mod_a, cls)(), getattr(mod_b, cls)()
            for cam in (a, b):
                cam.near, cam.far = 0.1, 50.0
                cam.set_parameters(1.7)
            np.testing.assert_array_equal(a.get_projection_mat(),
                                          b.get_projection_mat())
        a, b = jcam.PerspectiveCamera(), tcam.PerspectiveCamera()
        a.set_by_field_of_view(0.8)
        b.set_by_field_of_view(0.8)
        np.testing.assert_array_equal(a.get_projection_mat(),
                                      b.get_projection_mat())
        a.set_by_35mm_equivalent_focal_length(50.0)
        b.set_by_35mm_equivalent_focal_length(50.0)
        np.testing.assert_array_equal(a.get_projection_mat(),
                                      b.get_projection_mat())
        pose = dict(center=(0.3, 1.0, 2.0), front=(0.1, -0.2, 1.0),
                    up=(0.0, 1.0, 0.1))
        np.testing.assert_array_equal(
            mod_a.CameraPose(**pose).get_model_view_mat(),
            mod_b.CameraPose(**pose).get_model_view_mat())
        np.testing.assert_array_equal(mod_a.orbit_extrinsic(20, 33),
                                      mod_b.orbit_extrinsic(20, 33))


def test_committed_floor_textures_equal_the_jpegs():
    """The port's committed textures are exactly what the JAX scene reads
    from the JPEGs (cv2.imread, BGR -> RGB)."""
    tex = tscene.floor_textures()
    objs = sorted(glob.glob(os.path.join(tscene.FLOOR_DIR, "*.obj")))
    assert len(objs) == len(tex) == 5
    for obj in objs:
        name = os.path.splitext(os.path.basename(obj))[0]
        want = jscene.load_floor(obj, obj[:-4] + ".jpg")[2]
        assert tex[name].dtype == np.uint8
        np.testing.assert_array_equal(tex[name], want)


def test_scene_renders_match_jax():
    """A few orbit steps of the default floor, then every prop through
    shift_floor: the port's scene renders the JAX scene's images."""
    want_scene = jscene.MonoPortScene(size=(64, 48))
    got_scene = tscene.MonoPortScene(size=(64, 48), device="cpu")
    assert got_scene.prop_sets == want_scene.prop_sets
    np.testing.assert_array_equal(got_scene.intrinsic, want_scene.intrinsic)
    for step in range(8):
        if step >= 3:
            want_scene.shift_floor()
            got_scene.shift_floor()
        ext_w, intr = want_scene.update_camera()
        ext_g, _ = got_scene.update_camera()
        np.testing.assert_array_equal(ext_g, ext_w)
        want = np.asarray(want_scene.render(ext_w, intr))
        got = got_scene.render(ext_g, intr)
        assert isinstance(got, torch.Tensor) and got.shape == (48, 64, 3)
        assert (want.sum(-1) > 0.01).mean() > 0.1
        np.testing.assert_array_equal(got.numpy() != 0, want != 0)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_scene_needs_cuda_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tscene.MonoPortScene(size=(16, 16))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tras.AlbedoRender(16, 16)


if __name__ == "__main__":
    if sys.argv[1:2] != ["--write"]:
        sys.exit("usage: python tests/test_torch_render.py --write")
    print({k: v.shape for k, v in write_floor_textures().items()})

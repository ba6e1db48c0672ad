"""PyTorch port, the small utilities against monoport_tpu: ``EngineCfg.flat``
knob by knob against the JAX package's mapping, ``utils/compile_cache``'s
directory priority, ``utils/plot.plot_mask3D`` and
``utils/objloader_native`` against the port's own OBJ reader and the JAX
package's binding on the repository's OBJ files."""

import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from monoport_tpu.engine import EngineCfg as JaxEngineCfg
from monoport_tpu_torch import engine
from monoport_tpu_torch.engine import EngineCfg
from monoport_tpu_torch.ops.cuda import build
from monoport_tpu_torch.utils import compile_cache, objloader_native
from monoport_tpu_torch.utils.mesh import load_obj_mesh, save_obj_mesh

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
OBJ_FILES = sorted(glob.glob(os.path.join(ROOT, "monoport_tpu", "data",
                                          "**", "*.obj"), recursive=True))

# a value off the default for every knob the port maps
KNOBS = {"render_size": 128, "direction": "back", "mode": "ray",
         "fine_res": 129, "ray_taps": 4, "ray_window": 96,
         "march_levels": (17, 33), "march_rotated": False,
         "compact_rotated": 0.375, "rot_anchors": 3,
         "rot_anchor_texels": 2.0}
# a value other than the port's one, for every knob it takes at one value
OTHER = {"use_pallas": False, "pallas_interpret": True,
         "use_ray_query": False, "tex_bf16": True,
         "tex_reuse_compact": False, "tex_stride": 2,
         "tex_pallas_head": True}


def _value(cfg, name, table):
    where = table[name]
    return getattr(cfg, name) if where is None else getattr(
        getattr(cfg, where[0]), where[1])


def _only(name, value):
    """The port's default config with just the knob ``name`` changed."""
    where, base = engine._FLAT[name], EngineCfg()
    if where is None:
        return dataclasses.replace(base, **{name: value})
    group = dataclasses.replace(getattr(base, where[0]), **{where[1]: value})
    return dataclasses.replace(base, **{where[0]: group})


def test_flat_knobs_match_jax():
    assert set(engine._FLAT) | set(engine._FIXED_KNOBS) == set(
        JaxEngineCfg._FLAT)
    assert not set(engine._FLAT) & set(engine._FIXED_KNOBS)
    for name, where in engine._FLAT.items():
        assert JaxEngineCfg._FLAT[name] == where, name
    assert set(KNOBS) | {"compute_dtype"} == set(engine._FLAT)
    assert set(OTHER) == set(engine._FIXED_KNOBS)
    for name, value in KNOBS.items():
        got = EngineCfg.flat(**{name: value})
        want = JaxEngineCfg.flat(**{name: value})
        assert _value(got, name, engine._FLAT) == value, name
        assert _value(want, name, JaxEngineCfg._FLAT) == value, name
        assert got == _only(name, value), name       # nothing else moved
    # all at once, as the JAX package's rtl_main passes them
    both = EngineCfg.flat(**KNOBS, compute_dtype=torch.bfloat16,
                          use_pallas=True, pallas_interpret=False)
    jboth = JaxEngineCfg.flat(**KNOBS, compute_dtype=jnp.bfloat16,
                              use_pallas=True, pallas_interpret=False)
    assert both.compute_dtype == torch.bfloat16
    for group in ("ray", "rotated"):
        # JAX's group is the port's plus its fixed knobs at their one value
        fixed = {JaxEngineCfg._FLAT[n][1]: v
                 for n, v in engine._FIXED_KNOBS.items()
                 if (JaxEngineCfg._FLAT[n] or (None,))[0] == group}
        assert dataclasses.asdict(getattr(jboth, group)) == {
            **dataclasses.asdict(getattr(both, group)), **fixed}, group
    assert (both.render_size, both.direction) == (jboth.render_size,
                                                  jboth.direction)
    assert EngineCfg.flat() == EngineCfg()


@pytest.mark.parametrize("name", sorted(OTHER) + ["no_such_knob"])
def test_flat_refuses_what_the_port_does_not_do(name):
    """A knob the port takes at one value: that value is JAX's default
    (``use_pallas`` aside: JAX's default is its XLA route, and the port's
    kernels always run) and builds the default config; any other raises,
    naming the knob and the one value. An unknown name raises KeyError."""
    if name == "no_such_knob":
        with pytest.raises(KeyError):
            EngineCfg.flat(no_such_knob=1)
        return
    value = engine._FIXED_KNOBS[name]
    jax_default = _value(JaxEngineCfg(), name, JaxEngineCfg._FLAT)
    if name == "use_pallas":
        assert (jax_default, value) == (False, True)
    else:
        assert jax_default == value, name
    assert EngineCfg.flat(**{name: value}) == EngineCfg()
    with pytest.raises(ValueError,
                       match=f"{name}={OTHER[name]!r}: .*{name}={value!r}"):
        EngineCfg.flat(**{name: OTHER[name]})


def test_compile_cache_directory_priority(tmp_path, monkeypatch):
    """The explicit directory, else DEFAULT_DIR (the package's _build/);
    the kernels' libraries and the OBJ parser's follow it."""
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    package_build = os.path.abspath(os.path.join(
        os.path.dirname(build.__file__), os.pardir, os.pardir, "_build"))
    assert compile_cache.DEFAULT_DIR == package_build
    assert compile_cache.enable(str(tmp_path)) == str(tmp_path)
    assert build.BUILD_DIR == str(tmp_path)
    assert os.path.dirname(build.library_path("fused_mlp")) == str(tmp_path)
    assert os.path.dirname(objloader_native.library_path()) == str(tmp_path)
    assert compile_cache.enable() == package_build == build.BUILD_DIR


def test_plot_mask3d(tmp_path):
    pytest.importorskip("matplotlib")
    from monoport_tpu_torch.utils.plot import plot_mask3D

    mask = torch.zeros(1, 1, 8, 8, 8)
    mask[..., 2:5, 3:6, 1:4] = 1.0
    path = str(tmp_path / "m.png")
    assert plot_mask3D(mask, "cube", save_path=path) == path
    assert os.path.getsize(path) > 0
    fig = plot_mask3D(np.random.RandomState(0).rand(6, 6, 6), point_limit=10)
    assert len(fig.axes[0].collections[0].get_offsets()) == 10


@pytest.mark.parametrize("path", OBJ_FILES,
                         ids=[os.path.basename(p) for p in OBJ_FILES])
def test_native_objloader_matches_readers(path):
    """The repository's OBJ files: the native parse equals the port's
    Python reader and the JAX package's binding."""
    from monoport_tpu.utils.objloader_native import load_obj_fast as jfast

    assert objloader_native.available(), "g++ should build the parser here"
    v, f = objloader_native.load_obj_fast(path)
    v_py, f_py = load_obj_mesh(path)
    assert v.dtype == np.float32 and f.dtype == np.int64
    np.testing.assert_allclose(v, v_py, atol=1e-6)
    np.testing.assert_array_equal(f, f_py)
    v_j, f_j = jfast(path)
    np.testing.assert_array_equal(v, v_j)
    np.testing.assert_array_equal(f, f_j)
    np.testing.assert_array_equal(objloader_native.load_obj_verts(path), v)


def test_native_objloader_quads_negatives_and_fallback(tmp_path,
                                                       monkeypatch):
    path = str(tmp_path / "q.obj")
    with open(path, "w") as f:
        f.write("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
                "f 1/1/1 2/2/2 3/3/3 4/4/4\nf -4 -3 -2\n")
    want = [[0, 1, 2], [0, 2, 3], [0, 1, 2]]
    v, faces = objloader_native.load_obj_fast(path)
    assert v.shape == (4, 3)
    np.testing.assert_array_equal(faces, want)
    with pytest.raises(FileNotFoundError):
        objloader_native.load_obj_fast(str(tmp_path / "missing.obj"))
    rng = np.random.RandomState(0)
    big = str(tmp_path / "big.obj")
    save_obj_mesh(big, rng.randn(500, 3).astype(np.float32),
                  rng.randint(0, 500, (900, 3)))
    native = objloader_native.load_obj_fast(big)
    # without a compiler the pure-Python parse answers
    monkeypatch.setattr(objloader_native, "_lib", None)
    monkeypatch.setattr(objloader_native, "_build_failed", True)
    assert not objloader_native.available()
    v, faces = objloader_native.load_obj_fast(path)
    np.testing.assert_array_equal(faces, want)
    py = objloader_native.load_obj_fast(big)
    np.testing.assert_allclose(py[0], native[0], atol=1e-6)
    np.testing.assert_array_equal(py[1], native[1])

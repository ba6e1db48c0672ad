"""PyTorch port, the last two scripts: ``apps/convert_model`` (a reference
checkpoint -> the port's npz, where ``scripts/convert_model.py`` writes
orbax) and ``apps/make_floor_prop`` (the five floor props).

convert_model: the committed netG and netC written as reference files
(``tests/torch_reference_state.py``: legacy PIFu ``convN`` and Trainer
``net`` layouts) convert to npz files whose tensors are bit-equal to the
committed ``monoport_tpu/data/net{g,c}_capsule.npz`` and equal to what the
JAX package's ``load_legacy_pifu`` reads from the same file.
make_floor_prop: each texture is bit-equal to the JAX script's function of
the same name (the script imported by path), each OBJ byte-equal to the
committed one, each JPEG the port's encoder's at quality 85 (decoded within
a few levels of the drawing), and nothing is written under the JAX
package."""

import importlib.util
import io
import os

import numpy as np
import pytest
import torch

from monoport_tpu.convert import load_legacy_pifu as jax_load_legacy_pifu
from monoport_tpu_torch.apps import convert_model, make_floor_prop
from monoport_tpu_torch.weights import DATA, load_default_networks
from torch_reference_state import reference_state

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
FLOOR = os.path.join(ROOT, "monoport_tpu", "data", "floor")


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


@pytest.fixture(scope="module")
def committed():
    return dict(zip(("netG", "netC"), load_default_networks(device="cpu")))


@pytest.mark.parametrize("legacy", [True, False], ids=["convN", "trainer"])
@pytest.mark.parametrize("key", ["netG", "netC"])
def test_convert_model_gives_the_committed_npz(tmp_path, committed, key,
                                               legacy):
    net = committed[key]
    imf = net.opt_net.backbone.IMF
    src = str(tmp_path / f"{key}.pth")
    ref = reference_state(net.state_dict(), imf, legacy=legacy)
    torch.save(ref if legacy else {"net": ref, "epoch": 3}, src)
    dst = str(tmp_path / f"{key}.npz")
    res = convert_model.main([src, dst, "--backbone", imf])
    assert res["running_stats"] == 0
    got = np.load(dst)
    with np.load(os.path.join(DATA, f"{key.lower()}_capsule.npz")) as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype == np.float16, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    jax_params = dict(_flat(jax_load_legacy_pifu(src, imf)["params"]))
    assert sorted(jax_params) == sorted(got.files)
    for k, v in jax_params.items():
        np.testing.assert_array_equal(got[k].astype(np.float32), v,
                                      err_msg=k)
    assert res["weights"] == sum(got[k].size for k in got.files)


def test_convert_model_counts_the_batchnorm_stats_it_drops(tmp_path):
    """A BatchNorm net's running statistics are not parameters: the npz
    leaves them out, as the JAX package's npz format does, and says so."""
    from monoport_tpu_torch.config import CN
    from monoport_tpu_torch.models import MonoPortNet
    from torch_reference_state import alt_netg_opts, seeded_state

    opts = CN(alt_netg_opts("Yolov4Filters"))
    opts.backbone.IMF = "PIFuHGFilters"
    opts.backbone.num_stack = 1
    opts.backbone.num_hourglass = 1
    opts.backbone.hourglass_dim = 32
    net = MonoPortNet(opts, head_channels=(33, 64, 1))
    state = seeded_state(net, 3)
    src = str(tmp_path / "bn.pth")
    torch.save(reference_state(state, "PIFuHGFilters"), src)
    res = convert_model.main([src, str(tmp_path / "bn.npz")])
    stats = [k for k in state if "running" in k or "num_batches" in k]
    assert stats and res["running_stats"] == len(stats)


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "make_floor_prop_script",
        os.path.join(ROOT, "scripts", "make_floor_prop.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_floor_textures_equal_the_jax_script():
    script = _jax_script()
    assert list(script.SETS) == list(make_floor_prop.SETS)
    for name, (tex_fn, _) in make_floor_prop.SETS.items():
        got, want = tex_fn(), script.SETS[name][0]()
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_make_floor_prop_writes_the_committed_objs(tmp_path):
    from PIL import Image

    out = tmp_path / "floor"
    written = make_floor_prop.main(["--out", str(out)])
    assert len(written) == 10
    for name, (tex_fn, _) in make_floor_prop.SETS.items():
        with open(out / f"{name}.obj", "rb") as f, \
                open(os.path.join(FLOOR, f"{name}.obj"), "rb") as g:
            assert f.read() == g.read(), name
        data = (out / f"{name}.jpg").read_bytes()
        assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"
        img = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"),
                         np.float32)
        err = np.abs(img - tex_fn().astype(np.float32))
        assert img.shape == (512, 512, 3) and err.mean() < 4.0, (
            name, err.mean())


def test_make_floor_prop_never_writes_under_the_jax_package(tmp_path):
    before = sorted(os.listdir(FLOOR))
    for out in (FLOOR, os.path.join(ROOT, "monoport_tpu", "data", "new")):
        with pytest.raises(SystemExit):
            make_floor_prop.main(["--out", out])
    assert sorted(os.listdir(FLOOR)) == before
    assert not os.path.exists(os.path.join(ROOT, "monoport_tpu", "data",
                                           "new"))

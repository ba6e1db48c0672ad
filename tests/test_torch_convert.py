"""PyTorch port, checkpoint converter: reference-layout state dicts (built
by the key-inverse helper ``torch_reference_state`` from numpy-seeded
weights) through the port's ``convert`` and through the JAX package's
``monoport_tpu.convert`` + ``weights.torch_state_from_flax``: the two
results are bit-equal, for each of the four key maps, the legacy ``convN``
head and the Trainer ``net`` dict, ``load_darknet_conv137`` (file key names
ignored, with and without ``num_batches_tracked``) and
``merge_backbone_pretrained``. Then ``load_legacy_pifu`` end to end: the
port's net from a saved file against the JAX net from the JAX loader on
the same file (f32, atol 1e-4); the committed capsule nets through
``rtl_main.load_networks`` as legacy files, bit-equal to the committed
ones; and a small frontal engine frame of a multi-level HRNet netG (head
input 271) loaded from a legacy file, against the JAX engine (depth 2e-4,
``render_norm`` 2e-3, as tests/test_torch_engine.py)."""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import monoport_tpu.convert as jconv
from monoport_tpu.config import CN as JCN
from monoport_tpu.engine import EngineCfg as JaxEngineCfg
from monoport_tpu.engine import ReconEngine as JaxEngine
from monoport_tpu.models import MonoPortNet as JaxNet
from monoport_tpu.recon.hierarchy import HierarchicalRecon as JaxRecon
from monoport_tpu_torch import convert, weights
from monoport_tpu_torch.apps import rtl_main
from monoport_tpu_torch.config import CN
from monoport_tpu_torch.engine import EngineCfg, RayCfg, ReconEngine
from monoport_tpu_torch.models import MonoPortNet
from monoport_tpu_torch.models.backbones import BACKBONES
from monoport_tpu_torch.recon.hierarchy import HierarchicalRecon

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_reference_state import (  # noqa: E402
    COUNTER, flax_variables, reference_backbone_state, reference_state,
    seeded_state)

torch.set_num_threads(2)
HG_SMALL = {"IMF": "PIFuHGFilters", "num_stack": 2, "num_hourglass": 1,
            "hourglass_dim": 32, "norm": "batch", "hg_down": "ave_pool"}


def _bridge(variables) -> dict:
    return weights.torch_state_from_flax(variables)


def _assert_bit_equal(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


# (registry name, backbone options) for each of the four key maps
MAPS = [("PIFuHGFilters", HG_SMALL),
        ("PIFuResBlkFilters", {}),
        ("HRNetV2_W18_small_v2", {"norm": "batch"}),
        ("HRNetV2_W18_small_v2_balance_last", {"norm": "batch"}),
        ("Yolov4Filters", {"norm": "batch"})]


@pytest.mark.parametrize("imf,opts", MAPS, ids=[m[0] for m in MAPS])
def test_backbone_converter_matches_the_jax_bridge(imf, opts):
    net = BACKBONES[imf](CN(opts))
    state = seeded_state(net, 5)
    ref = reference_backbone_state(state, imf)
    got = convert.convert_backbone_state(ref, imf)
    params, stats = jconv.convert_backbone_state(ref, imf, with_stats=True)
    _assert_bit_equal(got, _bridge({"params": params, "batch_stats": stats}))
    _assert_bit_equal(got, state)            # the round trip
    net.load_state_dict(got, strict=True)
    if imf == "PIFuHGFilters":               # bn4 is saved twice
        assert "conv2.downsample.0.running_var" in ref
    if opts.get("norm") == "batch":
        assert any(v.item() == COUNTER for k, v in ref.items()
                   if k.endswith("num_batches_tracked"))


def _small_g(imf: str = "PIFuHGFilters", backbone=HG_SMALL) -> dict:
    return {"projection": "orthogonal", "backbone": dict(backbone, IMF=imf),
            "normalizer": {"IMF": "PIFuNomalizer"},
            "head": {"IMF": "PIFuNetGMLP"}, "loss": {"IMF": "MSE"}}


def _small_net(opts: dict, c_in: int, seed: int = 9):
    net = MonoPortNet(CN(opts), head_channels=(c_in, 1024, 512, 256, 128, 1))
    return net, seeded_state(net, seed)


@pytest.mark.parametrize("legacy", [True, False], ids=["convN", "trainer"])
def test_monoport_converter_matches_the_jax_bridge(legacy):
    _, state = _small_net(_small_g(), 33)
    ref = reference_state(state, "PIFuHGFilters", legacy=legacy)
    w0 = "surface_classifier." + ("conv0" if legacy else "filters.0")
    assert ref[w0 + ".weight"].dim() == 3            # Conv1d [O, I, 1]
    got = convert.convert_monoport_state(ref, "PIFuHGFilters",
                                         legacy_pifu=legacy)
    want = _bridge(jconv.convert_monoport_state(ref, "PIFuHGFilters",
                                                legacy_pifu=legacy))
    _assert_bit_equal(got, want)
    _assert_bit_equal(got, state)


@pytest.fixture(scope="module")
def yolo(tmp_path_factory):
    """The Yolov4 backbone's seeded state, and darknet conv.137 files of it
    (down1..down5 + neek in registration order, under arbitrary key names),
    with and without the counters."""
    net = BACKBONES["Yolov4Filters"](CN({"norm": "batch"}))
    state = seeded_state(net, 6)
    order = convert.torch_loader._yolo_conv137_key_order()
    files = {}
    for counters in (True, False):
        ref = reference_backbone_state(state, "Yolov4Filters", counters)
        keys = [k for k in order if k in ref]
        path = tmp_path_factory.mktemp("darknet") / "yolov4.conv.137.pth"
        torch.save({f"w{i:04d}": ref[k] for i, k in enumerate(keys)}, path)
        files[counters] = str(path)
    return state, files


@pytest.mark.parametrize("counters", [True, False],
                         ids=["with_counters", "without_counters"])
def test_load_darknet_conv137_matches_the_jax_bridge(yolo, counters):
    state, files = yolo
    got = convert.load_darknet_conv137(files[counters])
    params, stats = jconv.load_darknet_conv137(files[counters])
    _assert_bit_equal(got, _bridge({"params": params, "batch_stats": stats}))
    # the positional zip reaches every backbone and neck tensor, no head
    assert sorted(got) == sorted(k for k in state if not k.startswith("head"))
    for k, v in got.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, state[k]), k


def test_merge_backbone_pretrained_matches_the_jax_bridge(yolo):
    state, files = yolo
    backbone = convert.load_darknet_conv137(files[True])
    base = {f"image_filter.{k}": torch.zeros_like(v)
            for k, v in state.items()}
    base["surface_classifier.filters_0.weight"] = torch.ones(4, 257)
    got = convert.merge_backbone_pretrained(base, backbone)
    params, stats = jconv.load_darknet_conv137(files[True])
    want = _bridge(jconv.merge_backbone_pretrained(
        flax_variables(base), params, stats))
    _assert_bit_equal(got, want)
    assert torch.equal(got["image_filter.head.conv2.conv.bias"],
                       base["image_filter.head.conv2.conv.bias"])
    assert torch.equal(got["image_filter.down1.conv1.conv.weight"],
                       state["down1.conv1.conv.weight"])


def _query_inputs():
    rng = np.random.RandomState(4)
    return (rng.rand(1, 64, 64, 3).astype(np.float32),
            rng.uniform(-1, 1, (1, 256, 3)).astype(np.float32),
            np.eye(4, dtype=np.float32)[None])


@pytest.mark.parametrize("legacy", [True, False], ids=["convN", "trainer"])
def test_load_legacy_pifu_end_to_end(tmp_path, legacy):
    """A saved reference checkpoint -> the port's net and the JAX net, each
    through its package's ``load_legacy_pifu``: the same queries."""
    opts = _small_g()
    _, state = _small_net(opts, 33)
    ref = reference_state(state, "PIFuHGFilters", legacy=legacy)
    path = tmp_path / "net_G"
    torch.save(ref if legacy else {"net": ref, "epoch": 3}, path)
    net = weights.build_net(CN(opts), convert.load_legacy_pifu(
        str(path), "PIFuHGFilters"), device="cpu")
    image, points, calib = _query_inputs()
    with torch.no_grad():
        got = net.query(net.filter(torch.from_numpy(image)),
                        torch.from_numpy(points), torch.from_numpy(calib))[0]
    variables = jconv.load_legacy_pifu(str(path), "PIFuHGFilters")
    want = JaxNet(JCN(opts)).apply(variables, jnp.asarray(image),
                                   jnp.asarray(points), jnp.asarray(calib))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    assert 0.05 < float(np.asarray(want).std())


class _Opt:
    """Stands in for a Trainer checkpoint's yacs ``opt``."""


def test_load_refuses_arbitrary_pickles(tmp_path):
    _, state = _small_net(_small_g(), 33)
    path = tmp_path / "trainer.pth"
    torch.save({"net": reference_state(state, "PIFuHGFilters", False),
                "opt": _Opt()}, path)
    with pytest.raises(ValueError, match="weights_only"):
        convert.load_legacy_pifu(str(path), "PIFuHGFilters")


def test_committed_nets_load_as_legacy_checkpoints(tmp_path):
    """The committed capsule netG and netC written as legacy PIFu files
    (reference key names, the HG's ``downsample.0`` duplicate of bn4) load
    through ``load_networks`` bit-equal to ``load_default_networks``."""
    default = weights.load_default_networks(device="cpu")
    opts = []
    for key, net in zip(("netG", "netC"), default):
        imf = net.opt_net.backbone.IMF
        path = tmp_path / f"{key}.pth"
        torch.save(reference_state(net.state_dict(), imf), path)
        opts += [f"{key}.ckpt_path", str(path)]
    _, cfg = rtl_main.parse_args(["--camera", "--"] + opts)
    loaded = rtl_main.load_networks(cfg, device="cpu")
    for a, b in zip(loaded, default):
        _assert_bit_equal(a.state_dict(), b.state_dict())


def test_hrnet_frame_from_legacy_checkpoint_matches_jax_engine(tmp_path):
    """The multi-level HRNet netG (BatchNorm; four levels, 270 feature
    channels + z) from a legacy file through ``load_networks`` and the
    port's small frontal frame, against the JAX engine on the JAX loader's
    variables of the same file. No netC, as the app loads none for it."""
    imf = "HRNetV2_W18_small_v2"
    opts = _small_g(imf, {"norm": "batch"})
    net, state = _small_net(opts, 271)
    rng = np.random.RandomState(1)
    image = rng.rand(1, 64, 64, 3).astype(np.float32)
    calib = np.eye(4, dtype=np.float32)[None]
    # centre the random head's logits on the surface level over the volume,
    # so that a good share of the rays cross it
    net.load_state_dict(state)
    net.surface_classifier.last_op = None
    grid = np.stack(np.meshgrid(*[np.linspace(-1, 1, 9)] * 3), -1)
    with torch.no_grad():
        logits = net.query(net.eval().filter(torch.from_numpy(image)),
                           torch.from_numpy(grid.reshape(1, -1, 3)
                                            .astype(np.float32)))[0]
    state["surface_classifier.filters_4.bias"] -= logits.median()
    path = tmp_path / "net_G"
    torch.save(reference_state(state, imf), path)
    _, cfg = rtl_main.parse_args(
        ["--camera", "--", "netG.backbone.IMF", imf, "netG.backbone.norm",
         "batch", "netG.ckpt_path", str(path)])
    netG, netC = rtl_main.load_networks(cfg, device="cpu")
    assert netC is None
    assert netG.surface_classifier.filter_channels[0] == 271
    small = dict(render_size=32, fine_res=33, ray_taps=4,
                 march_levels=(9, 17), ray_window=24)
    jeng = JaxEngine(JaxNet(JCN(opts)), None,
                     recon=JaxRecon(resolutions=(9, 17), budgets=(0, 2048)),
                     config=JaxEngineCfg.flat(mode="ray", **small))
    want = jeng.frame(jconv.load_legacy_pifu(str(path), imf),
                      jnp.asarray(image), None, None, jnp.asarray(calib))
    eng = ReconEngine(
        netG, None, recon=HierarchicalRecon(resolutions=(9, 17),
                                            budgets=(0, 2048)),
        config=EngineCfg(render_size=32, ray=RayCfg(
            mode="ray", fine_res=33, taps=4, window=24,
            march_levels=(9, 17))), device="cpu")
    got = eng.frame(torch.from_numpy(image), None, calib)
    assert set(got) == {"depth", "valid", "render_norm", "mask"}
    va, vb = got["valid"].numpy(), np.asarray(want["valid"])
    assert (va != vb).mean() < 0.005 and 0.05 < vb.mean() < 0.95, vb.mean()
    for key, atol in (("depth", 2e-4), ("render_norm", 2e-3)):
        a = got[key].numpy().astype(np.float64)
        b = np.asarray(want[key], np.float64)
        assert np.isfinite(a).all(), key
        assert (np.abs(a - b) > atol).mean() < 0.005, key

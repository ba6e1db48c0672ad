"""PyTorch port, the ``Yolov4Filters`` netG (CSPDarknet53 + SPP + PAN)
held to the benchmark's plain reference (``cardbench.reference``: plain
f32 PyTorch, imports nothing of the port) on the CPU, on weights seeded
by ``cardbench.harness.weights.seeded_state`` with BatchNorm statistics
fitted to the images, as the benchmark's ``monoport-yolov4``
configuration (``cardbench/configs/monoport-yolov4.json``) has them. The
port's nets and engine are built with the port's own loader
(``weights.build_net`` over ``get_cfg_defaults().netG``).

Held: one seeded state loads strictly into the port's backbone, the
reference's ``build(spec)`` and both whole nets; the three stages agree
at 64^2 and 128^2; a small frontal frame of ``ReconEngine`` agrees with
the reference frame; the reference's convolutions at 512^2; and the
``backbone.*`` spans' ``imf`` / ``stage`` attributes."""

import copy
import json
import os

import numpy as np
import pytest
import torch

from cardbench.harness import weights, work
from cardbench.reference import nets as ref_nets
from cardbench.reference.frame import load_nets, reference_frame
from monoport_tpu_torch.config import CN, get_cfg_defaults
from monoport_tpu_torch.engine import EngineCfg, RayCfg, ReconEngine
from monoport_tpu_torch.frame_check import rtl_config
from monoport_tpu_torch.models.backbones import Yolov4Filters
from monoport_tpu_torch.utils import profiling
from monoport_tpu_torch.weights import build_net

torch.set_num_threads(2)

SEED = 4_200_000_029
PREFIX = "image_filter."


CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "cardbench", "configs")
# the small frontal profile: 64^2 images, a 257-32-16-1 head, fine 33
SMALL = dict(fine_res=33, window=24, march_levels=[9, 17], render_size=32)


def _config(name: str) -> dict:
    with open(os.path.join(CONFIGS, f"{name}.json")) as f:
        return json.load(f)


def _images(n: int, size: int, seed: int) -> torch.Tensor:
    return torch.rand(n, size, size, 3,
                      generator=torch.Generator().manual_seed(seed)) * 2 - 1


def _port_net(spec: dict, state: dict):
    opt = get_cfg_defaults().netG.clone()
    opt.backbone = CN(spec["backbone"])
    return build_net(opt, state, "cpu")


@pytest.fixture(scope="module")
def spec():
    return _config("monoport-yolov4")["netG"]


@pytest.fixture(scope="module")
def state(spec):
    """The configuration's seeded netG, its BatchNorm statistics fitted to
    four images at 64^2."""
    recipe = _config("monoport-yolov4")["weights"]
    st = weights.seeded_state(spec, recipe, SEED, "cpu")
    weights.fit_norm_stats(spec, st, _images(4, 64, 7))
    return st


def _backbone_state(state):
    return {k[len(PREFIX):]: v for k, v in state.items()
            if k.startswith(PREFIX)}


def test_one_state_loads_strictly_into_both(spec, state):
    port = Yolov4Filters(CN(spec["backbone"]))
    port.load_state_dict(_backbone_state(state), strict=True)
    ref = ref_nets.backbone(spec["backbone"])
    ref.load_state_dict(_backbone_state(state), strict=True)
    ref_nets.ImplicitNet(spec).load_state_dict(state, strict=True)
    net = _port_net(spec, state)
    assert sum(isinstance(m, torch.nn.BatchNorm2d)
               for m in port.modules()) == 107
    assert set(net.state_dict()) == set(state)


@pytest.mark.parametrize("size", [64, 128])
def test_stages_agree(spec, state, size):
    """Both run the same layers in the same order in f32 on the same
    weights; a convolution's CPU algorithm follows its memory layout and
    thread count and may sum in another order (~1e-7 a layer, through up
    to 72 layers in series), hence 1e-5 of each map's largest value."""
    port = Yolov4Filters(CN(spec["backbone"])).eval()
    port.load_state_dict(_backbone_state(state), strict=True)
    ref = ref_nets.backbone(spec["backbone"]).eval()
    ref.load_state_dict(_backbone_state(state), strict=True)
    image = _images(1, size, size)
    with torch.no_grad():
        got, want = port(image), ref(image)
    assert len(got) == len(want) == 3
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w) == 1
        stride = 8 * 2 ** i
        assert w[0].shape == (1, size // stride, size // stride, 256)
        torch.testing.assert_close(g[0], w[0], rtol=1e-5,
                                   atol=1e-5 * float(w[0].abs().max()))


def _small(name: str, head: list) -> dict:
    """A configuration at 64^2 with ``head`` widths and the small frontal
    profile, its head's last layer unscaled, f32."""
    c = copy.deepcopy(_config(name))
    c["image_size"] = 64
    c["netG"]["head"]["widths"] = head
    c["weights"] = dict(c["weights"], head={"last_scale": 1.0,
                                            "last_z_weight": -8.0})
    c["profile"].update(SMALL, compute_dtype="float32")
    return c


def _small_engine(config: dict, images: torch.Tensor):
    """(the port's engine, the netG state) of a small configuration: the
    seeded netG, statistics fitted to ``images``, the real-time
    operating point of ``frame_check.rtl_config`` in f32 at the small
    profile's lattice."""
    spec = config["netG"]
    st = weights.seeded_state(spec, config["weights"], SEED, "cpu")
    weights.fit_norm_stats(spec, st, images)
    p = config["profile"]
    recon, _ = rtl_config(torch.float32)
    cfg = EngineCfg(render_size=p["render_size"], compute_dtype=torch.float32,
                    ray=RayCfg(mode="ray", fine_res=p["fine_res"],
                               taps=p["taps"], window=p["window"],
                               march_levels=tuple(p["march_levels"])))
    eng = ReconEngine(_port_net(spec, st), None, recon=recon, config=cfg,
                      device="cpu")
    return eng, st


@pytest.fixture(scope="module")
def small():
    """``monoport-yolov4`` at 64^2 (a 257-32-16-1 head, fine 33) on three
    images: (config, images, the port's engine, the reference frame)."""
    config = _small("monoport-yolov4", [257, 32, 16, 1])
    images = _images(3, 64, 11)
    eng, st = _small_engine(config, images)
    ref = reference_frame(config, load_nets(config, {"netG": st}, "cpu"))
    return config, images, eng, ref


def test_small_frontal_frame_agrees(small):
    _, images, eng, ref = small
    calib = np.eye(4, dtype=np.float32)[None]
    with torch.inference_mode():
        for i in range(3):
            got = eng.frame(images[i:i + 1], None, calib)
            want = ref(images[i:i + 1], None, calib, None)
            v = want["valid"]
            assert 0.01 < float(v.float().mean())
            assert torch.equal(got["valid"], v)
            assert float((got["depth"] - want["depth"])[v].abs().max()) < 1e-3
            assert float((got["render_norm"]
                          - want["render_norm"]).abs().max()) < 1e-3


def test_reference_work_at_512(spec):
    net = ref_nets.backbone(spec["backbone"])
    assert sum(isinstance(m, torch.nn.Conv2d) for m in net.modules()) == 110
    assert work.backbone_flops(spec["backbone"], 512) / 1e9 == \
        pytest.approx(91.0, abs=0.05)


def _backbone_spans(engine, image):
    with profiling.recording() as rec, torch.inference_mode():
        engine.frame(image, None)
    return [(s.name, s.attrs) for s in rec.spans
            if s.name.startswith("backbone.")]


def test_span_names_the_backbone_and_its_queried_stage(small):
    """Yolov4: the stride-32 map alone (out0 and out1 are unread)."""
    _, images, eng, _ = small
    assert _backbone_spans(eng, images[:1]) == [
        ("backbone.netG", {"graph": "eager", "imf": "Yolov4Filters",
                           "stage": [[2, 2, 256]]})]


def test_span_lists_every_map_of_a_multi_level_stage():
    config = _small("monoport-hrnet-w18-small-v2", [271, 32, 16, 1])
    images = _images(1, 64, 13)
    eng, _ = _small_engine(config, images)
    assert _backbone_spans(eng, images) == [
        ("backbone.netG", {"graph": "eager", "imf": "HRNetV2_W18_small_v2",
                           "stage": [[16, 16, 18], [8, 8, 36], [4, 4, 72],
                                     [2, 2, 144]]})]

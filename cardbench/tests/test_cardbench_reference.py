"""The plain reference against the port's frame on the CPU at a small
size (f32, the port's kernels through their plain versions), on the
frontal path and the rotated path (anchored and per-point refine levels,
compaction by the previous frame's hint, the reference's hint from its
own previous frame)."""

import pytest
import torch

from cardbench.harness.cell import Cell
from cardbench.reference.nets import ImplicitNet
from cardbench.reference.recon import anchor_plan, hint_from_valid, snap_budget

from .small import SmallManifest

SEED = 3_000_000_019


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("config", ["monoport-hg4-resnet",
                                    "monoport-hrnet-w18-small-v2"])
def test_parameter_names_match_the_port(config):
    from monoport_tpu_torch.config import CN
    from monoport_tpu_torch.models import MonoPortNet

    from cardbench.harness.manifest import Manifest
    from cardbench.harness.program import _opt

    cfg = Manifest().config(config)
    for key in ("netG", "netC"):
        if key not in cfg:
            continue
        with torch.device("meta"):
            ref = ImplicitNet(cfg[key]).state_dict()
            port = MonoPortNet(CN(_opt(cfg[key])), head_channels=tuple(
                cfg[key]["head"]["widths"])).state_dict()
        assert {k: tuple(v.shape) for k, v in ref.items()} == \
            {k: tuple(v.shape) for k, v in port.items()}


def _frames(workload, n):
    cell = Cell(SmallManifest(bodies=3), workload, SEED, "cpu")
    cell.setup()
    ref = cell.reference()
    out, hint = [], None
    with torch.inference_mode():
        for i in range(n):
            got = cell.frame(i, hint)
            b, c = cell.traffic.frame(i)
            img = cell.traffic.images[b:b + 1]
            want = ref(img, img if cell.images_c is not None else None,
                       cell.traffic.calibs[c], hint)
            out.append((got, want, cell.traffic.calibs[c], hint))
            hint = cell.hint_after(got)
    return out


def _close(got, want):
    assert torch.equal(got["valid"], want["valid"])
    v = want["valid"]
    assert float((got["depth"] - want["depth"])[v].abs().max()) < 1e-3
    for key in ("render_norm", "render_tex"):
        if key in want:
            assert float((got[key] - want[key]).abs().max()) < 1e-3, key


@pytest.mark.parametrize("workload", ["hg4-frontal", "hrnet-frontal"])
def test_frontal_frames(workload):
    frames = _frames(workload, 3)
    for got, want, _, _ in frames:
        assert 0.01 < float(want["valid"].float().mean())
        _close(got, want)
        assert ("render_tex" in got) == (workload == "hg4-frontal")


def test_rotated_frames():
    frames = _frames("hg4-orbit", 8)
    plans = set()
    for got, want, calib, hint in frames:
        assert "compact_dropped" in got
        _close(got, want)
        plans.add(anchor_plan(calib, 64, [(9, 17), (17, 33)], 6, 1.5,
                              (-1, -1, -1), (1, 1, 1)))
    # anchored and per-point levels both ran; hints fed from frame 1 on
    assert any(k for p in plans for k in p) and any(None in p for p in plans)
    assert frames[0][3] is None and all(f[3] is not None for f in frames[1:])


@pytest.mark.parametrize("fraction", [0.0, 0.05, 0.21, 0.4])
def test_hint_rule_is_the_demos(fraction):
    cell = Cell(SmallManifest(bodies=3), "hg4-orbit", SEED, "cpu")
    cell.setup()
    p = cell.config["profile"]
    assert hint_from_valid(fraction, p["fine_res"], p["window"]) == \
        pytest.approx(cell.engine.compact_hint_from_valid(fraction), rel=1e-12)


def test_reference_takes_its_own_hint():
    cell = Cell(SmallManifest(bodies=3), "hg4-orbit", SEED, "cpu")
    cell.setup()
    cell.warm_up()
    cell.prepare_sample(0.5)
    win = cell.window(0.5)
    ref = cell.reference()
    assert cell.reference_inputs(win, 0, ref)[3] is None
    ceiling = cell.config["profile"]["rotated"]["compact"]
    with torch.inference_mode():
        for i in range(1, min(win.frames, 4)):
            hint = cell.reference_inputs(win, i, ref)[3]
            prev = ref(*cell.inputs(win, i - 1)[:3], None)
            assert hint == ref.hint_after(prev)
            assert snap_budget(hint, ceiling) == \
                snap_budget(win.meta[i][2], ceiling)

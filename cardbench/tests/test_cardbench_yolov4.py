"""The cells ``yolov4-frontal`` (the ``Yolov4Filters`` netG, whose
reference backbone is a file of its own, ``reference/backbones/``) and
``hrnet-orbit`` (the HRNet netG under the orbit traffic): found by name,
correct at a small size on the CPU, and not correct with a stale or an
empty frame; ``backbone.netG.mfu``'s reader on a stubbed reading."""

import time
import types

import pytest
import torch

from cardbench import run as bench_run
from cardbench.harness import spans, work
from cardbench.harness.cell import Cell
from cardbench.harness.manifest import Manifest

from .small import SmallManifest
from .test_cardbench_isolation import FORBIDDEN, _top_level

SEED = 4_200_000_011
CELLS = ("yolov4-frontal", "hrnet-orbit")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(workload):
    res, _ = bench_run.run(SmallManifest(bodies=4), workload, SEED, 1.5,
                           False, device="cpu", t_start=time.perf_counter())
    return res


@pytest.mark.parametrize("workload", CELLS)
def test_cell_resolves_by_name(workload):
    m = Manifest()
    entry = m.workload(workload)
    assert entry["chips"] == 1
    config = m.config(entry["config"])
    assert config["reduced"] == [] and "netC" not in config
    m.traffic(entry["traffic"])
    assert m.limits(workload)["frames"] == 12
    names = {metric["name"] for metric in m.per_layer(workload)}
    assert "backbone.ms" not in names
    assert ("backbone.netG.mfu" in names) == (workload == "yolov4-frontal")
    for name in names:
        assert callable(m.reader(name).read)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    res = _run(workload)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("workload", CELLS)
def test_stale_frame(monkeypatch, workload):
    frame = Cell.frame

    def stale(self, i, hint):
        out = frame(self, i, hint)
        if not hasattr(self, "_first"):
            self._first = {k: v.clone() for k, v in out.items()}
        return self._first

    monkeypatch.setattr(Cell, "frame", stale)
    res = _run(workload)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_empty_frame(monkeypatch, workload):
    frame = Cell.frame

    def empty(self, i, hint):
        out = dict(frame(self, i, hint))
        out["valid"] = torch.zeros_like(out["valid"])
        return out

    monkeypatch.setattr(Cell, "frame", empty)
    res = _run(workload)
    assert not res["correct"], res["checks"]


def _ctx(config):
    return types.SimpleNamespace(cell=types.SimpleNamespace(config=config))


@pytest.mark.parametrize("dtype,peak", [("float32", work.PEAK_F32),
                                         ("bfloat16", work.PEAK_BF16)])
def test_netg_mfu_reads_a_share(monkeypatch, dtype, peak):
    """91 GFLOP (the published net at 512^2) over a stubbed 3 ms in
    ``backbone.netG`` and the peak of the profile's dtype; nothing without
    spans, or where the span launched nothing."""
    reader = Manifest.reader("backbone.netG.mfu")
    config = Manifest().config("monoport-yolov4")
    config["profile"]["compute_dtype"] = dtype
    flops = work.backbone_flops(config["netG"]["backbone"], 512)
    assert flops == pytest.approx(91.05e9, rel=1e-3)
    stub = types.SimpleNamespace(device_ms={"backbone.netG": 3.0,
                                            "recon.refine": 9.0})
    monkeypatch.setattr(spans, "readings", lambda ctx: stub)
    share = reader.read(_ctx(config))
    assert 0.0 < share <= 100.0
    assert share == pytest.approx(100.0 * flops / 3e-3 / peak)
    stub.device_ms = {"recon.refine": 9.0}
    assert reader.read(_ctx(config)) is None
    monkeypatch.setattr(spans, "readings", lambda ctx: None)
    assert reader.read(_ctx(config)) is None


def test_kernel1_f32_ray_roofline_reads_the_f32_route():
    """Kernel 1's f32 route on a frontal frame: ``xproj_kernel`` and
    ``mlp_kernel`` of the traced frames against the march, the refine and
    the window's ray queries at the f32 peak with 4-byte operands; nothing
    under bf16, off the 'ray' path, or where the route did not run."""
    reader = Manifest.reader("kernel1.f32.ray.roofline")
    config = Manifest().config("monoport-yolov4")
    trace = types.SimpleNamespace(frames=4, by_name={
        "void mlp_kernel<F32, 6>": [0.030, 12],
        "void xproj_kernel<F32>": [0.010, 12],
        "aten::copy_": [0.5, 40]})
    ctx = types.SimpleNamespace(cell=types.SimpleNamespace(config=config),
                                trace=trace)
    bound = sum(work.bound_s(work.ray_mlp_work(w, r, t, op_bytes=4,
                                               peak=work.PEAK_F32))
                for w, r, t in work.frontal_ray_launches(config))
    assert len(work.frontal_ray_launches(config)) == 3      # no netC
    share = reader.read(ctx)
    assert share == pytest.approx(100.0 * bound * 4 / 0.040, rel=1e-12)
    assert 0.0 < share <= 100.0
    config["profile"]["compute_dtype"] = "bfloat16"
    assert reader.read(ctx) is None
    config["profile"]["compute_dtype"] = "float32"
    config["profile"]["mode"] = "dense"
    assert reader.read(ctx) is None
    config["profile"]["mode"] = "ray"
    trace.by_name = {"aten::copy_": [0.5, 40]}
    assert reader.read(ctx) is None


def test_reference_backbone_imports_nothing_of_the_port():
    names = _top_level(
        "from cardbench.reference import nets\n"
        "net = nets.backbone({'IMF': 'Yolov4Filters', 'norm': 'batch'})\n"
        "assert type(net).__module__.startswith('cardbench_reference_')")
    assert "torch" in names
    assert not names & (FORBIDDEN | {"monoport_tpu_torch"})

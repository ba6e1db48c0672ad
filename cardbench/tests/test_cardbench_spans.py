"""The spans' readings (``harness/spans.py``): the reductions on hand-made
events, the program's query rows against the yardstick's on a small
orbit cell, and a program without a recorder giving nothing to read."""

import types

import pytest
import torch

from cardbench.harness import spans, work
from cardbench.harness.cell import Cell
from cardbench.harness.manifest import Manifest
from cardbench.tests.small import SmallManifest

SEED = 2 ** 31 + 12345

# a frame 0..100 with a plan, a backbone and a recon span holding a
# refine; then harness time 100..120 and a second frame 120..150
SPANS = [(0, 100, "engine.frame", None),
         (0, 5, "engine.plan", 0),
         (5, 40, "backbone.netG", 0),
         (40, 90, "recon.march", 0),
         (60, 80, "recon.refine", 3),
         (120, 150, "engine.frame", None)]


def test_host_times_and_self_times():
    t = spans.host_times(SPANS)
    assert t["engine.frame"] == [130, 130 - 5 - 35 - 50, 2]
    assert t["recon.march"] == [50, 30, 1]
    assert t["recon.refine"] == [20, 20, 1]
    assert spans.layer_ns(SPANS, "recon.") == 50      # the refine is inside
    assert spans.layer_ns(SPANS, "backbone.") == 35
    assert spans.layer_ns(SPANS, "texture.") is None


def test_innermost_span_at_a_time():
    got = spans.innermost([70, 2, 95, 110, 45, 130, 200], SPANS)
    assert got == ["recon.refine", "engine.plan", "engine.frame",
                   spans.NO_SPAN, "recon.march", "engine.frame",
                   spans.NO_SPAN]


def test_kernels_go_to_the_span_that_launched_them():
    device = [(50, 70, "k_backbone", 10),       # launched in the backbone
              (71, 74, "k_refine", 65),          # in the refine
              (90, 99, "k_march", 89),           # in the march, runs later
              (115, 118, "k_hint", 105),         # the harness's own
              (140, 141, "copy", None)]          # no launch found
    got = spans.device_by_span(SPANS, device)
    assert got == {"backbone.netG": 20, "recon.refine": 3,
                   "recon.march": 9, spans.NO_SPAN: 3, spans.UNLINKED: 1}


def test_kernels_by_span_and_name():
    device = [(50, 70, "k_backbone", 10), (71, 74, "mlp_kernel", 65),
              (75, 77, "mlp_kernel", 66), (78, 79, "copy", 67),
              (90, 99, "mlp_kernel", 89), (140, 141, "copy", None)]
    got = spans.device_by_span_op(SPANS, device)
    assert got == {("backbone.netG", "k_backbone"): 20,
                   ("recon.refine", "mlp_kernel"): 5,
                   ("recon.refine", "copy"): 1,
                   ("recon.march", "mlp_kernel"): 9,
                   (spans.UNLINKED, "copy"): 1}
    by_span = spans.device_by_span(SPANS, device)
    for name, ns in by_span.items():
        assert ns == sum(v for (s, _), v in got.items() if s == name)


def test_idle_gaps_go_to_the_span_open_at_their_middle():
    device = [(8, 30, "a", 6), (25, 45, "b", 20), (60, 65, "c", 58),
              (125, 140, "d", 121)]
    got = spans.idle_by_span(SPANS, device, (0, 150))
    # gaps: 0-8 (plan), 45-60 (march), 65-125 (middle 95: the frame),
    # 140-150 (the second frame)
    assert got == {"engine.plan": 8, "recon.march": 15,
                   "engine.frame": 60 + 10}


class _Event:
    def __init__(self, on_card, name, start, dur, cid):
        self.on_card, self._name, self.start, self.dur = (on_card, name,
                                                          start, dur)
        self.cid = cid

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self.on_card
                else torch.autograd.DeviceType.CPU)

    def name(self):
        return self._name

    def start_ns(self):
        return self.start

    def duration_ns(self):
        return self.dur

    def correlation_id(self):
        return self.cid


def test_profiled_ops_join_launches_by_correlation():
    host, card = False, True
    events = [
        _Event(host, spans.MARK, 0, 100, 1),
        _Event(host, "aten::mm", 10, 5, 2),
        _Event(host, "cudaLaunchKernel", 12, 1, 700),
        _Event(card, "gemm", 30, 8, 700),
        _Event(host, "cuLaunchKernelEx", 50, 1, 701),
        _Event(card, "wgmma_mlp_kernel", 60, 4, 701),
        _Event(card, "Memcpy HtoD", 70, 2, 999),          # no launch found
        _Event(card, spans.MARK, 0, 100, 1),               # an annotation
        _Event(host, spans.MARK, 100, 50, 3)]
    ops, marks = spans.profiled_ops(events)
    assert ops == [(30, 38, "gemm", 12), (60, 64, "wgmma_mlp_kernel", 50),
                   (70, 72, "Memcpy HtoD", None)]
    assert marks == [(0, 100), (100, 150)]


def test_reduce_per_frame():
    from monoport_tpu_torch.utils import profiling

    with profiling.recording() as rec:
        for rung in (0.25, 0.375):
            with profiling.span(spans.ROOT) as root:
                root.attrs.update(path="rotated", rung=rung, plan=(5, 3))
                with profiling.span("recon.march"):
                    profiling.query("query_occ", 1000)
                with profiling.span("texture.query"):
                    profiling.query("query_color", 30)
    r = spans.reduce(rec, rec, [], [], 2, {"recorded": 0.5, "traced": 1.0})
    assert r.rows == {"query_occ": 1000.0, "query_color": 30.0}
    assert r.layer_rows == {"recon.": 1000.0, "texture.": 30.0}
    assert r.plans == {"rotated 0.25 (5, 3)": 1, "rotated 0.375 (5, 3)": 1}
    assert (r.recorded_fps, r.traced_fps) == (4.0, 2.0)
    assert r.layer_host_ms["backbone."] is None
    assert r.layer_device_ms("backbone.") is None
    assert r.layer_device_ms("recon.") == 0.0
    frame, march = r.host_ms[spans.ROOT], r.host_ms["recon.march"]
    assert frame[0] >= frame[1] >= 0.0 and march[0] >= 0.0


def _rows_of_works(config, calib, hint, monkeypatch):
    """(rows, taps, anchors) of each head query ``work.frame_head_works``
    counts for a frame."""
    seen = []
    ray, point = work.ray_mlp_work, work.point_mlp_work

    def ray_rows(widths, rays, taps, anchors=1, mixed=False, **kw):
        seen.append((rays, taps, anchors if mixed else 0))
        return ray(widths, rays, taps, anchors=anchors, mixed=mixed, **kw)

    def point_rows(widths, points, **kw):
        seen.append((points, 1, 0))
        return point(widths, points, **kw)

    with monkeypatch.context() as m:
        m.setattr(work, "ray_mlp_work", ray_rows)
        m.setattr(work, "point_mlp_work", point_rows)
        work.frame_head_works(config, calib, hint)
    return seen


@pytest.fixture(scope="module")
def orbit_cell():
    torch.set_num_threads(2)
    cell = Cell(SmallManifest(bodies=2), "hg4-orbit", SEED, "cpu")
    cell.setup()
    return cell


def test_query_rows_are_the_yardsticks_rows(orbit_cell, monkeypatch):
    """Frame by frame, with the hint of the frame before: the program's
    query records equal the rows ``work.frame_head_works`` counts, so a
    stale yardstick fails here."""
    cell, prof = orbit_cell, spans.program_profiling()
    hint, plans = None, set()
    with torch.inference_mode():
        for i in range(6):
            with prof.recording() as rec:
                out = cell.frame(i, hint)
            _, pose = cell.traffic.frame(i)
            want = _rows_of_works(cell.config, cell.traffic.calibs[pose],
                                  hint, monkeypatch)
            assert [(q.rows, q.taps, q.anchors) for q in rec.queries] == want
            plans.add(rec.spans[0].attrs["plan"])
            hint = cell.hint_after(out)
    assert len(plans) > 2 and any(None in p for p in plans), plans


def test_readings_of_a_small_cell(orbit_cell, capsys):
    ctx = types.SimpleNamespace(
        cell=orbit_cell, window=types.SimpleNamespace(frames=3, elapsed=1.0),
        trace=types.SimpleNamespace(frames=2))
    r = spans.readings(ctx)
    assert r is spans.readings(ctx)                  # once a run
    assert sum(r.plans.values()) == spans.FRAMES
    assert r.layer_rows["recon."] > 0 and r.layer_host_ms["recon."] > 0
    for name in ("engine.frame", "engine.plan", "backbone.netG",
                 "backbone.netC", "recon.march", "recon.refine",
                 "render.shade", "texture.query", "render.texture"):
        assert name in r.host_ms
    lines = capsys.readouterr().out.splitlines()
    assert [line.split('"')[3] for line in lines] == ["spans", "queries"]
    for name in ("backbone.host_ms", "recon.host_ms", "recon.query_rows",
                 "engine.self_ms"):
        assert Manifest.reader(name).read(ctx) > 0.0, name
    del orbit_cell.span_readings


def test_nothing_to_read_without_a_recorder(orbit_cell, monkeypatch):
    """A program before spans: every new reader gives None and no frame
    runs."""
    from monoport_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "recording")
    monkeypatch.setattr(orbit_cell, "frame", None)       # not called
    ctx = types.SimpleNamespace(cell=orbit_cell, window=None, trace=None)
    for name in ("backbone.device_ms", "backbone.host_ms", "recon.device_ms",
                 "recon.host_ms", "recon.query_rows", "texture.device_ms",
                 "engine.self_ms"):
        assert Manifest.reader(name).read(ctx) is None, name
    del orbit_cell.span_readings

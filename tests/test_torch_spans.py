"""PyTorch port, the program's spans and query records
(``utils/profiling.span`` / ``query`` / ``recording``) in
``ReconEngine.frame`` on the CPU, at the small profile of
tests/test_torch_engine.py (64^2 image, march (9, 17), fine 33, 4 taps, a
24-ray window), with seeded torch nets.

Held: each frame's span tree (names, parents, one frame id, nesting), the
root's path / rung / plan against the engine's own host rules, each
query's rows against the query shapes the profile implies, a frame with
no recorder (nothing recorded, no clock read, outputs bit-equal to a
recorded frame's), one stack a thread, and the stamps on the profiler's
clock."""

import threading

import numpy as np
import pytest
import torch

from monoport_tpu_torch import engine as tengine
from monoport_tpu_torch.config import CN
from monoport_tpu_torch.engine import (EngineCfg, RayCfg, ReconEngine,
                                       RotatedCfg)
from monoport_tpu_torch.models import MonoPortNet
from monoport_tpu_torch.models.monoport_net import head_channels_for
from monoport_tpu_torch.recon.hierarchy import HierarchicalRecon
from monoport_tpu_torch.recon.ray_refine import _compact_rays
from monoport_tpu_torch.utils import profiling

torch.set_num_threads(2)

ROT_CALIB = np.asarray([[[0.93, 0.02, 0.30, 0.05],
                         [-0.05, 0.99, 0.17, -0.02],
                         [0.24, -0.12, 0.92, 0.01],
                         [0.0, 0.0, 0.0, 1.0]]], np.float32)
INPLANE_CALIB = np.asarray([[[0.9, 0.3, 0.0, 0.0],
                             [-0.3, 0.9, 0.0, -0.01],
                             [0.1, -0.05, 1.0, 0.0],
                             [0.0, 0.0, 0.0, 1.0]]], np.float32)
LEVELS, FINE, TAPS, WINDOW = (9, 17), 33, 4, 24
FRONTAL_SPANS = ["engine.frame", "engine.plan", "backbone.netG",
                 "recon.march", "recon.refine", "recon.refine",
                 "render.shade", "backbone.netC", "texture.query",
                 "render.texture"]


def _opts(kind):
    o = {"projection": "orthogonal", "normalizer": {"IMF": "PIFuNomalizer"}}
    if kind == "G":
        o.update(backbone={"IMF": "PIFuHGFilters", "num_stack": 1,
                           "num_hourglass": 1, "hourglass_dim": 32,
                           "norm": "group", "hg_down": "ave_pool"},
                 head={"IMF": "PIFuNetGMLP"}, loss={"IMF": "MSE"})
    else:
        o.update(backbone={"IMF": "PIFuResBlkFilters"},
                 head={"IMF": "PIFuNetCMLP"}, loss={"IMF": "L1"})
    return CN(o)


@pytest.fixture(scope="module")
def nets():
    torch.manual_seed(0)
    g = MonoPortNet(_opts("G"), head_channels_for(_opts("G")))
    c = MonoPortNet(_opts("C"), head_channels_for(_opts("C"), 32))
    image = torch.rand(1, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    return g.eval(), c.eval(), image


def _engine(nets, mode="ray", march=LEVELS):
    g, c, _ = nets
    cfg = EngineCfg(render_size=32,
                    ray=RayCfg(mode=mode, fine_res=FINE, taps=TAPS,
                               window=WINDOW, march_levels=march),
                    rotated=RotatedCfg(compact=0.5))
    return ReconEngine(g, c, recon=HierarchicalRecon(resolutions=LEVELS,
                                                     budgets=(0, 2048)),
                       config=cfg, device="cpu")


def _recorded(eng, nets, calib=None, hint=None, frames=1):
    image = nets[2]
    with profiling.recording() as rec:
        outs = [eng.frame(image, image, calib, compact_hint=hint)
                for _ in range(frames)]
    return rec, outs


def test_frontal_frame_span_tree(nets):
    rec, _ = _recorded(_engine(nets), nets, frames=2)
    assert [s.name for s in rec.spans] == FRONTAL_SPANS * 2
    for f in (0, 1):
        spans = [s for s in rec.spans if s.frame == f]
        root, children = spans[0], spans[1:]
        assert len(spans) == len(FRONTAL_SPANS)
        assert root.name == profiling.FRAME and root.parent is None
        for s in children:
            assert s.parent is root
            assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
        for a, b in zip(children, children[1:]):      # siblings in turn
            assert a.end_ns <= b.start_ns
        assert [s.attrs for s in children if s.name == "recon.refine"] == [
            {"from": 9, "to": 17}, {"from": 17, "to": 33}]
        assert all(s.thread == threading.get_ident() for s in spans)
    assert rec.spans[0].end_ns <= rec.spans[len(FRONTAL_SPANS)].start_ns


@pytest.mark.parametrize("calib,hint,path", [
    (None, None, "grid"), (INPLANE_CALIB, None, "taps"),
    (ROT_CALIB, None, "rotated"), (ROT_CALIB, 0.3, "rotated"),
    (ROT_CALIB, 0.9, "rotated")])
def test_frame_attrs_are_the_engines_plan(nets, calib, hint, path):
    """path / rung / plan equal ``_snap_budget`` and ``_rot_anchor_plan``
    (a frontal or in-plane frame has no rung and no plan)."""
    eng = _engine(nets)
    rec, _ = _recorded(eng, nets, calib, hint)
    root = rec.spans[0]
    if path == "rotated":
        rung = (0.5 if hint is None
                else tengine._snap_budget(hint, eng.config.rotated.compact))
        plan = eng._rot_anchor_plan(calib, 64)
        assert any(plan)
    else:
        rung, plan = None, ()
    assert root.attrs == {"path": path, "rung": rung, "plan": plan}


@pytest.mark.parametrize("mode,path,recon", [
    ("ray", "hierarchy", ["recon.hierarchy", "recon.peel", "recon.refine"]),
    ("dense", "peel", ["recon.hierarchy", "recon.peel"])])
def test_volume_frames_name_their_path(nets, mode, path, recon):
    rec, _ = _recorded(_engine(nets, mode=mode, march=None), nets)
    assert rec.spans[0].attrs["path"] == path
    assert [s.name for s in rec.spans if s.name.startswith("recon.")] == recon
    assert all(s.parent is rec.spans[0] for s in rec.spans[1:])


def test_frontal_query_rows_are_the_query_shapes(nets):
    rec, _ = _recorded(_engine(nets), nets)
    got = [(q.name, q.rows, q.taps, q.anchors, q.span.name, q.frame)
           for q in rec.queries]
    assert got == [
        ("query_grid", 9 * 9, 9, 0, "recon.march", 0),
        ("query_grid", 17 * 17, TAPS, 0, "recon.refine", 0),
        ("query_grid", WINDOW * WINDOW, TAPS, 0, "recon.refine", 0),
        ("color_grid", WINDOW * WINDOW, 1, 0, "texture.query", 0)]


@pytest.mark.parametrize("hint", [None, 0.3])
def test_rotated_query_rows_are_the_query_shapes(nets, hint):
    """The march's points, each refine level's compacted rays at the
    rung (anchored with the plan's K), and the colour query riding the
    last level's rays."""
    eng = _engine(nets)
    rec, _ = _recorded(eng, nets, ROT_CALIB, hint)
    rung = rec.spans[0].attrs["rung"]
    plan = eng._rot_anchor_plan(ROT_CALIB, 64)
    b17 = _compact_rays(rung, 17, 17)
    bw = _compact_rays(rung, WINDOW, WINDOW)
    want = [("query_occ", 9 ** 3, 1, 0, "recon.march")]
    for k, budget in zip(plan, (b17, bw)):
        want.append(("query_anchored", budget, TAPS, k, "recon.refine") if k
                    else ("query_occ", budget * TAPS, 1, 0, "recon.refine"))
    want.append(("query_color", bw, 1, 0, "texture.query"))
    assert [(q.name, q.rows, q.taps, q.anchors, q.span.name)
            for q in rec.queries] == want


def test_no_recorder_records_nothing_and_reads_no_clock(nets, monkeypatch):
    eng = _engine(nets)
    image = nets[2]
    rec, (want,) = _recorded(eng, nets, ROT_CALIB, 0.3)
    n_spans, n_queries = len(rec.spans), len(rec.queries)

    def no_clock():
        raise AssertionError("a clock read with no recorder on")

    monkeypatch.setattr(profiling.time, "time_ns", no_clock)
    assert profiling.span("x", a=1) is profiling.span("y")
    got = eng.frame(image, image, ROT_CALIB, compact_hint=0.3)
    assert (len(rec.spans), len(rec.queries)) == (n_spans, n_queries)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_one_recorder_at_a_time_and_a_stack_a_thread():
    with profiling.recording() as rec:
        with pytest.raises(RuntimeError, match="on already"):
            with profiling.recording():
                pass
        seen = {}

        def worker():
            with profiling.span(profiling.FRAME):
                with profiling.span("inner") as s:
                    seen["inner"] = s

        with profiling.span(profiling.FRAME) as outer:
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
            with profiling.span("mine") as mine:
                profiling.query("q", 7, taps=3, anchors=2)
    inner = seen["inner"]
    assert inner.parent.name == profiling.FRAME and inner.parent is not outer
    assert inner.frame != outer.frame and inner.thread != outer.thread
    assert mine.parent is outer and mine.frame == outer.frame
    assert rec.queries == [profiling.Query("q", 7, 3, 2, mine, outer.frame)]
    assert profiling.span("after") is profiling.span("off")


def test_spans_land_on_the_profilers_clock():
    """A span just inside a ``record_function`` range starts and ends
    within 100 us of it in the profiler's events (median of five)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.rand(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            profiling.recording() as rec:
        for i in range(8):
            with record_function(f"range{i}"):
                with profiling.span(f"span{i}"):
                    x @ x
    ranges = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("range")}
    starts, ends = [], []
    for i, s in enumerate(rec.spans[3:], start=3):      # after a warm-up
        r = ranges[f"range{i}"]
        starts.append(s.start_ns - r.start_ns())
        ends.append(r.start_ns() + r.duration_ns() - s.end_ns)
    assert abs(float(np.median(starts))) < 100e3, starts
    assert abs(float(np.median(ends))) < 100e3, ends

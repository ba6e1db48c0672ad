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
clock.

The graphs (``frame_graphs``: the backbone calls and the march
pyramid's stages): on the CPU every call runs eagerly (``graph="eager"``)
with the nets' own outputs and ``ray_pyramid``'s maps; the signature
separates the nets, the upcast choices, image shapes and a prior, and pins
a graph output by address; a stage's key holds the stage, path, window,
rung, anchor count and its inputs' shapes and dtypes; no frame output
aliases a graph output. Capture and replay run on the CPU through a fake
CUDA graph (each ATen op recorded at capture and run again, in place, at
replay): replayed features and whole frames bit-equal to the eager ones,
after a change of image too, one capture a signature, a failed capture
eager from then on; a replayed stage makes its capture's query records
under its span and counts its launches once."""

import contextlib
import threading

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from monoport_tpu_torch import frame_graphs
from monoport_tpu_torch import engine as tengine
from monoport_tpu_torch.config import CN
from monoport_tpu_torch.engine import (EngineCfg, RayCfg, ReconEngine,
                                       RotatedCfg)
from monoport_tpu_torch.models import MonoPortNet
from monoport_tpu_torch.models.monoport_net import head_channels_for
from monoport_tpu_torch.recon.hierarchy import HierarchicalRecon
from monoport_tpu_torch.recon.ray_refine import compact_budget
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
            {"from": 9, "to": 17, "graph": "eager"},
            {"from": 17, "to": 33, "graph": "eager"}]
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
    b17 = compact_budget(rung, 17, 17)
    bw = compact_budget(rung, WINDOW, WINDOW)
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


# -- the backbone graphs (frame_graphs.py) -----------------------------------
class _FakeGraph:
    """A CUDA graph's semantics on the CPU: the capture records each ATen op
    with its argument and output tensors, and a replay runs them again in
    order, writing into the recorded outputs, so a replay reads and writes
    the capture's tensors at their addresses, as a CUDA graph does."""

    def __init__(self):
        self.ops = []
        self.replays = 0

    def replay(self):
        for func, args, kwargs, out in self.ops:
            res = func(*args, **kwargs)
            for o, r in zip(tree_leaves(out), tree_leaves(res)):
                if isinstance(o, torch.Tensor):
                    o.copy_(r)
        self.replays += 1


class _Record(TorchDispatchMode):
    def __init__(self, ops: list):
        super().__init__()
        self.ops = ops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops.append((func, args, kwargs or {}, out))
        return out


@pytest.fixture
def fake_cuda_graphs(monkeypatch):
    """``torch.cuda``'s graph capture and replay emulated on the CPU; ->
    the list of the fake graphs captured, each with its capture mode."""
    graphs = []

    @contextlib.contextmanager
    def capture(graph, capture_error_mode="global"):
        graph.mode = capture_error_mode
        graphs.append(graph)
        with _Record(graph.ops):
            yield

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", capture)
    return graphs


def _graphed(eng):
    """``eng`` with its backbone calls captured and replayed (the card's
    path) through the fixture's fake graphs."""
    eng.graphs.capturable = True
    return eng


def _collect_backbone_outputs(eng, recon: bool = False):
    """Wrap ``eng.graphs.run``; -> the list the backbone calls' outputs go
    to, and with ``recon`` the graphed (not eager) stages' outputs too."""
    seen = []
    run = eng.graphs.run

    def recorded(name, *args, **kwargs):
        out, mode = run(name, *args, **kwargs)
        if name != "recon" or (recon and mode != "eager"):
            seen.extend(t for t in tree_leaves(out)
                        if isinstance(t, torch.Tensor))
        return out, mode

    eng.graphs.run = recorded
    return seen


def _assert_outputs_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("calib", [None, INPLANE_CALIB, ROT_CALIB],
                         ids=["frontal", "inplane", "rotated"])
def test_cpu_backbone_spans_are_eager(nets, calib):
    """On the CPU every backbone call runs eagerly (span attribute
    ``graph="eager"``, the engine's counts; ``imf`` and the queried
    stage's map shapes beside it), and its features are the nets' own
    ``filter`` outputs, so the frame is the frame of the plain calls."""
    eng = _engine(nets)
    image = nets[2]
    seen = _collect_backbone_outputs(eng)
    rec, outs = _recorded(eng, nets, calib, frames=2)
    modes = [(s.name, s.attrs) for s in rec.spans
             if s.name.startswith("backbone.")]
    assert modes == [("backbone.netG", {"graph": "eager",
                                        "imf": "PIFuHGFilters",
                                        "stage": [[16, 16, 32]]}),
                     ("backbone.netC", {"graph": "eager",
                                        "imf": "PIFuResBlkFilters",
                                        "stage": [[16, 16, 288]]})] * 2
    assert eng.graphs.counts == {
        "netG": {"capture": 0, "replay": 0, "eager": 2},
        "netC": {"capture": 0, "replay": 0, "eager": 2},
        "recon": {"capture": 0, "replay": 0, "eager": 6}}
    with torch.no_grad():
        feats_g = eng.netG.filter(image)
        want = tree_leaves(feats_g) + tree_leaves(
            eng.netC.filter(image, feats_g[-1][-1]))
    assert len(seen) == 2 * len(want)
    for got, w in zip(seen, want + want):
        assert torch.equal(got, w)
    _assert_outputs_equal(outs[1], outs[0])


def _key(net="netG", shape=(1, 64, 64, 3), upcast=True, prior=None,
         pinned=None):
    inputs = [torch.zeros(shape)] + ([] if prior is None else [prior])
    return frame_graphs.signature(net, inputs, upcast, pinned)


@pytest.mark.parametrize("other", [
    dict(net="netC"), dict(upcast=False), dict(shape=(1, 128, 128, 3)),
    dict(shape=(1, 64, 64, 3), prior=torch.zeros(1, 16, 16, 8)),
    dict(shape=(1, 64, 48, 3))])
def test_signature_separates_calls(other):
    """The net, the upcast choice, the image shape and a prior each give a
    call of its own; the same call gives the same key."""
    assert _key() == _key()
    assert _key(**other) != _key()


def test_signature_pins_a_graph_output_by_address():
    """An input that is one of the graphs' outputs (netC's prior) is keyed
    by its address, another tensor of its shape by none."""
    prior = torch.zeros(1, 16, 16, 8)
    other = torch.zeros(1, 16, 16, 8)
    pinned = {prior.data_ptr(): prior}
    key = _key(net="netC", prior=prior, pinned=pinned)
    assert key[-1] == ((1, 16, 16, 8), torch.float32, prior.data_ptr())
    assert _key(net="netC", prior=other, pinned=pinned)[-1][2] is None
    assert _key(net="netC", prior=prior)[-1][2] is None


@pytest.mark.parametrize("mode,march,calib", [
    ("ray", LEVELS, None), ("ray", LEVELS, ROT_CALIB),
    ("ray", None, None), ("dense", None, None)],
    ids=["frontal", "rotated", "hierarchy", "dense"])
@pytest.mark.parametrize("graphed", [False, True], ids=["eager", "graphed"])
def test_no_frame_output_aliases_a_backbone_output(nets, mode, march, calib,
                                                   graphed,
                                                   fake_cuda_graphs):
    """The backbone outputs and the graphed pyramid stages' outputs are a
    graph's static tensors, overwritten by the next frame: no tensor of
    ``frame``'s output shares memory with one."""
    eng = _engine(nets, mode=mode, march=march)
    if graphed:
        _graphed(eng)
    image = nets[2]
    seen = _collect_backbone_outputs(eng, recon=True)
    outs = [eng.frame(image, image, calib) for _ in range(2)]
    spans = [(t.untyped_storage().data_ptr(),
              t.untyped_storage().nbytes()) for t in seen]
    for out in outs:
        for k, v in out.items():
            p, n = v.untyped_storage().data_ptr(), v.untyped_storage().nbytes()
            assert all(p + n <= a or a + m <= p for a, m in spans), k


def test_replayed_backbones_equal_eager_filter(nets, fake_cuda_graphs):
    """One capture a signature, replays after; netG's and netC's replayed
    features equal eager ``filter`` on the same image bit for bit, also
    after the image changes to another body (the input copy), and netC
    reads netG's last map in place (no buffer for its prior)."""
    eng = _graphed(_engine(nets))
    image = nets[2]
    other = torch.rand(1, 64, 64, 3,
                       generator=torch.Generator().manual_seed(2))
    runs = []
    run = eng.graphs.run

    def recorded(name, *args, **kwargs):
        out, mode = run(name, *args, **kwargs)
        if name != "recon":
            runs.append((name, mode, [t.clone() for t in tree_leaves(out)]))
        return out, mode

    eng.graphs.run = recorded
    for img in (image, other, image):
        eng.frame(img, img)
    assert [(n, m) for n, m, _ in runs] == [
        ("netG", "capture"), ("netC", "capture"), ("netG", "replay"),
        ("netC", "replay"), ("netG", "replay"), ("netC", "replay")]
    # netG, the three pyramid stages, netC
    assert len(fake_cuda_graphs) == 5
    assert {g.mode for g in fake_cuda_graphs} == {"thread_local"}
    assert [g.replays for g in fake_cuda_graphs] == [3] * 5
    with torch.no_grad():
        for k, img in enumerate((image, other, image)):
            feats_g = eng.netG.filter(img)
            want = [tree_leaves(feats_g), tree_leaves(
                eng.netC.filter(img, feats_g[-1][-1]))]
            for (_, _, got), w in zip(runs[2 * k:2 * k + 2], want):
                assert len(got) == len(w)
                for a, b in zip(got, w):
                    assert torch.equal(a, b)
    graph_c = eng.graphs._graphs[next(k for k in eng.graphs._graphs
                                      if k[0] == "netC")]
    assert graph_c.copied == [True, False]
    assert eng.graphs.counts == {
        "netG": {"capture": 1, "replay": 2, "eager": 0},
        "netC": {"capture": 1, "replay": 2, "eager": 0},
        "recon": {"capture": 3, "replay": 6, "eager": 0}}


@pytest.mark.parametrize("calib", [None, ROT_CALIB],
                         ids=["frontal", "rotated"])
def test_replayed_frame_equals_eager_frame(nets, calib, fake_cuda_graphs):
    """A frame whose backbones replay is the eager frame bit for bit, in the
    frontal view and a rotated one; its spans read capture, then replay."""
    image = nets[2]
    eager = _engine(nets)
    want = [eager.frame(image, image, calib, compact_hint=0.3)
            for _ in range(2)]
    eng = _graphed(_engine(nets))
    with profiling.recording() as rec:
        got = [eng.frame(image, image, calib, compact_hint=0.3)
               for _ in range(2)]
    for g, w in zip(got, want):
        _assert_outputs_equal(g, w)
    assert [s.attrs["graph"] for s in rec.spans
            if s.name.startswith("backbone.")] == [
        "capture", "capture", "replay", "replay"]


def test_failed_capture_stays_eager(nets, fake_cuda_graphs, monkeypatch):
    """A signature whose capture fails warns once and runs eagerly from
    then on, with the eager frame's outputs."""
    image = nets[2]
    want = _engine(nets).frame(image, image)

    @contextlib.contextmanager
    def refused(graph, capture_error_mode="global"):
        with _Record(graph.ops):
            yield
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")

    monkeypatch.setattr(torch.cuda, "graph", refused)
    eng = _graphed(_engine(nets))
    with pytest.warns(UserWarning, match="capture failed"):
        got = eng.frame(image, image)
    _assert_outputs_equal(got, want)
    _assert_outputs_equal(eng.frame(image, image), want)
    assert eng.graphs.counts == {
        "netG": {"capture": 0, "replay": 0, "eager": 2},
        "netC": {"capture": 0, "replay": 0, "eager": 2},
        "recon": {"capture": 0, "replay": 0, "eager": 6}}


def test_replay_check_passes_on_fake_graphs(nets, fake_cuda_graphs):
    """``frame_check.replay_check``, the card's check of the graphs, on
    the emulated ones: every call and frame equal, every returned depth
    and valid kept, a capture a signature: netG, netC, three stages of
    the grid path and of the taps path, and on the rotated path the march
    and the two refines at each of the three rungs under the 0.5
    ceiling."""
    from monoport_tpu_torch import frame_check

    image = nets[2]
    other = torch.flip(image, dims=(2,))
    cases = [(None, None), (INPLANE_CALIB, None), (ROT_CALIB, 0.2),
             (ROT_CALIB, 0.3), (ROT_CALIB, 0.45)]
    res = frame_check.replay_check(_graphed(_engine(nets)), [image, other],
                                   cases)
    assert res["ok"], res
    assert [c[:2] for c in res["calls"] if c[0] != "recon"] == [
        ("netG", "capture"), ("netC", "capture"),
        ("netG", "replay"), ("netC", "replay")]
    assert [c[1] for c in res["calls"] if c[0] == "recon"] == (
        ["capture"] * 3 + ["replay"] * 3)
    assert len(res["frames"]) == 2 * len(cases) * 2
    assert len(res["kept"]) == len(res["frames"]) - 1
    assert res["keys"] == {"netG": 1, "netC": 1, "recon": 3 + 3 + 1 + 6}
    assert res["signatures"] == len(fake_cuda_graphs) == 15
    for name, n in res["keys"].items():
        assert res["counts"][name]["capture"] == n


# -- the march pyramid's graphs (engine._march) ------------------------------
def _stage_key(stage=(9, 17, None, 0), path="rotated", rung=0.5, anchors=3,
               feat=(1, 16, 16, 32), dtype=torch.float32):
    rc, rf, window, level = stage
    inputs = [torch.zeros(1, 4, 4, dtype=dtype), torch.zeros(feat)]
    return frame_graphs.signature("recon", inputs, tengine.stage_key(
        tengine.PyramidStage(rc, rf, level, window), path, rung, anchors))


@pytest.mark.parametrize("other", [
    dict(stage=(17, 33, 24, 1)), dict(stage=(None, 9, None, None)),
    dict(path="taps"), dict(stage=(9, 17, 20, 0)), dict(rung=0.375),
    dict(rung=None), dict(anchors=2), dict(anchors=0),
    dict(feat=(1, 32, 32, 32)), dict(dtype=torch.float64)],
    ids=["stage", "march", "path", "window", "rung", "dense", "anchors",
         "per-point", "shape", "dtype"])
def test_stage_key_separates_stages(other):
    """A pyramid stage's key holds the stage, the path, the window, the
    compaction rung, the anchor count and its inputs' shapes and dtypes:
    two calls that differ in any one get keys of their own; the same call
    gets the same key."""
    assert _stage_key() == _stage_key()
    assert _stage_key(**other) != _stage_key()


def test_frames_capture_a_graph_a_stage_key(nets, fake_cuda_graphs):
    """One engine's frames capture each stage key once and replay it after:
    the grid and taps paths three keys each, the rotated path one march
    and a refine pair a rung; a second round of the same frames captures
    nothing."""
    eng = _graphed(_engine(nets))
    image = nets[2]
    frames = [(None, None), (INPLANE_CALIB, None), (ROT_CALIB, 0.3),
              (ROT_CALIB, 0.45)]
    for calib, hint in frames:
        eng.frame(image, image, calib, compact_hint=hint)
    assert eng.graphs.counts["recon"] == {"capture": 3 + 3 + 1 + 4,
                                          "replay": 1, "eager": 0}
    for calib, hint in frames:
        eng.frame(image, image, calib, compact_hint=hint)
    assert eng.graphs.counts["recon"] == {"capture": 11, "replay": 13,
                                          "eager": 0}
    keys = [k[1] for k in eng.graphs._graphs if k[0] == "recon"]
    assert len(keys) == len(set(keys)) == 11
    assert {k[2] for k in keys} == {"grid", "taps", "rotated"}


def _pyramid_maps(eng, image, calib, hint):
    """A march frame's surface the plain way: ``ray_pyramid`` over the
    frame's query closures, on the eager backbone's maps. -> (SurfaceMaps,
    the refine levels' dropped counts)."""
    from monoport_tpu_torch.recon.ray_refine import ray_pyramid

    calib = np.eye(4, dtype=np.float32)[None] if calib is None else calib
    calib_t = torch.from_numpy(calib)
    ray_g = eng._calib_taps_ok(calib)
    compact = (None if ray_g else tengine._snap_budget(
        hint, eng.config.rotated.compact) if hint else
        eng.config.rotated.compact)
    plan = () if ray_g else eng._rot_anchor_plan(calib, image.shape[1])
    with torch.no_grad():
        feats = eng._filter_g(image)
        if ray_g:
            taps = eng._query_taps_fn(feats, calib_t)
        else:
            taps = [eng._query_anchored_fn(feats, calib_t, k) if k else None
                    for k in plan]
        grid = (eng._query_grid_fn(feats, calib_t)
                if eng._calib_grid_ok(calib) else None)
        dropped = []
        maps = ray_pyramid(
            eng._query_occ_fn(feats, calib_t), FINE, levels=LEVELS,
            taps=TAPS, balance_value=eng.recon.balance_value,
            b_min=eng.recon.b_min, b_max=eng.recon.b_max, window=WINDOW,
            query_taps_fn=taps, query_grid_fn=grid, march_taps=ray_g,
            compact=compact, telemetry=dropped, device="cpu")
    return maps, dropped


@pytest.mark.parametrize("calib,hint,path", [
    (None, None, "grid"), (INPLANE_CALIB, None, "taps"),
    (ROT_CALIB, 0.3, "rotated")])
def test_cpu_march_frames_run_eager(nets, calib, hint, path):
    """On the CPU a march frame's three stages run eagerly (the recon count
    and each stage span's ``graph`` read ``eager``), and its depth, valid
    and refine-level dropped counts equal ``ray_pyramid``'s over the same
    queries."""
    eng = _engine(nets)
    image = nets[2]
    rec, (out,) = _recorded(eng, nets, calib, hint)
    assert rec.spans[0].attrs["path"] == path
    assert eng.graphs.counts["recon"] == {"capture": 0, "replay": 0,
                                          "eager": 3}
    assert [s.attrs["graph"] for s in rec.spans
            if s.name in ("recon.march", "recon.refine")] == ["eager"] * 3
    maps, dropped = _pyramid_maps(eng, image, calib, hint)
    assert torch.equal(out["depth"], maps.depth)
    assert torch.equal(out["valid"], maps.valid)
    if dropped:
        assert torch.equal(out["compact_dropped"][:len(dropped)],
                           torch.stack(dropped))


def test_replayed_stages_make_their_capture_records(nets, fake_cuda_graphs):
    """The query records of a stage, collected while it is captured with no
    recorder on, are made again at each replay under the stage's span:
    a recorded replaying frame has the eager frame's records (rows, taps,
    anchors, span), its stage spans read ``replay``."""
    image = nets[2]
    want, _ = _recorded(_engine(nets), nets, ROT_CALIB, 0.3)
    eng = _graphed(_engine(nets))
    eng.frame(image, image, ROT_CALIB, compact_hint=0.3)   # the captures
    rec, _ = _recorded(eng, nets, ROT_CALIB, 0.3)

    def rows(r):
        return [(q.name, q.rows, q.taps, q.anchors, q.span.name,
                 q.span.attrs.get("from"), q.frame) for q in r.queries]

    assert rows(rec) == rows(want)
    assert any(q.anchors for q in rec.queries)
    assert [s.attrs["graph"] for s in rec.spans
            if s.name in ("recon.march", "recon.refine")] == ["replay"] * 3


def test_replayed_stages_count_their_launches(nets, fake_cuda_graphs,
                                              monkeypatch):
    """A stage call adds its kernels' launches to the counters once,
    captured or replayed, as an eager call does: the capture's warm call
    and recording are wound back."""
    from monoport_tpu_torch.ops.cuda.fused_mlp import apply_mlp
    from monoport_tpu_torch.ops.cuda.fused_ray_mlp import apply_anchor

    def counted(fn, counter):
        def launch(*args):
            counter.launches += 1
            return fn(*args)
        return launch

    image = nets[2]
    got = []
    for graphed in (False, True):
        eng = _engine(nets)
        if graphed:
            _graphed(eng)
        eng.point_g = counted(eng.point_g, apply_mlp)
        eng.anchor_g = counted(eng.anchor_g, apply_anchor)
        monkeypatch.setattr(apply_mlp, "launches", 0)
        monkeypatch.setattr(apply_anchor, "launches", 0)
        for _ in range(3):
            eng.frame(image, image, ROT_CALIB, compact_hint=0.3)
        got.append((apply_mlp.launches, apply_anchor.launches))
    plan = _engine(nets)._rot_anchor_plan(ROT_CALIB, 64)
    per_frame = (1 + sum(1 for k in plan if not k), sum(1 for k in plan if k))
    assert got == [tuple(3 * n for n in per_frame)] * 2


def test_collecting_takes_this_threads_queries():
    """``collecting`` takes the block's queries from the recorder into its
    list, on its thread alone; blocks nest."""
    with profiling.recording() as rec:
        with profiling.collecting() as outer:
            profiling.query("a", 3, taps=2)
            with profiling.collecting() as inner:
                profiling.query("b", 5, anchors=4)
            t = threading.Thread(target=profiling.query, args=("c", 7))
            t.start()
            t.join(timeout=30)
        profiling.query("d", 9)
    assert outer == [("a", 3, 2, 0)]
    assert inner == [("b", 5, 1, 4)]
    assert [(q.name, q.rows) for q in rec.queries] == [("c", 7), ("d", 9)]
    with profiling.collecting() as off:
        profiling.query("e", 1)
    assert off == [("e", 1, 1, 0)]

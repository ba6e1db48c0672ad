"""The program's own spans and query records in a traced run.

``ReconEngine.frame`` marks its layers with ``utils/profiling.span`` and
each head query with ``profiling.query``; a recorder
(``profiling.recording``) keeps them in memory, stamped on the
profiler's clock. Once a traced run, after the cell's profiled stretch,
``readings`` runs two more stretches of ``FRAMES`` frames each,
continuing the traffic's order after one lead-in frame that gives the
hint:

1. the recorder alone, the profiler off: host milliseconds by span (each
   span's whole time and its self time, its time less its children's),
   rows by query, the frames' paths, rungs and plans, and the stretch's
   frames a second beside the window's (the stretch follows the run's
   profiled stretches, whose profiler slows the host after it stops too:
   its rate is no measure of the recorder's cost);
2. the recorder under ``torch.profiler``: each device operation goes to
   the innermost program span open on the host when it was launched (the
   operation's correlation id joined to the host's CUDA API call that
   launched it), and each idle gap of the device, within the stretch, to
   the innermost program span open at its middle.

A program without a recorder gives nothing to read (``readings`` is
None) and runs no extra frame. The reductions are plain functions of
(start, end, name, ...) tuples, tested on hand-made events. This module
imports nothing of the program but ``monoport_tpu_torch.utils.profiling``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import heapq
import json
import time
from collections import Counter, defaultdict

FRAMES = 20
ROOT = "engine.frame"              # the program's span of one frame
MARK = "cardbench.spans"           # a frame of the traced stretch
LAYERS = ("backbone.", "recon.", "texture.", "render.")
NO_SPAN = "(no span)"
UNLINKED = "(unlinked)"


def program_profiling():
    """The program's profiling module where it records spans, else None."""
    from monoport_tpu_torch.utils import profiling

    return profiling if hasattr(profiling, "recording") else None


# -- reductions over plain tuples ------------------------------------------
def span_tuples(rec) -> list:
    """A recorder's finished spans as (start_ns, end_ns, name, parent)
    with ``parent`` the index of the parent span, or None."""
    index = {id(s): i for i, s in enumerate(rec.spans)}
    return [(s.start_ns, s.end_ns, s.name,
             None if s.parent is None else index[id(s.parent)])
            for s in rec.spans if s.end_ns is not None]


def host_times(spans) -> dict:
    """name -> [whole ns, self ns, count]: a span's self time is its time
    less its children's."""
    out: dict = defaultdict(lambda: [0, 0, 0])
    child_ns = defaultdict(int)
    for s, e, _, parent in spans:
        if parent is not None:
            child_ns[parent] += e - s
    for i, (s, e, name, _) in enumerate(spans):
        out[name][0] += e - s
        out[name][1] += e - s - child_ns[i]
        out[name][2] += 1
    return dict(out)


def layer_ns(spans, prefix: str):
    """Host ns in spans named ``prefix...``, each counted once (a span
    inside another of the layer is not added again); None when no span
    of the layer ran."""
    found, total = False, 0
    for s, e, name, parent in spans:
        if name.startswith(prefix):
            found = True
            if parent is None or not spans[parent][2].startswith(prefix):
                total += e - s
    return total if found else None


def innermost(points, spans) -> list:
    """The name of the innermost span open at each time of ``points`` (the
    latest-started of those open), NO_SPAN where none is, in the order of
    ``points``."""
    spans = sorted(spans)
    order = sorted(range(len(points)), key=lambda k: points[k])
    out = [NO_SPAN] * len(points)
    open_spans: list = []                      # heap of (end, -start, name)
    i = 0
    for k in order:
        t = points[k]
        while i < len(spans) and spans[i][0] <= t:
            heapq.heappush(open_spans, (spans[i][1], -spans[i][0],
                                        spans[i][2]))
            i += 1
        while open_spans and open_spans[0][0] < t:
            heapq.heappop(open_spans)
        if open_spans:
            out[k] = min(open_spans, key=lambda o: o[1])[2]
    return out


def device_by_span(spans, device) -> dict:
    """Device ns by the innermost span open at each operation's launch.
    ``device``: (start_ns, end_ns, name, launch_ns or None); an operation
    whose launch was not found goes to UNLINKED."""
    out: dict = defaultdict(int)
    linked = [d for d in device if d[3] is not None]
    for d, name in zip(linked, innermost([d[3] for d in linked], spans)):
        out[name] += d[1] - d[0]
    for d in device:
        if d[3] is None:
            out[UNLINKED] += d[1] - d[0]
    return dict(out)


def device_by_span_op(spans, device) -> dict:
    """Device ns by (the innermost span open at each operation's launch,
    the operation's name); unlinked operations go to UNLINKED."""
    out: dict = defaultdict(int)
    linked = [d for d in device if d[3] is not None]
    for d, name in zip(linked, innermost([d[3] for d in linked], spans)):
        out[name, d[2]] += d[1] - d[0]
    for d in device:
        if d[3] is None:
            out[UNLINKED, d[2]] += d[1] - d[0]
    return dict(out)


def idle_by_span(spans, device, window) -> dict:
    """Idle ns of the device within ``window`` (t0, t1), each gap by the
    innermost span open at its middle."""
    t0, t1 = window
    merged: list = []
    for s, e in sorted((max(d[0], t0), min(d[1], t1)) for d in device
                       if d[1] > t0 and d[0] < t1):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    edges = [t0] + [x for iv in merged for x in iv] + [t1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    out: dict = defaultdict(int)
    for (a, b), name in zip(gaps, innermost([(a + b) / 2 for a, b in gaps],
                                            spans)):
        out[name] += b - a
    return dict(out)


def profiled_ops(events, mark: str = MARK):
    """(device ops as ``device_by_span`` takes them, the marked frames'
    (start_ns, end_ns)) from the profiler's events (``name``,
    ``device_type``, ``start_ns``, ``duration_ns``, ``correlation_id``).
    On the card every event but an annotation (``cardbench.*``) is a
    device operation, as ``trace.reduce`` counts them; it joins the host's
    CUDA API call (``cu*``) of the same CUPTI correlation id."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    runtime, device, marks = {}, [], []
    for e in events:
        name, start = e.name(), e.start_ns()
        if e.device_type() == cuda:
            if not name.startswith("cardbench."):
                device.append((start, start + e.duration_ns(), name,
                               e.correlation_id()))
        elif name.startswith("cu"):
            runtime[e.correlation_id()] = start
        elif name == mark:
            marks.append((start, start + e.duration_ns()))
    return ([(s, e, name, runtime.get(cid)) for s, e, name, cid in device],
            sorted(marks))


# -- the stretches -----------------------------------------------------------
def _frames(cell, start: int, frames: int, hint, mark=None):
    """Frames ``start`` .. ``start + frames - 1`` in a closed loop, each
    synchronised, under ``mark()`` when given; -> (seconds, next hint)."""
    t0 = time.perf_counter()
    for i in range(start, start + frames):
        with mark() if mark is not None else contextlib.nullcontext():
            out = cell.frame(i, hint)
            cell._sync()
        hint = cell.hint_after(out)
    return time.perf_counter() - t0, hint


@dataclasses.dataclass
class Readings:
    frames: int                    # frames of each stretch
    host_ms: dict                  # span name -> [whole, self] ms a frame
    layer_host_ms: dict            # layer prefix -> ms a frame (None: no span)
    device_ms: dict                # span name -> device ms a frame
    idle_ms: dict                  # span name -> idle ms a frame
    rows: dict                     # query name -> rows a frame
    layer_rows: dict               # layer prefix -> rows a frame
    plans: dict                    # "path rung plan" -> frames
    recorded_fps: float
    traced_fps: float
    # (span name, device op name) -> device ms a frame
    op_ms: dict = dataclasses.field(default_factory=dict)
    traced_from: int | None = None  # the traced stretch's first frame

    def layer_device_ms(self, prefix: str):
        """Device ms a frame launched in the layer's spans; None when no
        span of the layer ran."""
        if self.layer_host_ms.get(prefix) is None:
            return None
        return sum(v for k, v in self.device_ms.items()
                   if k.startswith(prefix))


def traced_stretch(cell, prof, start: int, frames: int, hint):
    """(recorder, profiler, seconds) of frames under both."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if cell.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as p, prof.recording() as rec:
        seconds, _ = _frames(cell, start, frames, hint,
                             mark=lambda: record_function(MARK))
    return rec, p, seconds


def reduce(rec_host, rec_dev, device, marks, frames: int, seconds: dict,
           traced_from: int | None = None):
    """Readings from the two stretches' recorders, the traced stretch's
    device ops and marked frames (from frame ``traced_from``), and each
    stretch's seconds."""
    spans = span_tuples(rec_host)
    per = 1e6 * frames                          # ns over the stretch -> ms
    host = {k: [v[0] / per, v[1] / per]
            for k, v in host_times(spans).items()}
    layer_host = {p: (None if (ns := layer_ns(spans, p)) is None
                      else ns / per) for p in LAYERS}
    dev_spans = span_tuples(rec_dev)
    window = (marks[0][0], marks[-1][1]) if marks else None
    device_ms = {k: v / per for k, v in device_by_span(dev_spans,
                                                       device).items()}
    op_ms = {k: v / per for k, v in device_by_span_op(dev_spans,
                                                      device).items()}
    idle_ms = ({k: v / per for k, v in idle_by_span(dev_spans, device,
                                                     window).items()}
               if window and device else {})
    rows: dict = defaultdict(int)
    layer_rows: dict = defaultdict(int)
    for q in rec_host.queries:
        rows[q.name] += q.rows
        if q.span is not None:
            for p in LAYERS:
                if q.span.name.startswith(p):
                    layer_rows[p] += q.rows
    plans = Counter(
        f"{s.attrs.get('path')} {s.attrs.get('rung')} "
        f"{tuple(s.attrs.get('plan', ()))}"
        for s in rec_host.spans if s.name == ROOT)
    return Readings(
        frames=frames, host_ms=host, layer_host_ms=layer_host,
        device_ms=device_ms, idle_ms=idle_ms,
        rows={k: v / frames for k, v in rows.items()},
        layer_rows={k: v / frames for k, v in layer_rows.items()},
        plans=dict(plans), recorded_fps=frames / seconds["recorded"],
        traced_fps=frames / seconds["traced"], op_ms=op_ms,
        traced_from=traced_from)


def roofline(ctx, span: str, net: str, kernels) -> float | None:
    """A kernel's share of its roofline, in percent, on a path whose rows
    follow the image: the least time of ``net``'s head queries in the
    traced frames (``work.queries_bound_s`` of the rows the reference
    gives each frame's image, ``Cell.head_rows``) over the device time of
    the operations named by any of ``kernels`` and launched inside
    ``span`` (by name and span: the port's f32 kernels 1 and 2 share
    names). None on the 'ray' path, without spans, or where the kernel
    did not run."""
    from . import work

    cell = ctx.cell
    if cell.config["profile"]["mode"] == "ray":
        return None
    r = readings(ctx)
    if r is None:
        return None
    ms = sum(v for (s, name), v in r.op_ms.items()
             if s == span and any(k in name for k in kernels))
    if ms <= 0.0:
        return None
    bound = 0.0
    for i in range(r.traced_from, r.traced_from + r.frames):
        body, pose = cell.traffic.frame(i)
        bound += work.queries_bound_s(cell.config, cell.traffic.calibs[pose],
                                      cell.head_rows(body, pose), net)
    return 100.0 * bound / r.frames / (ms * 1e-3)


def _info(kind: str, **fields) -> None:
    print(json.dumps({"info": kind, **fields}, default=str), flush=True)


def readings(ctx):
    """The cell's Readings (run once, cached on the cell), or None where
    the program records no spans."""
    cell = ctx.cell
    if hasattr(cell, "span_readings"):
        return cell.span_readings
    cell.span_readings = None
    prof = program_profiling()
    if prof is None or cell.engine is None:
        return None
    import torch

    start = ctx.window.frames + ctx.trace.frames
    with torch.inference_mode():
        _, hint = _frames(cell, start, 1, None)              # the lead-in
        with prof.recording() as rec_host:
            s_host, hint = _frames(cell, start + 1, FRAMES, hint)
        rec_dev, p, s_dev = traced_stretch(cell, prof, start + 1 + FRAMES,
                                           FRAMES, hint)
    device, marks = profiled_ops(p.profiler.kineto_results.events())
    r = reduce(rec_host, rec_dev, device, marks, FRAMES,
               {"recorded": s_host, "traced": s_dev},
               traced_from=start + 1 + FRAMES)
    cell.span_readings = r
    window_fps = ctx.window.frames / ctx.window.elapsed
    dev_total = sum(r.device_ms.values())
    in_layers = sum(v for k, v in r.device_ms.items()
                    if k.startswith(LAYERS))
    frame_ms = r.host_ms.get(ROOT, [0.0, 0.0])[0]
    skew = _mark_skew(rec_dev, marks)
    _info("spans", frames=FRAMES, recorded_fps=r.recorded_fps,
          window_fps=window_fps, traced_fps=r.traced_fps,
          frame_share_of_wall=frame_ms * r.recorded_fps / 1e3,
          host_ms=r.host_ms, layer_host_ms=r.layer_host_ms,
          device_ms=r.device_ms, idle_ms=r.idle_ms,
          device_ms_total=dev_total,
          device_share_in_layers=(in_layers / dev_total if dev_total
                                  else None),
          device_ops=len(device),
          unlinked_ops=sum(1 for d in device if d[3] is None),
          mark_to_frame_us=skew)
    _info("queries", rows=r.rows, layer_rows=r.layer_rows, plans=r.plans)
    return r


def _mark_skew(rec, marks):
    """Median microseconds from each marked frame's start to its
    ``engine.frame`` span's start: the two clocks' agreement (within a
    few microseconds) plus the harness's host work before the call."""
    starts = sorted(s.start_ns for s in rec.spans if s.name == ROOT)
    if not starts or len(starts) != len(marks):
        return None
    d = sorted((s - m[0]) / 1e3 for s, m in zip(starts, marks))
    return d[len(d) // 2]

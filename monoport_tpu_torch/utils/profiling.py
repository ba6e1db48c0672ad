"""Profiling utilities (port of ``monoport_tpu/utils/profiling.py``), and
the program's own spans and query counters.

``device_time`` times ``iters`` calls of a function, each call's input
made to depend on the previous call's output, so the calls cannot overlap
or be skipped: on the card between two CUDA events, on the CPU by the
host clock. ``trace`` records a ``torch.profiler`` trace with the
program's spans on a track of their own, written as a Chrome trace file
(chrome://tracing, Perfetto).

Spans and queries. The engine marks its layers with ``span(name,
**attrs)`` (a context manager) and each head query with ``query(name,
rows, taps, anchors, views)`` (``views``: the views pooled a row of a
multi-view net's query; ``rows`` still counts points). Both do nothing unless a recorder is on
(``recording()``) or, for a query, a ``collecting`` block: the off path is
a module-level check (a span's returns a shared no-op context), with no
clock reading and no ``record_function``.
A recorder keeps, in memory, each span's name, start and end, parent,
frame id and attributes, and each query's rows under the span open at
the call; a stack a thread, since the served demo runs the engine in a
stage thread. A frame is the span named ``FRAME``: its id is the order
of its start, and every span and query under it carries that id.

A CUDA graph replays its kernels without the Python that made its
queries, so ``collecting()`` takes this thread's query records into a list
of its own, whether or not a recorder is on, for the graph's owner to make
again at each replay (``frame_graphs.py``).

Stamps are ``time.time_ns()``, the clock of ``torch.profiler``'s events
(``_KinetoEvent.start_ns``), so spans and the profiler's host and device
events share one time base. Nothing here reads a device value,
synchronises or allocates a tensor.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Callable, NamedTuple, Optional

import torch

FRAME = "engine.frame"

_RECORDER: Optional["Recorder"] = None       # the recorder on, if any
_SINKS: dict = {}          # thread ident -> the list a ``collecting`` fills


def _first_tensor(out) -> torch.Tensor:
    """The first tensor of a (nested) output, in order."""
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    for leaf in out:
        if isinstance(leaf, (torch.Tensor, dict, list, tuple)):
            return _first_tensor(leaf)
    raise TypeError("the output holds no tensor")


def _default_chain(a, out):
    """``a`` plus 1e-12 times the sum of the output's first tensor."""
    leaf = _first_tensor(out)
    return a + (leaf.float().sum() * 1e-12).to(a.dtype)


@torch.no_grad()
def device_time(fn: Callable, arg, chain: Optional[Callable] = None,
                iters: int = 20) -> float:
    """Seconds per call of ``fn(arg)``.

    ``chain(arg, out) -> arg`` makes call i+1 depend on call i's output
    (default: add 1e-12 times the sum of its first tensor). After one
    warm-up call, ``iters`` chained calls are timed: on the card between
    two CUDA events, on the CPU by the host clock."""
    chain = chain or _default_chain
    a = chain(arg, fn(arg))                              # warm-up
    if _first_tensor(a).device.type == "cuda":
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            a = chain(a, fn(a))
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        a = chain(a, fn(a))
    _ = _first_tensor(a).sum().item()
    return (time.perf_counter() - t0) / iters


# -- spans and queries --------------------------------------------------------
class Span:
    """One span: ``name``, ``start_ns`` / ``end_ns`` (``time.time_ns``;
    ``end_ns`` None while open), ``parent`` (the Span open around it on
    its thread, or None), ``frame`` (the id of the frame it belongs to, or
    None), ``attrs`` and ``thread`` (the thread's ident). Entering it
    returns the span itself, so a caller may add attributes it learns
    inside."""

    __slots__ = ("name", "attrs", "start_ns", "end_ns", "parent", "frame",
                 "thread", "_rec")

    def __init__(self, rec: "Recorder", name: str, attrs: dict):
        self._rec = rec
        self.name = name
        self.attrs = attrs
        self.end_ns = None

    def __enter__(self) -> "Span":
        rec = self._rec
        stack = rec._stack()
        parent = stack[-1] if stack else None
        self.parent = parent
        if self.name == FRAME:
            self.frame = next(rec._frame_ids)
        else:
            self.frame = parent.frame if parent is not None else None
        self.thread = threading.get_ident()
        rec.spans.append(self)
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        self._rec._stack().pop()
        return False

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, frame={self.frame}, "
                f"{self.start_ns}..{self.end_ns}, {self.attrs})")


class Query(NamedTuple):
    """One head query: ``rows`` asked for (points, or rays with ``taps``
    z-taps each and ``anchors`` feature anchors a ray; 0 = none), under
    ``span`` (the innermost span open at the call) of ``frame``; a point
    of a multi-view query is ``views`` head rows, pooled."""
    name: str
    rows: int
    taps: int
    anchors: int
    span: Optional[Span]
    frame: Optional[int]
    views: int = 1


class Recorder:
    """What ``recording()`` keeps: ``spans`` in the order they opened and
    ``queries`` in the order they were made. Nothing is written until a
    caller reads them."""

    def __init__(self):
        self.spans: list = []
        self.queries: list = []
        self._local = threading.local()
        self._frame_ids = itertools.count()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _query(self, name: str, rows: int, taps: int, anchors: int,
               views: int = 1):
        stack = self._stack()
        top = stack[-1] if stack else None
        self.queries.append(Query(name, int(rows), int(taps), int(anchors),
                                  top, top.frame if top is not None
                                  else None, int(views)))


class _Off:
    """The context ``span`` returns while no recorder is on."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def span(name: str, **attrs):
    """A span around the block (a context manager; entering gives the
    Span, or None while no recorder is on)."""
    rec = _RECORDER
    if rec is None:
        return _OFF
    return Span(rec, name, attrs)


def query(name: str, rows: int, taps: int = 1, anchors: int = 0,
          views: int = 1) -> None:
    """Record one head query of ``rows`` rows (host-side shapes, before
    any sharding) under the span open on this thread; nothing while no
    recorder is on. Inside a ``collecting`` block of this thread the
    record goes to its list instead (with ``views`` last where it is not
    1)."""
    if _SINKS:
        sink = _SINKS.get(threading.get_ident())
        if sink is not None:
            sink.append((name, int(rows), int(taps), int(anchors))
                        + ((int(views),) if views != 1 else ()))
            return
    rec = _RECORDER
    if rec is not None:
        rec._query(name, rows, taps, anchors, views)


@contextlib.contextmanager
def collecting():
    """A list of the (name, rows, taps, anchors) of each ``query`` this
    thread makes inside the block, which then reach no recorder; blocks
    nest, the innermost collects."""
    ident = threading.get_ident()
    outer = _SINKS.get(ident)
    sink: list = []
    _SINKS[ident] = sink
    try:
        yield sink
    finally:
        if outer is None:
            del _SINKS[ident]
        else:
            _SINKS[ident] = outer


@contextlib.contextmanager
def recording():
    """A Recorder on for the block (one at a time in a process)."""
    global _RECORDER
    if _RECORDER is not None:
        raise RuntimeError("a recorder is on already")
    rec = Recorder()
    _RECORDER = rec
    try:
        yield rec
    finally:
        _RECORDER = None


def _chrome_events(rec: Recorder, base_ns: int, pid: int) -> list:
    """The recorder's finished spans as Chrome trace events on the track
    ``pid`` (one row a thread), timestamps in microseconds after
    ``base_ns``; a span's queries go in its ``args``."""
    queries: dict = {}
    for q in rec.queries:
        queries.setdefault(id(q.span), []).append(
            {"name": q.name, "rows": q.rows, "taps": q.taps,
             "anchors": q.anchors})
    events = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
               "args": {"name": "program spans"}}]
    for s in rec.spans:
        if s.end_ns is None:
            continue
        args = dict(s.attrs, frame=s.frame)
        if id(s) in queries:
            args["queries"] = queries[id(s)]
        events.append({"ph": "X", "cat": "program_span", "name": s.name,
                       "pid": pid, "tid": s.thread,
                       "ts": (s.start_ns - base_ns) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3, "args": args})
    return events


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block (the CPU, and the card when there
    is one) with a recorder on, written to ``log_dir/trace.json`` as a
    Chrome trace: the program's spans on a track of their own ("program
    spans"), on the profiler's time base."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof, recording() as rec:
        yield log_dir
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        data = json.load(fh)
    events = data.setdefault("traceEvents", [])
    pids = [e["pid"] for e in events if isinstance(e.get("pid"), int)]
    events.extend(_chrome_events(rec, int(data.get("baseTimeNanoseconds", 0)),
                                max(pids, default=0) + 1))
    with open(path, "w") as fh:
        json.dump(data, fh, default=repr)

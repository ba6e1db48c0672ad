"""The device trace of a stretch of frames (``torch.profiler``, CPU and CUDA
activities) reduced to what the per-layer metrics read: every device
operation's name and interval, their union (the device's busy time), the
kernel launches, and the idle gaps by what the host was doing in them.

The window is the traced frames' own span on the profiler's clock, from
the first frame's start to the last frame's end (each frame is a
``cardbench.frame`` annotation around the call and its synchronize).
An idle gap is named by the innermost host operation running at its
middle.
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import defaultdict

FRAME = "cardbench.frame"
NOT_KERNELS = ("Memcpy", "Memset")


@dataclasses.dataclass
class Trace:
    frames: int
    window_s: float
    busy_s: float
    launches: int
    by_name: dict                  # device op name -> [seconds, count]
    gaps: dict                     # host op name -> idle seconds

    def top_ops(self, n: int = 10) -> list:
        return [[k, v[0]] for k, v in sorted(
            self.by_name.items(), key=lambda kv: -kv[1][0])[:n]]

    def top_gaps(self, n: int = 10) -> list:
        return [[k, v] for k, v in sorted(self.gaps.items(),
                                          key=lambda kv: -kv[1])[:n]]


def _events(prof):
    """(device ops, host ops): (start_ns, end_ns, name) of each."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        item = (start, start + e.duration_ns(), e.name())
        if e.device_type() != cuda:
            host.append(item)
        elif not item[2].startswith("cardbench."):   # not an annotation
            dev.append(item)
    return dev, host


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _name_gaps(gaps, host) -> dict:
    """Idle seconds by the innermost host op open at each gap's middle."""
    out: dict = defaultdict(float)
    host = sorted(host)
    order = sorted(gaps, key=lambda g: (g[0] + g[1]) / 2)
    open_ops: list = []                       # heap of (end, -start, name)
    i = 0
    for g0, g1 in order:
        mid = (g0 + g1) / 2
        while i < len(host) and host[i][0] <= mid:
            heapq.heappush(open_ops, (host[i][1], -host[i][0], host[i][2]))
            i += 1
        while open_ops and open_ops[0][0] < mid:
            heapq.heappop(open_ops)
        name = (max(open_ops, key=lambda o: -o[1])[2] if open_ops
                else "(no host op)")
        out[name] += (g1 - g0) / 1e9
    return dict(out)


def reduce(prof, frames: int) -> Trace:
    dev, host = _events(prof)
    spans = [h for h in host if h[2] == FRAME]
    if not spans or not dev:
        raise RuntimeError("the profiler recorded no frame or no device op")
    t0, t1 = min(s[0] for s in spans), max(s[1] for s in spans)
    dev = [(max(s, t0), min(e, t1), n) for s, e, n in dev if e > t0 and s < t1]
    merged = _union([(s, e) for s, e, _ in dev])
    busy = sum(e - s for s, e in merged)
    by_name: dict = defaultdict(lambda: [0.0, 0])
    for s, e, n in dev:
        by_name[n][0] += (e - s) / 1e9
        by_name[n][1] += 1
    edges = [t0] + [x for iv in merged for x in iv] + [t1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    return Trace(frames=frames, window_s=(t1 - t0) / 1e9, busy_s=busy / 1e9,
                 launches=sum(1 for _, _, n in dev
                              if not n.startswith(NOT_KERNELS)),
                 by_name=dict(by_name), gaps=_name_gaps(gaps, host))

"""Profiling utilities (port of ``monoport_tpu/utils/profiling.py``).

``device_time`` times ``iters`` calls of a function, each call's input
made to depend on the previous call's output, so the calls cannot overlap
or be skipped: on the card between two CUDA events, on the CPU by the
host clock. ``measure_rtt`` is the round trip of a tiny device result to
the host. ``trace`` records a ``torch.profiler`` trace, written as a
Chrome trace file (chrome://tracing, Perfetto).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import torch

from ..weights import resolve_device


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


def measure_rtt(samples: int = 3,
                device: Optional[torch.device | str] = None) -> float:
    """Seconds of a tiny device computation fetched to the host (on the
    card unless ``device`` names another, ``weights.resolve_device``)."""
    x = torch.ones(8, 8, device=resolve_device(device))
    _ = float((x * 2.0).sum())
    t0 = time.perf_counter()
    for i in range(samples):
        _ = float((x * float(i + 2)).sum())
    return (time.perf_counter() - t0) / samples


def _default_chain(a, out):
    """``a`` plus 1e-12 times the sum of the output's first tensor."""
    leaf = _first_tensor(out)
    return a + (leaf.float().sum() * 1e-12).to(a.dtype)


@torch.no_grad()
def device_time(fn: Callable, arg, chain: Optional[Callable] = None,
                iters: int = 20, rtt: Optional[float] = None) -> float:
    """Seconds per call of ``fn(arg)``.

    ``chain(arg, out) -> arg`` makes call i+1 depend on call i's output
    (default: add 1e-12 times the sum of its first tensor). After one
    warm-up call, ``iters`` chained calls are timed: on the card between
    two CUDA events (which need no round-trip correction: ``rtt`` is
    accepted, as the JAX package's signature has it, and ignored), on the
    CPU by the host clock."""
    del rtt
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


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block (the CPU, and the card when there
    is one), written to ``log_dir/trace.json`` as a Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))

"""A frame's stages, replayed from CUDA graphs.

A backbone call of a frame (netG's ``filter`` with the f32 upcast of its
maps; netC's ``filter`` over netG's last map as its prior, with its
upcast where the frame takes one) is ~1,000 cuDNN and ATen launches of
static shapes that read no device value on the host, and so is each stage
of the march pyramid (the dense march, each refine level; hundreds of
small ATen launches around the query kernels): launching them costs the
host several times their device time. So on the card ``FrameGraphs.run``
captures each call signature once, into a CUDA graph, and replays it
after: one copy of the inputs that need one and one graph launch a call.

The signature (``signature``) is the call's name (``netG``, ``netC``,
``recon``), what the caller says selects its work (``extra``: the
backbone's upcast; the pyramid stage, path, window, budget and anchors),
and each input's shape and dtype; an input that is an output of one of
these graphs (netC's prior, netG's maps that the recon stages read, the
previous stage's maps) is read in place, not copied, and its address
joins the signature.

Capture, the first call of a signature: the inputs are copied into static
buffers in their dtypes; one eager call on them picks cuDNN's algorithms,
fills the device constants' cache (``ops/constants``) and builds the
kernels; the call is then captured into a graph with a private memory
pool, in ``thread_local`` capture mode (the served demo's other stage
threads keep launching work meanwhile), and replayed. Replay, every later
call: the copied inputs are copied into the static buffers (a captured
launch reads the address it saw), then the graph is replayed. The outputs
are the graph's static tensors, which the next replay of the signature
overwrites: a caller reads them before its next call of that signature and
hands none of them out.

A call of any mode adds its work to the program's Python-side counts once:
the ``profiling.query`` records its captured call made, collected while it
was captured whether or not a recorder was on, are made again at each
capture and replay call, under the span open there, and the kernels'
launch counters (``COUNTERS``) gain the launches the capture saw. The
capture's own eager call and recording count nothing.

A replay runs the eager call's kernels in its order on the same
algorithms, so its outputs are bit-equal to the eager call's. On a device
other than CUDA, where the caller asks for an eager call, or where a
capture fails, the call runs eagerly as before. ``counts`` holds each
name's calls by mode (``MODES``).
"""

from __future__ import annotations

import warnings
from typing import Callable, Optional, Sequence

import torch

from .ops.constants import held
from .ops.cuda.fused_mlp import apply_mlp
from .ops.cuda.fused_ray_mlp import apply_anchor, apply_ray
from .ops.cuda.mix_rows import launch_mix_rows
from .utils import profiling

MODES = ("capture", "replay", "eager")
# the Python-side launch counters of the kernels a frame launches (each
# function's ``launches``)
COUNTERS = (apply_ray, apply_anchor, apply_mlp, launch_mix_rows)


def leaves(out) -> list:
    """The tensors of a nested list or tuple (named tuples included), in
    order; other leaves (a window's int side) are left out."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in leaves(o)]
    return []


def signature(name: str, inputs: Sequence[torch.Tensor], extra,
              pinned: Optional[dict] = None) -> tuple:
    """The key of a call: ``name``, ``extra`` (hashable), and each input's
    shape and dtype, with its address where it is the very tensor
    ``pinned`` (address -> tensor) holds there, else None."""
    pinned = pinned or {}
    return (name, extra) + tuple(
        (tuple(t.shape), t.dtype,
         t.data_ptr() if pinned.get(t.data_ptr()) is t else None)
        for t in inputs)


def _launches() -> list:
    return [f.launches for f in COUNTERS]


class _Graph:
    """One captured call: the tensors the graph reads (``static``, a
    buffer where ``copied``, else the input itself), the graph, its
    outputs, the device constants it reads, and what its captured call
    added to the Python-side counts (``records``: the query records;
    ``launches``: each counter's launches, as ``COUNTERS``)."""

    __slots__ = ("static", "copied", "graph", "outputs", "constants",
                 "records", "launches")

    def __init__(self, static, copied, graph, outputs, constants, records,
                 launches):
        self.static = static
        self.copied = copied
        self.graph = graph
        self.outputs = outputs
        self.constants = constants
        self.records = records
        self.launches = launches

    def replay(self, inputs):
        for buf, t, copy in zip(self.static, inputs, self.copied):
            if copy:
                buf.copy_(t)
        self.graph.replay()
        for q in self.records:
            profiling.query(*q)
        for f, n in zip(COUNTERS, self.launches):
            f.launches += n
        return self.outputs


class FrameGraphs:
    """A ReconEngine's graphed calls: a graph a signature on the card,
    eager elsewhere (module docstring)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.capturable = device.type == "cuda"
        self.counts: dict = {}              # name -> {mode: calls}
        self._graphs: dict = {}             # signature -> _Graph
        self._failed: set = set()           # signatures that stay eager
        self._pinned: dict = {}             # address -> a graph's output

    def run(self, name: str, fn: Callable, inputs: Sequence[torch.Tensor],
            dtypes: Optional[Sequence[torch.dtype]] = None, extra=None,
            capture: bool = True) -> tuple:
        """(``fn`` over ``inputs``, cast to ``dtypes`` on the device where
        given, the mode it ran in). ``fn`` returns nested lists or tuples
        of tensors; ``extra`` is the rest of the call's key (the work that
        ``fn`` selects from host values); ``capture`` False runs the call
        eagerly."""
        dtypes = dtypes or [t.dtype for t in inputs]
        counts = self.counts.setdefault(name, dict.fromkeys(MODES, 0))
        graph, mode = None, "eager"
        if self.capturable and capture:
            key = signature(name, inputs, extra, self._pinned)
            graph, mode = self._graphs.get(key), "replay"
            if graph is None and key not in self._failed:
                graph, mode = self._capture(key, fn, inputs, dtypes), "capture"
        if graph is None:
            mode = "eager"
            out = fn(*(t.to(device=self.device, dtype=d)
                       for t, d in zip(inputs, dtypes)))
        else:
            out = graph.replay(inputs)
        counts[mode] += 1
        return out, mode

    def _capture(self, key: tuple, fn: Callable, inputs, dtypes):
        """The signature's graph, captured after one eager warm call; None
        (and eager from now on) where the capture fails. Neither call
        counts: the query records go to a list, the launch counters are
        wound back."""
        copied = [k[2] is None for k in key[2:]]
        start = _launches()
        # plain tensors, not inference ones: the copies into the buffers
        # may run outside inference mode
        with torch.inference_mode(False), torch.no_grad(), \
                profiling.collecting():
            static = [torch.empty(t.shape, dtype=d, device=self.device)
                      if c else t for t, d, c in zip(inputs, dtypes, copied)]
            for buf, t, c in zip(static, inputs, copied):
                if c:
                    buf.copy_(t)
            fn(*static)
            warm = _launches()
            graph = torch.cuda.CUDAGraph()
            try:
                with held() as constants, profiling.collecting() as records, \
                        torch.cuda.graph(graph,
                                         capture_error_mode="thread_local"):
                    outputs = fn(*static)
            except RuntimeError as e:
                warnings.warn(f"{key[0]}: capture failed, its calls of this "
                              f"signature run eagerly: {e}")
                self._failed.add(key)
                return None
            finally:
                end = _launches()
                for f, a, b in zip(COUNTERS, start, end):
                    f.launches -= b - a
        g = _Graph(static, copied, graph, outputs, constants, records,
                   [b - a for a, b in zip(warm, end)])
        self._graphs[key] = g
        self._pinned.update((t.data_ptr(), t) for t in leaves(outputs))
        return g

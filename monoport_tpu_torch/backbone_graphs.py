"""The backbones' forward calls, replayed from CUDA graphs.

A backbone call of a frame (netG's ``filter`` with the f32 upcast of its
maps; netC's ``filter`` over netG's last map as its prior, with its
upcast where the frame takes one) is ~1,000 cuDNN and ATen launches of
static shapes that read no device value on the host, and launching them
costs the host several times their device time. So on the card
``BackboneGraphs.run`` captures each call signature once, into a CUDA
graph, and replays it after: one copy of the input and one graph launch
a call.

The signature (``signature``) is the net, whether its outputs are
upcast, and each input's shape and dtype; an input that is an output of
one of these graphs (netC's prior, netG's last map) is read in place, not
copied, and its address joins the signature.

Capture, the first call of a signature: the inputs are copied into static
buffers in the compute dtype; one eager call on them picks cuDNN's
algorithms and fills the device constants' cache (``ops/constants``); the
call is then captured into a graph with a private memory pool, in
``thread_local`` capture mode (the served demo's other stage threads keep
launching work meanwhile), and replayed. Replay, every later call: the
inputs are copied into the static buffers (a captured launch reads the
address it saw), then the graph is replayed. The outputs are the graph's
static tensors, which the next replay of the signature overwrites: a
caller reads them before its next call of that signature and hands none of
them out.

A replay runs the eager call's kernels in its order on the same
algorithms, so its outputs are bit-equal to the eager call's. On a device
other than CUDA, or where a capture fails, the call runs eagerly as
before. ``counts`` holds each net's calls by mode (``MODES``).
"""

from __future__ import annotations

import warnings
from typing import Callable, Optional, Sequence

import torch

from .ops.constants import held

MODES = ("capture", "replay", "eager")


def leaves(out) -> list:
    """The tensors of a nested list or tuple, in order."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in leaves(o)]


def signature(net: str, inputs: Sequence[torch.Tensor], upcast: bool,
              pinned: Optional[dict] = None) -> tuple:
    """The key of a backbone call: ``net``, ``upcast``, and each input's
    shape and dtype, with its address where it is the very tensor
    ``pinned`` (address -> tensor) holds there, else None."""
    pinned = pinned or {}
    return (net, upcast) + tuple(
        (tuple(t.shape), t.dtype,
         t.data_ptr() if pinned.get(t.data_ptr()) is t else None)
        for t in inputs)


class _Graph:
    """One captured call: the tensors the graph reads (``static``, a
    buffer where ``copied``, else the input itself), the graph, its
    outputs and the device constants it reads."""

    __slots__ = ("static", "copied", "graph", "outputs", "constants")

    def __init__(self, static, copied, graph, outputs, constants):
        self.static = static
        self.copied = copied
        self.graph = graph
        self.outputs = outputs
        self.constants = constants

    def replay(self, inputs):
        for buf, t, copy in zip(self.static, inputs, self.copied):
            if copy:
                buf.copy_(t)
        self.graph.replay()
        return self.outputs


class BackboneGraphs:
    """A ReconEngine's backbone calls: a graph a signature on the card,
    eager elsewhere (module docstring)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.capturable = device.type == "cuda"
        self.counts: dict = {}              # net -> {mode: calls}
        self._graphs: dict = {}             # signature -> _Graph
        self._failed: set = set()           # signatures that stay eager
        self._pinned: dict = {}             # address -> a graph's output

    def run(self, net: str, fn: Callable, inputs: Sequence[torch.Tensor],
            dtypes: Sequence[torch.dtype], upcast: bool) -> tuple:
        """(``fn`` over ``inputs`` cast to ``dtypes`` on the device, the
        mode it ran in). ``fn`` returns nested lists of tensors; ``upcast``
        says whether it upcasts them (part of the signature)."""
        counts = self.counts.setdefault(net, dict.fromkeys(MODES, 0))
        graph, mode = None, "eager"
        if self.capturable:
            key = signature(net, inputs, upcast, self._pinned)
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
        (and eager from now on) where the capture fails."""
        copied = [k[2] is None for k in key[2:]]
        # plain tensors, not inference ones: the copies into the buffers
        # may run outside inference mode
        with torch.inference_mode(False), torch.no_grad():
            static = [torch.empty(t.shape, dtype=d, device=self.device)
                      if c else t for t, d, c in zip(inputs, dtypes, copied)]
            for buf, t, c in zip(static, inputs, copied):
                if c:
                    buf.copy_(t)
            fn(*static)
            graph = torch.cuda.CUDAGraph()
            try:
                with held() as constants, torch.cuda.graph(
                        graph, capture_error_mode="thread_local"):
                    outputs = fn(*static)
            except RuntimeError as e:
                warnings.warn(f"backbone {key[0]}: capture failed, its calls "
                              f"of this signature run eagerly: {e}")
                self._failed.add(key)
                return None
        g = _Graph(static, copied, graph, outputs, constants)
        self._graphs[key] = g
        self._pinned.update((t.data_ptr(), t) for t in leaves(outputs))
        return g

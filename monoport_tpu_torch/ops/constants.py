"""Device-resident constants, uploaded once.

A host-to-device copy from pageable memory synchronises the stream, so a
constant built in numpy and copied on every frame (an interpolation
matrix, a tap offset vector) would stall the host behind the device at
each copy. ``device_constant`` uploads each one once per (arguments,
device, dtype); callers must not write to the tensors it returns.

A CUDA graph reads a constant at the address it had at capture, after the
cache may have dropped it; ``held`` lists the constants handed out inside
a block, for the graph's owner to keep.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Iterator

import numpy as np
import torch

_HOLDERS: list = []          # the lists of the ``held`` blocks open


@functools.lru_cache(maxsize=256)
def _uploaded(build: Callable[..., np.ndarray], args: tuple,
              device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return torch.as_tensor(build(*args), device=device).to(dtype)


def device_constant(build: Callable[..., np.ndarray], args: tuple,
                    device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``build(*args)`` as a tensor on ``device`` (``build`` is a module-level
    function, so the cache key is stable)."""
    t = _uploaded(build, args, device, dtype)
    for keep in _HOLDERS:
        keep.append(t)
    return t


@contextlib.contextmanager
def held() -> Iterator[list]:
    """A list of every constant ``device_constant`` hands out inside the
    block, on any thread."""
    keep: list = []
    _HOLDERS.append(keep)
    try:
        yield keep
    finally:
        _HOLDERS.remove(keep)


def float_array(values) -> np.ndarray:
    return np.asarray(values, np.float32)


def upload_async(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A per-frame host array on ``device`` without a stream sync: staged
    through pinned memory and copied asynchronously."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)

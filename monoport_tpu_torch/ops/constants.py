"""Device-resident constants, uploaded once.

A host-to-device copy from pageable memory synchronises the stream, so a
constant built in numpy and copied on every frame (an interpolation
matrix, a tap offset vector) would stall the host behind the device at
each copy. ``device_constant`` uploads each one once per (arguments,
device, dtype); callers must not write to the tensors it returns.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch


@functools.lru_cache(maxsize=256)
def device_constant(build: Callable[..., np.ndarray], args: tuple,
                    device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``build(*args)`` as a tensor on ``device`` (``build`` is a module-level
    function, so the cache key is stable)."""
    return torch.as_tensor(build(*args), device=device).to(dtype)


def float_array(values) -> np.ndarray:
    return np.asarray(values, np.float32)


def upload_async(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A per-frame host array on ``device`` without a stream sync: staged
    through pinned memory and copied asynchronously."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)

"""Flat-npz parameter files in the JAX package's format (port of
``monoport_tpu/utils/params_io.py``).

``save_params`` writes what ``monoport_tpu.utils.params_io.load_params``
reads: the flax parameter tree (``weights.flax_params_from_torch``: HWIO
convs, ``[in, out]`` dense kernels, ``scale`` / ``bias`` norms) under
'/'-joined keys, f16 on disk, and int metadata under ``__key__``. A net
trained by the port loads in the JAX package, and the JAX package's files
load here through ``load_params`` (``weights.load_params``) and
``weights.build_net``. As in the JAX package, the file holds parameters
only (no BatchNorm running stats); training checkpoints are the Trainer's.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..weights import flax_params_from_torch, load_params


def _flat(tree: dict, prefix: str = ""):
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            yield from _flat(value, name + "/")
        else:
            yield name, np.asarray(value)


def save_params(path: str, net_or_state: Any,
                meta: dict | None = None) -> None:
    """Save a module's parameters, a port ``state_dict`` or a flax params
    tree (+ scalar int metadata) as compressed f16 npz."""
    if isinstance(net_or_state, torch.nn.Module):
        net_or_state = net_or_state.state_dict()
    if all(isinstance(v, torch.Tensor) for v in net_or_state.values()):
        params = flax_params_from_torch(net_or_state)["params"]
    else:
        params = net_or_state
    arrays = {}
    for key, value in (meta or {}).items():
        # the sentinel is exactly two underscores each side; edge
        # underscores in the key itself would collide on load
        if key.startswith("_") or key.endswith("_"):
            raise ValueError(f"meta key {key!r} may not start or end with _")
        arrays[f"__{key}__"] = np.asarray(value, np.int32)
    for name, leaf in _flat(params):
        # f16 on disk is only lossless-enough for float weights
        if not np.issubdtype(leaf.dtype, np.floating):
            raise TypeError(f"{name}: not a float leaf ({leaf.dtype})")
        arrays[name] = leaf.astype(np.float16)
    np.savez_compressed(path, **arrays)


__all__ = ["save_params", "load_params"]

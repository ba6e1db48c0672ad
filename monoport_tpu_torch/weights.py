"""Weights bridge: the JAX package's flat-npz checkpoints into the port.

``load_params`` is a numpy-only copy of ``monoport_tpu/utils/params_io``
(f16 on disk, '/'-joined flax keys). ``torch_state_from_flax`` renames a
flax parameter tree (and its BatchNorm ``batch_stats``) to the port's
``state_dict`` names and layouts: Conv HWIO -> OIHW, Dense [in, out] ->
Linear [out, in], norm ``scale/bias`` -> ``weight/bias``, ``mean/var`` ->
``running_mean/running_var``; ``flax_params_from_torch`` is its inverse
(``utils/params_io.save_params`` writes with it). The port's modules
carry the flax module names, so the rename is mechanical; ``load_module``
loads such a tree into any of them (MonoPortNet through ``build_net``,
MatteNet, DetectNet; their checkpoints carry ``width`` / ``stride`` in the
meta).

The committed capsule-trained weights are not copied into the port's
package: ``load_default_networks`` reads them from ``DATA``, the JAX
package's ``monoport_tpu/data`` beside this package in the checkout (files
only; nothing of that package is imported). An install without that
directory passes its own ``data_dir``.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np
import torch

from .config import CN, get_cfg_defaults
from .models import MonoPortNet

DATA = os.path.join(os.path.dirname(__file__), os.pardir, "monoport_tpu",
                    "data")


def load_params(path: str) -> tuple[dict, dict]:
    """-> (nested param dict of f32 numpy arrays, int meta dict)."""
    params: dict = {}
    meta: dict = {}
    with np.load(path) as data:
        for name in data.files:
            if name.startswith("__") and name.endswith("__"):
                meta[name[2:-2]] = int(data[name])
                continue
            node = params
            parts = name.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = np.asarray(data[name], np.float32)
    return params, meta


def _flatten(tree: Any, prefix: str = ""):
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if hasattr(value, "items"):
            yield from _flatten(value, name + ".")
        else:
            yield name, np.asarray(value, np.float32)


def _split(variables: Any) -> tuple[Any, Any]:
    """(params, batch_stats) of flax variables or of a bare params tree."""
    if "params" in variables and set(variables) <= {"params", "batch_stats"}:
        return variables["params"], variables.get("batch_stats", {})
    return variables, {}


def torch_state_from_flax(variables: Any) -> dict[str, torch.Tensor]:
    """Flax variables (numpy leaves) -> torch ``state_dict`` (f32).

    ``variables`` is a params tree or ``{'params': ..., 'batch_stats':
    ...}``; each BatchNorm's ``mean`` / ``var`` become ``running_mean`` /
    ``running_var``, with ``num_batches_tracked`` 0 (flax keeps no count;
    the update uses a fixed momentum and never reads it)."""
    params, stats = _split(variables)
    state = {}
    for name, value in _flatten(params):
        base, leaf = name.rsplit(".", 1)
        if leaf == "kernel" and value.ndim == 4:       # HWIO -> OIHW
            value = value.transpose(3, 2, 0, 1)
        elif leaf == "kernel" and value.ndim == 2:     # [in, out] -> [out, in]
            value = value.T
        elif leaf not in ("kernel", "scale", "bias"):
            raise KeyError(f"unexpected flax leaf {name!r}")
        leaf = "bias" if leaf == "bias" else "weight"
        state[f"{base}.{leaf}"] = torch.tensor(value)
    for name, value in _flatten(stats):
        base, leaf = name.rsplit(".", 1)
        if leaf not in ("mean", "var"):
            raise KeyError(f"unexpected flax batch_stats leaf {name!r}")
        state[f"{base}.running_{leaf}"] = torch.tensor(value)
        state[f"{base}.num_batches_tracked"] = torch.tensor(0)
    return state


def flax_params_from_torch(state: dict[str, torch.Tensor]) -> dict:
    """A port ``state_dict`` -> flax variables ``{'params': ...}`` (plus
    ``'batch_stats'`` where the state has BatchNorm running stats), f32
    numpy leaves in the flax layouts: the inverse of
    ``torch_state_from_flax`` (``num_batches_tracked`` is dropped, as flax
    keeps no count)."""
    variables: dict = {"params": {}}
    for name, value in state.items():
        base, leaf = name.rsplit(".", 1)
        if leaf == "num_batches_tracked":
            continue
        value = value.detach().cpu().float().numpy()
        if leaf in ("running_mean", "running_var"):
            tree, leaf = variables.setdefault("batch_stats", {}), leaf[8:]
        elif leaf == "weight":
            tree = variables["params"]
            leaf = {4: "kernel", 2: "kernel", 1: "scale"}[value.ndim]
            if value.ndim == 4:                        # OIHW -> HWIO
                value = value.transpose(2, 3, 1, 0)
            elif value.ndim == 2:                      # [out, in] -> [in, out]
                value = value.T
        elif leaf == "bias":
            tree = variables["params"]
        else:
            raise KeyError(f"unexpected state entry {name!r}")
        for part in base.split("."):
            tree = tree.setdefault(part, {})
        tree[leaf] = np.array(value, np.float32)   # a copy, not a view
    return variables


def _as_state(weights: Any) -> dict[str, torch.Tensor]:
    """A port ``state_dict`` (flat, tensor values: the converter's output)
    as it is; flax variables through ``torch_state_from_flax``."""
    if all(isinstance(v, torch.Tensor) for v in weights.values()):
        return dict(weights)
    return torch_state_from_flax(weights)


def head_channels(weights: Any) -> tuple[int, ...]:
    """Head widths (``infer_head_channels`` of the JAX package) from
    weights as ``build_net`` takes them: the input width of layer 0, then
    every layer's output width."""
    state = _as_state(weights)
    n = sum(1 for k in state
            if k.startswith("surface_classifier.") and k.endswith(".weight"))
    w = [state[f"surface_classifier.filters_{i}.weight"] for i in range(n)]
    return (w[0].shape[1], *(wi.shape[0] for wi in w))


def build_net(opt_net, weights: Any,
              device: Optional[torch.device | str] = None) -> MonoPortNet:
    """MonoPortNet with its head widths read from ``weights``, loaded
    strictly, in eval mode, on ``device`` (``resolve_device``: the card
    unless the caller asks for another device). ``weights`` is a flax
    params tree ({'image_filter': ..., 'surface_classifier': ...}), flax
    variables with ``batch_stats``, or a port ``state_dict``
    (``convert.load_legacy_pifu``)."""
    state = _as_state(weights)
    net = MonoPortNet(opt_net, head_channels=head_channels(state))
    return load_module(net, state, device)


def load_module(module: torch.nn.Module, weights: Any,
                device: Optional[torch.device | str] = None
                ) -> torch.nn.Module:
    """``module`` with ``weights`` (as ``build_net`` takes them) loaded
    strictly, in eval mode, without gradients, on ``device``
    (``resolve_device``)."""
    device = resolve_device(device)
    module.load_state_dict(_as_state(weights), strict=True)
    module.requires_grad_(False)
    return module.eval().to(device)


def resolve_device(device: Optional[torch.device | str]) -> torch.device:
    """The entry-point device rule: ``cuda`` unless the caller asks for
    another device; never a silent fall back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the port "
                "on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def load_default_networks(device: Optional[torch.device | str] = None,
                          cfg: Optional[CN] = None, data_dir: str = DATA):
    """The committed capsule-trained netG and netC at their published
    widths (``net{g,c}_capsule.npz`` in ``data_dir``) -> (netG, netC)."""
    device = resolve_device(device)
    cfg = cfg or get_cfg_defaults()
    nets = []
    for key, fname in (("netG", "netg_capsule.npz"),
                       ("netC", "netc_capsule.npz")):
        params, _ = load_params(os.path.join(data_dir, fname))
        nets.append(build_net(cfg[key], params, device))
    return tuple(nets)

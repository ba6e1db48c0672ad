"""Weights bridge: the JAX package's flat-npz checkpoints into the port.

``load_params`` is a numpy-only copy of ``monoport_tpu/utils/params_io``
(f16 on disk, '/'-joined flax keys). ``torch_state_from_flax`` renames a
flax parameter tree to the port's ``state_dict`` names and layouts:
Conv HWIO -> OIHW, Dense [in, out] -> Linear [out, in], GroupNorm
``scale/bias`` -> ``weight/bias``. The port's modules carry the flax
module names, so the rename is mechanical.

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


def torch_state_from_flax(params: Any) -> dict[str, torch.Tensor]:
    """Flax param tree (numpy leaves) -> torch ``state_dict`` (f32)."""
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
    return state


def head_channels(params: Any) -> tuple[int, ...]:
    """Head widths from the params (``infer_head_channels`` of the JAX
    package): input width of layer 0, then every layer's output width."""
    head = params["surface_classifier"]
    n = len(head)
    outs = [np.shape(head[f"filters_{i}"]["kernel"])[1] for i in range(n)]
    return (np.shape(head["filters_0"]["kernel"])[0], *outs)


def build_net(opt_net, params: Any,
              device: Optional[torch.device | str] = None) -> MonoPortNet:
    """MonoPortNet with its head widths read from ``params`` (a flax
    ``params`` tree: {'image_filter': ..., 'surface_classifier': ...}),
    loaded strictly, in eval mode, on ``device`` (``resolve_device``:
    the card unless the caller asks for another device)."""
    device = resolve_device(device)
    net = MonoPortNet(opt_net, head_channels=head_channels(params))
    net.load_state_dict(torch_state_from_flax(params), strict=True)
    return net.eval().to(device)


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

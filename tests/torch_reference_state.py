"""Reference-layout checkpoints for the converter's tests and chip_smoke.py.

The inverse of the converter's key maps: a port ``state_dict`` (whose names
are the JAX package's flax paths) back to the key names and layouts of the
reference's torch modules (HGFilters, ResBlkFilters, HRNetFilters,
Yolov4Filters and the PIFu SurfaceClassifier), as a legacy PIFu state dict
(``surface_classifier.convN``) or a Trainer ``net`` dict
(``surface_classifier.filters.N``). Also seeded weights for any port
module, and the same weights as flax variables for the JAX package.

Imports torch and numpy only: chip_smoke.py uses it on a machine without
JAX.
"""

from __future__ import annotations

import re

import numpy as np
import torch

# a reference checkpoint's counter, which the converters ignore
COUNTER = 1000


def seeded_state(module: torch.nn.Module, seed: int) -> dict:
    """A ``state_dict`` for ``module`` from a numpy seed, drawn in sorted
    key order: conv and linear weights N(0, 1 / fan_in), norm weights
    1 + N(0, 0.01), biases and BatchNorm running means N(0, 0.01), running
    variances U(0.5, 1.5), counters 0."""
    rng = np.random.RandomState(seed)
    out = {}
    for key, ref in sorted(module.state_dict().items()):
        shape = tuple(ref.shape)
        if key.endswith("num_batches_tracked"):
            out[key] = torch.tensor(0)
            continue
        if key.endswith("running_var"):
            v = rng.uniform(0.5, 1.5, shape)
        elif key.endswith("weight") and len(shape) > 1:
            v = rng.randn(*shape) / np.sqrt(np.prod(shape[1:]))
        else:
            v = rng.randn(*shape) * 0.1
            if key.endswith("weight"):
                v += 1.0
        out[key] = torch.from_numpy(v.astype(np.float32))
    return out


def flax_variables(state: dict) -> dict:
    """The inverse of ``weights.torch_state_from_flax``: a port state dict
    -> {'params': ..., 'batch_stats': ...} nested dicts of numpy arrays."""
    params, stats = {}, {}
    for key, t in state.items():
        *path, leaf = key.split(".")
        v = t.numpy()
        if leaf == "num_batches_tracked":
            continue
        if leaf in ("running_mean", "running_var"):
            tree, leaf = stats, leaf[len("running_"):]
        elif leaf == "weight" and v.ndim == 4:          # OIHW -> HWIO
            tree, leaf, v = params, "kernel", v.transpose(2, 3, 1, 0)
        elif leaf == "weight" and v.ndim == 2:          # Linear -> Dense
            tree, leaf, v = params, "kernel", v.T
        else:
            tree, leaf = params, "scale" if leaf == "weight" else leaf
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(v)
    return {"params": params, "batch_stats": stats} if stats else \
        {"params": params}


def _hg(parts: list) -> list:
    if "downsample_conv" in parts:
        i = parts.index("downsample_conv")
        return [parts[:i] + ["downsample", "2"] + parts[i + 1:]]
    if "bn4" in parts:                  # the shared bn4 is saved twice
        i = parts.index("bn4")
        return [parts, parts[:i] + ["downsample", "0"] + parts[i + 1:]]
    return [parts]


_RESNET_STEM = {"conv_stem": "1", "norm_stem": "2", "down0_conv": "4",
                "down0_norm": "5", "down1_conv": "7", "down1_norm": "8"}
_RESNET_INNER = {"conv1": "1", "norm1": "2", "conv2": "5", "norm2": "6"}


def _resnet(parts: list) -> list:
    if parts[0] in _RESNET_STEM:
        return [["model", _RESNET_STEM[parts[0]]] + parts[1:]]
    block = int(parts[0][len("block"):])
    return [["model", str(10 + block), "conv_block",
             _RESNET_INNER[parts[1]]] + parts[2:]]


def _block_inner(rest: list) -> list:
    down = {"down_conv": "0", "down_bn": "1"}
    return ["downsample", down[rest[0]]] + rest[1:] if rest[0] in down \
        else rest


def _hrnet(parts: list) -> list:
    p0 = parts[0]
    if p0 in ("conv1", "bn1", "conv2", "bn2"):
        return [parts]
    if p0.startswith("layer1_"):
        return [["layer1", p0[len("layer1_"):]] + _block_inner(parts[1:])]
    m = re.fullmatch(r"t(\d)_(\d)_(conv|bn)", p0)
    if m:
        si, i = int(m.group(1)), int(m.group(2))
        idx = "0" if m.group(3) == "conv" else "1"
        # stage si has si branches; the last one is new: a Sequential of
        # one Sequential(conv, bn, relu)
        inner = ["0", idx] if i == si - 1 else [idx]
        return [[f"transition{si - 1}", str(i)] + inner + parts[1:]]
    m = re.fullmatch(r"stage(\d)_m(\d+)", p0)
    if m:
        head = [f"stage{m.group(1)}", m.group(2)]
        b = re.fullmatch(r"branch(\d+)_block(\d+)", parts[1])
        if b:
            return [head + ["branches", b.group(1), b.group(2)]
                    + _block_inner(parts[2:])]
        f = re.fullmatch(r"fuse(\d+)_(\d+)_(conv|bn)(\d*)", parts[1])
        idx = "0" if f.group(3) == "conv" else "1"
        k = [f.group(4)] if f.group(4) else []
        return [head + ["fuse_layers", f.group(1), f.group(2)] + k + [idx]
                + parts[2:]]
    last = {"last_conv1": "0", "last_bn": "1", "last_conv2": "3"}
    return [["last_layer", last[p0]] + parts[1:]]


def _yolo(parts: list) -> list:
    idx = {"conv": "0", "bn": "1"}
    if parts[1] == "res":
        b = re.fullmatch(r"b(\d+)_conv(\d)", parts[2])
        return [[parts[0], "resblock", "module_list", b.group(1),
                 str(int(b.group(2)) - 1), "conv", idx[parts[3]]]
                + parts[4:]]
    return [[parts[0], parts[1], "conv", idx[parts[2]]] + parts[3:]]


INVERSE = {"PIFuHGFilters": _hg, "PIFuResBlkFilters": _resnet,
           "Yolov4Filters": _yolo}


def _inverse(imf: str):
    return _hrnet if imf.startswith("HRNet") else INVERSE[imf]


def reference_backbone_state(state: dict, imf: str,
                             counters: bool = True) -> dict:
    """A port backbone's state dict -> the reference backbone's key names
    (BatchNorm counters set to ``COUNTER`` unless ``counters`` is False)."""
    inv = _inverse(imf)
    out = {}
    for key, t in state.items():
        parts = key.split(".")
        if parts[-1] == "num_batches_tracked":
            if not counters:
                continue
            t = torch.tensor(COUNTER)
        for ref in inv(parts):
            out[".".join(ref)] = t.clone()
    return out


def reference_state(state: dict, imf: str, legacy: bool = True,
                    counters: bool = True) -> dict:
    """A port MonoPortNet state dict -> the reference's: a legacy PIFu
    state dict (head ``surface_classifier.convN``, Conv1d [O, I, 1]) or,
    with ``legacy`` False, a Trainer ``net`` dict
    (``surface_classifier.filters.N``)."""
    backbone = {k[len("image_filter."):]: v for k, v in state.items()
                if k.startswith("image_filter.")}
    out = {f"image_filter.{k}": v for k, v in reference_backbone_state(
        backbone, imf, counters).items()}
    for key, t in state.items():
        if not key.startswith("surface_classifier."):
            continue
        name, leaf = key.split(".")[1:]
        n = name[len("filters_"):]
        sub = f"conv{n}" if legacy else f"filters.{n}"
        out[f"surface_classifier.{sub}.{leaf}"] = (
            t[..., None] if leaf == "weight" else t).clone()
    return out


# the alternative netGs of chip_smoke.py's phase 12 and their weights'
# seeds: the reference's exported default, the multi-level HRNet and
# Yolov4, with BatchNorm
ALT_NETGS = {"HRNetV2_W18_small_v2_balance_last": 20,
             "HRNetV2_W18_small_v2": 21, "Yolov4Filters": 22}


def alt_netg_opts(imf: str) -> dict:
    return {"projection": "orthogonal",
            "backbone": {"IMF": imf, "norm": "batch"},
            "normalizer": {"IMF": "PIFuNomalizer"},
            "head": {"IMF": "PIFuNetGMLP"}, "loss": {"IMF": "MSE"},
            "mean": [0.5, 0.5, 0.5], "std": [0.5, 0.5, 0.5],
            "ckpt_path": ""}


def alt_netg_state(imf: str) -> dict:
    """The seeded port state dict of a phase-12 netG at full width: the
    backbone with BatchNorm running stats, the 257- or 271-wide
    PIFuNetGMLP head (its input width from a probe of the backbone).

    The head's last layer is scaled by 0.05 and takes -8 z_feat with no
    bias: a seeded head's logits vary with the features by tens and hardly
    with z, so its occupancy has no surface a ray can cross stably; this
    one falls along every ray, and the features bend the surface."""
    from monoport_tpu_torch.config import CN
    from monoport_tpu_torch.models import HEAD_SPECS, MonoPortNet
    from monoport_tpu_torch.models.backbones import BACKBONES

    opt = CN(alt_netg_opts(imf))
    with torch.no_grad():
        probe = BACKBONES[imf](opt.backbone).eval()(
            torch.zeros(1, 64, 64, 3))[-1]
    widths = HEAD_SPECS["PIFuNetGMLP"][0]
    net = MonoPortNet(opt, head_channels=(
        sum(f.shape[-1] for f in probe) + 1, *widths[1:]))
    state = seeded_state(net, ALT_NETGS[imf])
    last = f"surface_classifier.filters_{len(widths) - 2}"
    state[f"{last}.weight"] *= 0.05
    state[f"{last}.weight"][:, -1] = -8.0
    state[f"{last}.bias"].zero_()
    return state


# the soft-onehot netG of chip_smoke.py's phase softonehot and of
# data/frame_golden_softonehot.npz, and its weights' seed
SOFT_NETG_SEED = 23
SOFT_DIM = 64


def soft_netg_opts() -> dict:
    """The committed netG's config (4-stack HGFilter, GroupNorm) with the
    soft-onehot z feature of ``SOFT_DIM`` bins: head 320-1024-512-256-
    128-1."""
    from monoport_tpu_torch.config import get_cfg_defaults

    opt = get_cfg_defaults().netG.clone()
    opt.normalizer.soft_onehot = True
    opt.normalizer.soft_dim = SOFT_DIM
    return opt


def soft_netg(device):
    """The soft-onehot netG with ``soft_netg_state``'s weights on
    ``device``."""
    from monoport_tpu_torch.config import CN
    from monoport_tpu_torch.weights import build_net

    return build_net(CN(soft_netg_opts()), soft_netg_state(), device)


def soft_netg_state() -> dict:
    """The seeded port state dict of the soft-onehot netG at full width.

    A seeded head's logits hardly vary with z, so its occupancy has no
    surface a ray can cross stably. Here the head's last layer gives the
    logit 8 (f - 1.2) - 3200 max(|z| - 0.3, 0), f its seeded feature
    term: its feature weights are scaled by 8, its bias is -9.6 and its
    z-bin weights are the ramp in z (the soft-onehot interpolation between
    two bins keeps it piecewise linear). A column is occupied in a slab of
    half-thickness 0.3 + (f - 1.2) / 400 about z = 0 where f exceeds 1.2,
    which on the held-out capsule render is mostly the subject (f has a
    median of 2.2 on the subject and of 0.09 off it), and empty
    elsewhere. The steep walls (in z, 25 logits a fine voxel; across the
    silhouette, 8 a unit of f) keep the hierarchy's band of uncertain
    voxels thin, inside the real-time budgets, and the surface away from
    the knife edge of a rounding: the port's f32 features on the CPU are
    8e-5 of their largest value off JAX's f64, whose f32 ones are 2e-5
    off."""
    from monoport_tpu_torch.config import CN
    from monoport_tpu_torch.models import MonoPortNet
    from monoport_tpu_torch.models.monoport_net import head_channels_for

    opt = CN(soft_netg_opts())
    widths = head_channels_for(opt)
    net = MonoPortNet(opt, head_channels=widths)
    state = seeded_state(net, SOFT_NETG_SEED)
    last = f"surface_classifier.filters_{len(widths) - 2}"
    z = np.linspace(-1.0, 1.0, SOFT_DIM, dtype=np.float32)
    state[f"{last}.weight"] *= 8.0
    state[f"{last}.weight"][:, -SOFT_DIM:] = torch.from_numpy(
        -3200.0 * np.maximum(np.abs(z) - 0.3, 0.0))
    state[f"{last}.bias"].fill_(-9.6)
    return state


# the wide netG of chip_smoke.py's phase wide_head: the committed netG's
# HGFilter backbone under a numpy-seeded occupancy head of these widths,
# which the in-place bf16 kernel cannot hold (a hidden layer over 1024, a
# hidden layer past the first with two passes, 768 no power of two)
WIDE_NETG_HEAD = (257, 2048, 1024, 768, 128, 1)
WIDE_NETG_SEED = 24


def wide_netg(device):
    """The committed netG (``netg_capsule.npz``) with its head replaced by
    a seeded ``WIDE_NETG_HEAD`` head, on ``device``. As in
    ``alt_netg_state``, the head's last layer is scaled by 0.05 and takes
    -8 z_feat with no bias, so that the random head has a surface every
    ray crosses."""
    import os

    from monoport_tpu_torch.config import get_cfg_defaults
    from monoport_tpu_torch.models import MonoPortNet
    from monoport_tpu_torch.weights import (DATA, _as_state, load_module,
                                            load_params)

    state = {k: v for k, v in _as_state(load_params(os.path.join(
        DATA, "netg_capsule.npz"))[0]).items()
        if not k.startswith("surface_classifier.")}
    net = MonoPortNet(get_cfg_defaults().netG, head_channels=WIDE_NETG_HEAD)
    head = seeded_state(net.surface_classifier, WIDE_NETG_SEED)
    last = f"filters_{len(WIDE_NETG_HEAD) - 2}"
    head[f"{last}.weight"] *= 0.05
    head[f"{last}.weight"][:, -1] = -8.0
    head[f"{last}.bias"].zero_()
    state.update({f"surface_classifier.{k}": v for k, v in head.items()})
    return load_module(net, state, device)

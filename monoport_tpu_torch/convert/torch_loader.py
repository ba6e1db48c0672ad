"""Reference PyTorch checkpoints -> the port's ``state_dict`` (port of
``monoport_tpu/convert/torch_loader.py``).

Covers both checkpoint formats of the reference:
  * Trainer dicts {opt, net, optimizer, ...} (monoport/lib/common/
    trainer.py:61-75), whose ``net`` state dict has ``image_filter.*`` /
    ``surface_classifier.filters.N.*`` keys;
  * legacy PIFu state dicts, whose head keys are
    ``surface_classifier.convN.*`` (MonoPortNet.py:153-160).

The port's modules carry the JAX package's module names, so the key maps
are that package's (copied here: the port imports nothing of it). Conv2d
weights stay OIHW; a Conv1d weight [O, I, 1] becomes a Linear [O, I].
BatchNorm running stats are kept, with ``num_batches_tracked`` 0, as
``weights.torch_state_from_flax`` writes it (the update never reads it).

Files are read with ``torch.load(weights_only=True)``: a checkpoint never
runs arbitrary pickles.
"""

from __future__ import annotations

import pickle
import re
from typing import Any, Mapping

import torch

_NORM_STATS = ("running_mean", "running_var")


def _leaf(parts: list[str], tensor: Any) -> dict[str, torch.Tensor]:
    """A reference (module path, tensor) -> the port's state entries."""
    leaf, key = parts[-1], ".".join(parts)
    t = torch.as_tensor(tensor).detach().to("cpu", torch.float32)
    if leaf == "weight":
        if t.dim() == 3:                     # Conv1d (k=1) -> Linear
            t = t[..., 0]
        elif t.dim() not in (1, 2, 4):
            raise ValueError(f"unhandled weight ndim {t.dim()} at {key}")
        return {key: t.contiguous()}
    if leaf == "bias":
        return {key: t.contiguous()}
    if leaf in _NORM_STATS:
        return {key: t.contiguous(),
                ".".join(parts[:-1] + ["num_batches_tracked"]):
                    torch.tensor(0)}
    raise ValueError(f"unhandled leaf {leaf} at {key}")


def _map_hg_parts(parts: list[str]) -> list[str] | None:
    """HGFilter key fixups: shared bn4 / downsample Sequential naming."""
    if "downsample" in parts:
        i = parts.index("downsample")
        if parts[i + 1] == "0":
            return None  # duplicate of the shared bn4 (HGFilters.py:30-36)
        if parts[i + 1] != "2":
            raise ValueError(f"unhandled HGFilter key {parts}")
        return parts[:i] + ["downsample_conv"] + parts[i + 2:]
    return parts


_RESNET_STEM = {
    "1": ["conv_stem"], "2": ["norm_stem"],
    "4": ["down0_conv"], "5": ["down0_norm"],
    "7": ["down1_conv"], "8": ["down1_norm"],
}
_RESNET_BLOCK_INNER = {"1": "conv1", "2": "norm1", "5": "conv2", "6": "norm2"}


def _map_resnet_parts(parts: list[str]) -> list[str] | None:
    """ResnetFilter: flatten torch nn.Sequential indices to semantic names
    (layout per ResBlkFilters.py:111-134 with group norm / no bias)."""
    if parts[0] != "model":
        raise ValueError(f"unhandled ResnetFilter key {parts}")
    idx = parts[1]
    if idx in _RESNET_STEM:
        return _RESNET_STEM[idx] + parts[2:]
    block = int(idx) - 10
    if not (0 <= block < 6 and parts[2] == "conv_block"):
        raise ValueError(f"unhandled ResnetFilter key {parts}")
    return [f"block{block}", _RESNET_BLOCK_INNER[parts[3]]] + parts[4:]


def _map_block_inner(rest: list[str]) -> list[str]:
    """Basic/Bottleneck inner names; torch downsample Sequential ->
    down_conv / down_bn."""
    if rest[0] == "downsample":
        return [{"0": "down_conv", "1": "down_bn"}[rest[1]]] + rest[2:]
    return rest


def _map_hrnet_parts(parts: list[str]) -> list[str] | None:
    """HRNet torch keys -> the port's module paths (HRNetFilters.py:222-439
    vs models/backbones/hrnet.py)."""
    p0 = parts[0]
    if p0 in ("conv1", "bn1", "conv2", "bn2"):
        return parts
    if p0 == "layer1":                       # layer1.{k}.<block-inner>
        return [f"layer1_{parts[1]}"] + _map_block_inner(parts[2:])
    if p0.startswith("transition"):
        si = int(p0[len("transition"):]) + 1  # transitionN feeds stage N+1
        i = parts[1]
        # existing branch: Sequential(conv, bn, relu) -> idx at parts[2];
        # new branch: Sequential(Sequential(conv, bn, relu)) -> parts[2]
        # is the (always single here) inner index, idx at parts[3]
        idx = parts[2] if len(parts) == 4 else parts[3]
        return [f"t{si}_{i}_" + {"0": "conv", "1": "bn"}[idx], parts[-1]]
    if p0.startswith("stage"):               # stage{si}.{m}....
        mod = f"stage{p0[len('stage'):]}_m{parts[1]}"
        if parts[2] == "branches":           # branches.{i}.{k}.<inner>
            return [mod, f"branch{parts[3]}_block{parts[4]}"] \
                + _map_block_inner(parts[5:])
        if parts[2] != "fuse_layers":
            raise ValueError(f"unhandled HRNet key {parts}")
        i, j = parts[3], parts[4]
        if int(j) > int(i):                  # Sequential(conv, bn, up)
            nm = {"0": f"fuse{i}_{j}_conv", "1": f"fuse{i}_{j}_bn"}[parts[5]]
            return [mod, nm, parts[-1]]
        k, idx = parts[5], parts[6]          # Sequential of Sequentials
        nm = {"0": f"fuse{i}_{j}_conv{k}", "1": f"fuse{i}_{j}_bn{k}"}[idx]
        return [mod, nm, parts[-1]]
    if p0 == "last_layer":                   # Sequential(conv, bn, relu, conv)
        nm = {"0": "last_conv1", "1": "last_bn", "3": "last_conv2"}[parts[1]]
        return [nm, parts[-1]]
    raise ValueError(f"unhandled HRNet key {parts}")


def _map_yolo_parts(parts: list[str]) -> list[str] | None:
    """Yolov4 torch keys -> the port's paths (Yolov4Filters.py:91-378 vs
    models/backbones/yolov4.py). Conv_Bn_Activation is a ModuleList named
    'conv' with the conv at 0 and an optional bn at 1."""
    top = parts[0]                           # down1..down5 | neek | head
    if parts[1] == "resblock":   # resblock.module_list.{i}.{j}.conv.{idx}
        i, j, idx = parts[3], parts[4], parts[6]
        return [top, "res", f"b{i}_conv{int(j) + 1}",
                {"0": "conv", "1": "bn"}[idx], parts[-1]]
    convk, idx = parts[1], parts[3]          # conv{k}.conv.{idx}.param
    return [top, convk, {"0": "conv", "1": "bn"}[idx], parts[-1]]


_BACKBONE_MAPPERS = {
    "PIFuHGFilters": _map_hg_parts,
    "PIFuResBlkFilters": _map_resnet_parts,
    "HRNetV2_W18_small_v2": _map_hrnet_parts,
    "HRNetV2_W18_small_v2_balance": _map_hrnet_parts,
    "HRNetV2_W18_small_v2_balance_gn32": _map_hrnet_parts,
    "HRNetV2_W18_small_v2_balance_last": _map_hrnet_parts,
    "HRNetV2_W18_small_v2_balance_v2": _map_hrnet_parts,
    "HRNetV2_W18_small_v2_deeper": _map_hrnet_parts,
    "Yolov4Filters": _map_yolo_parts,
}


def _put(state: dict, entries: dict) -> None:
    for key, value in entries.items():
        if key in state and not key.endswith("num_batches_tracked"):
            raise ValueError(f"duplicate key {key}")
        state[key] = value


def convert_backbone_state(state: Mapping[str, Any],
                           imf: str) -> dict[str, torch.Tensor]:
    """A reference backbone state dict -> the port backbone's, BatchNorm
    running stats included (HRNet / Yolov4 use BatchNorm,
    HRNetFilters.py:10)."""
    mapper = _BACKBONE_MAPPERS[imf]
    out: dict = {}
    for key, tensor in state.items():
        parts = mapper(key.split("."))
        if parts is None or parts[-1] == "num_batches_tracked":
            continue
        _put(out, _leaf(parts, tensor))
    return out


def convert_head_state(state: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A SurfaceClassifier state dict (``filters.N.*`` keys, Conv1d) -> the
    port head's (``filters_N``, Linear)."""
    out: dict = {}
    for key, tensor in state.items():
        parts = key.split(".")
        if parts[0] != "filters" or len(parts) != 3:
            raise ValueError(f"unexpected head key {key}")
        _put(out, _leaf([f"filters_{parts[1]}", parts[2]], tensor))
    return out


def convert_monoport_state(state: Mapping[str, Any], backbone_imf: str,
                           legacy_pifu: bool = False
                           ) -> dict[str, torch.Tensor]:
    """A full MonoPortNet state dict -> the port's MonoPortNet state dict.

    legacy_pifu remaps ``surface_classifier.convN`` -> ``filters.N``
    (MonoPortNet.py:153-160)."""
    backbone_state, head_state = {}, {}
    for key, tensor in state.items():
        if key.startswith("image_filter."):
            backbone_state[key[len("image_filter."):]] = tensor
        elif key.startswith("surface_classifier."):
            sub = key[len("surface_classifier."):]
            if legacy_pifu:
                m = re.match(r"conv(\d+)\.(.*)", sub)
                if not m:
                    raise ValueError(f"unexpected legacy PIFu key {key}")
                sub = f"filters.{m.group(1)}.{m.group(2)}"
            head_state[sub] = tensor
        else:
            raise ValueError(f"unexpected key {key}")
    out = {f"image_filter.{k}": v for k, v in
           convert_backbone_state(backbone_state, backbone_imf).items()}
    out.update({f"surface_classifier.{k}": v
                for k, v in convert_head_state(head_state).items()})
    return out


def _yolo_conv137_key_order() -> list[str]:
    """Torch state-dict key order of Sequential(down1..down5, neek) -- the
    zip target of the reference's yolov4.conv.137 loader
    (Yolov4Filters.py:392-401), in the registration order of the reference
    modules (Yolov4Filters.py:91-313)."""
    keys: list[str] = []

    def cba(prefix: str) -> None:
        keys.extend([
            f"{prefix}.conv.0.weight",
            f"{prefix}.conv.1.weight", f"{prefix}.conv.1.bias",
            f"{prefix}.conv.1.running_mean", f"{prefix}.conv.1.running_var",
            f"{prefix}.conv.1.num_batches_tracked"])

    for k in range(1, 9):
        cba(f"down1.conv{k}")
    for d, nblocks in (("down2", 2), ("down3", 8), ("down4", 8),
                       ("down5", 4)):
        for k in (1, 2, 3):
            cba(f"{d}.conv{k}")
        for i in range(nblocks):
            cba(f"{d}.resblock.module_list.{i}.0")
            cba(f"{d}.resblock.module_list.{i}.1")
        for k in (4, 5):
            cba(f"{d}.conv{k}")
    for k in range(1, 21):
        cba(f"neek.conv{k}")
    return keys


def _load(path: str):
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        raise ValueError(
            f"{path}: not a plain tensor checkpoint, and it is read with "
            "weights_only=True (a Trainer checkpoint whose 'opt' is a yacs "
            "object is refused): save its 'net' state dict alone") from e


def load_darknet_conv137(ckpt_path: str) -> dict[str, torch.Tensor]:
    """``yolov4.conv.137.pth`` by positional zip (Yolov4Filters.py:392-401:
    the file's own key names are ignored; tensors go to the backbone + neck
    modules in registration order) -> the Yolov4 backbone's state entries
    for down1..down5 + neek (the 3-scale head keeps its init: the darknet
    cut has no head)."""
    vals = list(_load(ckpt_path).values())
    targets = _yolo_conv137_key_order()
    if len(vals) != len(targets):
        # files exported without num_batches_tracked counters
        no_nbt = [k for k in targets
                  if not k.endswith("num_batches_tracked")]
        targets = no_nbt if len(vals) == len(no_nbt) else targets
    state = dict(zip(targets, vals))  # zip truncates like the reference
    return convert_backbone_state(state, "Yolov4Filters")


def merge_backbone_pretrained(state: Mapping[str, torch.Tensor],
                              backbone: Mapping[str, torch.Tensor]
                              ) -> dict[str, torch.Tensor]:
    """A net's state dict with converted backbone entries laid over it
    (partial load: modules absent from ``backbone`` keep their init, like
    the reference's model_dict.update)."""
    out = dict(state)
    out.update({f"image_filter.{k}": v for k, v in backbone.items()})
    return out


def load_legacy_pifu(ckpt_path: str,
                     backbone_imf: str) -> dict[str, torch.Tensor]:
    """A reference checkpoint file (a legacy PIFu state dict, or a Trainer
    dict's ``net``) -> the port's MonoPortNet state dict."""
    state = _load(ckpt_path)
    if isinstance(state, dict) and "net" in state:  # Trainer-format dict
        return convert_monoport_state(state["net"], backbone_imf,
                                      legacy_pifu=False)
    return convert_monoport_state(state, backbone_imf, legacy_pifu=True)

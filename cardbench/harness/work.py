"""The work a frame needs, counted from shapes: the yardstick of the
roofline and utilisation metrics.

Peaks are NVIDIA's H100 SXM data-sheet figures (dense): 989 TFLOP/s in
bf16 on the tensor cores, 67 TFLOP/s in f32 outside them, 3.35 TB/s of
HBM3. A head's work follows the algorithm, not an implementation: a ray
query projects each ray's feature (or each of its K anchors' features)
once through the feature columns of every layer, and runs the hidden
products once a tap; a per-point query runs every layer's products a
point. A frame's rows follow its inputs: the calib picks the path and
each rotated refine level's anchor count, the compaction hint the budget
rung (``reference.recon``'s frozen copies of the two host rules). A
profile ``mode`` other than 'ray' counts the queries its reference frame
path's ``queries`` lists, from the rows its reference gives the frame's
image (``rows``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..reference import nets
from ..reference.frame import frame_path
from ..reference.recon import anchor_plan, compact_rays, snap_budget, taps_ok

PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12


def head_dims(widths):
    """(input width, layer output widths, parameter count) of a PIFu head
    whose every layer after the first also takes the input."""
    c_in, outs = widths[0], list(widths[1:])
    ins = [c_in] + [o + c_in for o in outs[:-1]]
    return c_in, outs, sum(i * o + o for i, o in zip(ins, outs))


def ray_mlp_work(widths, rays: int, taps: int, anchors: int = 1,
                 mixed: bool = False, op_bytes: int = 2,
                 peak: float = PEAK_BF16):
    """(operations, seconds of them at ``peak`` and the hat mix's at the
    f32 peak, bytes) of a ray query of ``rays`` x ``taps``: W_f once per
    ray and anchor, the hidden products per tap, and with ``mixed`` the
    K-term hat mix per tap and column as f32 multiply-adds. Bytes: each
    input read once (the features in the operand type, z and the mix
    weights in f32), the weights once, the f32 output once."""
    c_in, outs, n_params = head_dims(widths)
    c_f = c_in - 1
    mac_ray = anchors * c_f * sum(outs)
    mac_tap = sum(a * b for a, b in zip(outs[:-1], outs[1:]))
    flops = 2.0 * (rays * mac_ray + rays * taps * mac_tap)
    mix = 2.0 * rays * taps * anchors * sum(outs) if mixed else 0.0
    nbytes = (rays * anchors * c_f * op_bytes + rays * taps * 4
              + (rays * taps * anchors * 4 if mixed else 0)
              + n_params * op_bytes + rays * taps * outs[-1] * 4)
    return flops + mix, flops / peak + mix / PEAK_F32, nbytes


def point_mlp_work(widths, points: int, op_bytes: int = 2,
                   peak: float = PEAK_BF16):
    """The same for a per-point query: every layer's products a point, at
    ``peak`` operations a second."""
    c_in, outs, n_params = head_dims(widths)
    mac = c_in * outs[0] + sum((a + c_in) * b for a, b in zip(outs[:-1],
                                                            outs[1:]))
    flops = 2.0 * points * mac
    nbytes = points * c_in * op_bytes + n_params * op_bytes + points * outs[-1] * 4
    return flops, flops / peak, nbytes


def bound_s(work) -> float:
    """The least time of a launch: operations or bytes, the larger."""
    _, t_ops, nbytes = work
    return max(t_ops, nbytes / PEAK_BYTES)


def queries_bound_s(config: dict, calib: np.ndarray, rows, net: str) -> float:
    """The least time of ``net``'s head queries of one frame on a path
    whose rows follow the image (its reference path's ``queries`` of the
    reference's ``rows``), at the peak of the profile's compute dtype: 67
    TFLOP/s f32 on the FMA units with 4-byte operands, or 989 bf16."""
    p = config["profile"]
    peak, op_bytes = ((PEAK_F32, 4) if p["compute_dtype"] == "float32"
                      else (PEAK_BF16, 2))
    w = config[net]["head"]["widths"]
    total = 0.0
    for q, kind, n, taps in frame_path(p["mode"]).queries(config, calib,
                                                          rows):
        if q == net:
            total += bound_s(
                ray_mlp_work(w, n, taps, op_bytes=op_bytes, peak=peak)
                if kind == "ray" else
                point_mlp_work(w, n * taps, op_bytes, peak))
    return total


@functools.lru_cache(maxsize=None)
def _backbone_flops_cached(spec_json: str, size: int) -> float:
    import json

    net = nets.backbone(json.loads(spec_json)).to("meta")
    total = [0.0]

    def hook(mod, inputs, out):
        k = mod.kernel_size[0] * mod.kernel_size[1]
        total[0] += (2.0 * out.numel() * mod.in_channels // mod.groups * k)

    handles = [m.register_forward_hook(hook) for m in net.modules()
               if isinstance(m, torch.nn.Conv2d)]
    with torch.no_grad():
        net(torch.zeros(1, size, size, 3, device="meta"))
    for h in handles:
        h.remove()
    return total[0]


def backbone_flops(spec: dict, size: int) -> float:
    """Multiply-adds x 2 of every convolution of a backbone at size^2
    (batch 1), from the layer shapes (a forward on the meta device)."""
    import json

    return _backbone_flops_cached(json.dumps(spec, sort_keys=True), size)


def frontal_ray_launches(config: dict):
    """(head widths, rays, taps) of each ray query of a frontal frame: the
    march (level^2 rays over level taps), each refine level, the windowed
    fine level, and netC's colour at one tap a window ray."""
    p = config["profile"]
    levels, taps = p["march_levels"], p["taps"]
    g = config["netG"]["head"]["widths"]
    out = [(g, levels[0] ** 2, levels[0])]
    out += [(g, r ** 2, taps) for r in levels[1:]]
    out.append((g, p["window"] ** 2, taps))
    if "netC" in config:
        out.append((config["netC"]["head"]["widths"], p["window"] ** 2, 1))
    return out


def frame_head_works(config: dict, calib: np.ndarray, hint,
                     rows=None) -> list:
    """The work of every head query of one frame, by its path; ``rows``:
    the reference's rows of the frame on a path whose rows follow the
    image (``Cell.head_rows``)."""
    p = config["profile"]
    if p["mode"] != "ray":
        return [ray_mlp_work(config[net]["head"]["widths"], n, taps)
                if kind == "ray" else
                point_mlp_work(config[net]["head"]["widths"], n * taps)
                for net, kind, n, taps in
                frame_path(p["mode"]).queries(config, calib, rows)]
    if taps_ok(calib):
        return [ray_mlp_work(w, r, t)
                for w, r, t in frontal_ray_launches(config)]
    rot = p["rotated"]
    levels, taps, fine = p["march_levels"], p["taps"], p["fine_res"]
    g = config["netG"]["head"]["widths"]
    compact = rot["compact"]
    if hint is not None and compact is not None:
        compact = snap_budget(hint, compact)
    lattices = list(levels[1:]) + [fine]
    pairs = list(zip(levels, lattices))
    plan = anchor_plan(calib, config["image_size"], pairs, taps,
                       rot["anchor_texels"], p["b_min"], p["b_max"])
    works = [point_mlp_work(g, levels[0] ** 3)]
    budget = None
    for i, (k, rl) in enumerate(zip(plan, lattices)):
        side = p["window"] if i == len(lattices) - 1 else rl
        budget = compact_rays(compact, side, side) or side * side
        works.append(ray_mlp_work(g, budget, taps, anchors=k, mixed=True)
                     if k else point_mlp_work(g, budget * taps))
    if "netC" in config:
        works.append(point_mlp_work(config["netC"]["head"]["widths"], budget))
    return works


def frame_flops(config: dict, calib: np.ndarray, hint, rows=None) -> float:
    """Model operations of one frame: the backbones' convolutions at the
    input size and every head query."""
    size = config["image_size"]
    total = backbone_flops(config["netG"]["backbone"], size)
    if "netC" in config:
        total += backbone_flops(config["netC"]["backbone"], size)
    return total + sum(w[0] for w in frame_head_works(config, calib, hint,
                                                      rows))

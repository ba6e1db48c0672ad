"""The benchmark's reference frame: what the real-time engine's frame
must produce, in plain PyTorch, float32 (TF32 off), from the same images,
calib, compaction hint and weights.

One frame: netG's backbone, the march pyramid (``recon.pyramid``), the
normal shading, and with netC its backbone on netG's last feature map as
a prior and the colour of each surface point. The path follows the calib
as the engine's does: z-free image rows take dense refine passes and the
windowed colour lattice; any other calib compacts each refine level to
its coarse-valid rays (the budget rung the hint snaps to), queries each
level through the anchored query with the anchor count its plan gives
(exact per point without one), and colours the fine level's rays. Every
query runs the plain head on the exact per-point or anchored input.

``quantize_fp8`` turns a reference into the control: every convolution
and linear layer takes its input and weight rounded to float8 e4m3 with a
per-tensor scale. ``control_nets`` picks a configuration's control: that,
under bf16; under float32 (TF32 off), ``quantize_tf32``'s operands rounded
to TF32.

This is the frame of the profile's ``mode='ray'``; ``reference_frame``
takes any other mode's from a file of its own (``reference/__init__.py``).
"""

from __future__ import annotations

import copy
import dataclasses
import os

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from . import recon
from .nets import ImplicitNet, load_file

FRAMES_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "frames")


@dataclasses.dataclass
class Profile:
    """The operating point of a configuration file's ``profile``."""
    fine_res: int
    taps: int
    window: int
    march_levels: tuple
    balance_value: float
    b_min: tuple
    b_max: tuple
    render_size: int
    compact: float | None
    anchor_texels: float

    @classmethod
    def of(cls, p: dict) -> "Profile":
        rot = p["rotated"]
        if not rot["march"] or p["mode"] != "ray" or rot["anchors"] != "auto":
            raise ValueError("the reference frame is the march pyramid's, "
                             "with the anchor plan of the calib")
        return cls(p["fine_res"], p["taps"], p["window"],
                   tuple(p["march_levels"]), p["balance_value"],
                   tuple(p["b_min"]), tuple(p["b_max"]), p["render_size"],
                   rot["compact"], rot["anchor_texels"])


def load_nets(config: dict, states: dict, device) -> dict:
    """{'netG': ..., ['netC': ...]} reference nets with ``states`` loaded
    strictly, f32, eval."""
    out = {}
    for key in ("netG", "netC"):
        if key in config:
            net = ImplicitNet(config[key])
            net.load_state_dict(states[key], strict=True)
            out[key] = net.to(device=device, dtype=torch.float32).eval()
    return out


def frame_path(mode: str, directory: str | None = None):
    """The module of the frame path ``mode`` other than 'ray':
    ``<mode>.py`` in ``directory`` (``FRAMES_DIR`` when None)."""
    path = os.path.join(directory or FRAMES_DIR, f"{mode}.py")
    if mode == "ray" or not os.path.isfile(path):
        raise ValueError(f"no reference frame path {mode!r}")
    return load_file(path)


def reference_frame(config: dict, nets: dict):
    """The reference frame of a configuration's profile ``mode``."""
    mode = config["profile"]["mode"]
    if mode == "ray":
        return ReferenceFrame(config, nets)
    return frame_path(mode).Frame(config, nets)


class ReferenceFrame:
    def __init__(self, config: dict, nets: dict):
        self.p = Profile.of(config["profile"])
        self.netG = nets["netG"]
        self.netC = nets.get("netC")

    def plan(self, calib: np.ndarray, image_h: int) -> tuple:
        """Anchor count a refine level of this calib (() on the z-free
        paths)."""
        p = self.p
        if recon.taps_ok(calib):
            return ()
        lv = list(p.march_levels) + [p.fine_res]
        pairs = list(zip(lv[:-1], lv[1:]))
        return recon.anchor_plan(calib, image_h, pairs, p.taps,
                                 p.anchor_texels, p.b_min, p.b_max)

    def hint_after(self, out: dict) -> float:
        """The compaction hint this frame's answer gives the next."""
        return recon.hint_from_valid(float(out["valid"].float().mean()),
                                     self.p.fine_res, self.p.window)

    @torch.no_grad()
    def __call__(self, image_g, image_c, calib: np.ndarray, hint=None):
        p = self.p
        dev = image_g.device
        rotated = not recon.taps_ok(calib)
        compact = p.compact if rotated else None
        if hint is not None and compact is not None:
            compact = recon.snap_budget(hint, compact)
        plan = self.plan(calib, image_g.shape[1])
        calib_t = torch.as_tensor(np.asarray(calib, np.float32).reshape(
            1, 4, 4), device=dev)
        feats = self.netG.filter(image_g.float())

        def occ(pts):
            return self.netG.query(feats, pts, calib_t)[0, :, 0]

        def anchored(k):
            return lambda xy, wz: self.netG.query_anchored(
                feats, xy[None], wz[None], calib_t, k)[0, ..., 0]

        taps = [anchored(k) if k else None for k in plan] or \
            [None] * len(p.march_levels)
        state = {} if rotated else None
        maps = recon.pyramid(recon.Queries(occ, taps), p.fine_res,
                             p.march_levels, p.taps, p.balance_value, p.b_min,
                             p.b_max, p.window, compact, state, dev)
        out = {"depth": maps.depth, "valid": maps.valid,
               "render_norm": recon.visualize(recon.shade_normal(maps),
                                              p.render_size)}
        if self.netC is not None and image_c is not None:
            feats_c = self.netC.filter(image_c.float(), feats[-1])

            def color(pts):
                return self.netC.query(feats_c, pts, calib_t)[0]

            tex = recon.texture_canvas(maps, p.fine_res, p.window, color,
                                       p.b_min, p.b_max, state)
            out["render_tex"] = recon.visualize(tex, p.render_size)
        return out


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale (amax -> 448)."""
    scale = torch.clamp(x.abs().amax(), min=1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to TF32's 10 mantissa bits, to nearest, ties to
    even, as the tensor cores take an f32 operand."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def _rounded(nets: dict, rnd) -> dict:
    """Copies of the reference nets whose convolutions and linear layers
    compute on inputs and weights rounded by ``rnd`` (f32 accumulation)."""
    out = {}
    for key, net in nets.items():
        net = copy.deepcopy(net)
        for m in net.modules():
            if isinstance(m, nn.Conv2d):
                m.forward = (lambda x, m=m: F.conv2d(
                    rnd(x), rnd(m.weight), m.bias, m.stride, m.padding,
                    m.dilation, m.groups))
            elif isinstance(m, nn.Linear):
                m.forward = (lambda x, m=m: F.linear(rnd(x), rnd(m.weight),
                                                     m.bias))
        out[key] = net
    return out


def quantize_fp8(nets: dict) -> dict:
    """Copies of the reference nets whose convolutions and linear layers
    compute on float8 e4m3 inputs and weights (f32 accumulation)."""
    return _rounded(nets, _fp8)


def quantize_tf32(nets: dict) -> dict:
    """The same on TF32 inputs and weights: what the tensor cores compute
    with TF32 on."""
    return _rounded(nets, _tf32)


def control_nets(config: dict, nets: dict) -> dict:
    """The control of a configuration: its reference nets one precision
    step below its ``compute_dtype`` (float32 with TF32 off -> TF32,
    bfloat16 -> float8 e4m3)."""
    if config["profile"]["compute_dtype"] == "float32":
        return quantize_tf32(nets)
    return quantize_fp8(nets)

"""The cell of PIFu's multi-view netG (a traffic file's ``"driver":
"views"``): each frame is one subject seen by a calibrated ring of
orthographic cameras, all of its views in one ``ReconEngine.frame``.

Traffic: ``bodies`` capsule bodies drawn from the seed as
``traffic.generate`` draws them (the same bodies as the frontal mix of the
same seed), each rendered on the device by one camera a yaw of the
file's ``camera.yaws`` (about the vertical axis, pitch 0): view v's calib
maps a world point X to R_y(yaw_v) X, so the first view of a ring that
starts at yaw 0 is the identity. Frame i shows body i mod bodies in every
view. The loop, the sample, the profiled stretch and the comparison are
``Cell``'s; the engine is built with the configuration's
``netG.head.num_views``, and the reference frame is
``reference/frames/dense_views.py``, taken by name (the profile's
``mode`` stays 'dense', which the engine reads).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from ..reference.frame import frame_path, load_nets
from . import capsule, program, traffic, weights
from .cell import Cell

FRAME = "dense_views"              # reference/frames/<FRAME>.py


def ring_calib(yaw_deg: float) -> np.ndarray:
    """[4, 4] calib of an orthographic camera at ``yaw_deg`` about the
    vertical (y) axis: X -> R_y X (identity at yaw 0)."""
    c, s = math.cos(math.radians(yaw_deg)), math.sin(math.radians(yaw_deg))
    out = np.eye(4)
    out[:3, :3] = [[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]]
    return out.astype(np.float32)


def ring_calibs(yaws) -> np.ndarray:
    """[V, 4, 4] calibs of the ring, one a yaw."""
    return np.stack([ring_calib(y) for y in yaws])


def render_view(caps, app: dict, calib: np.ndarray, size: int):
    """The body seen through ``calib`` (a rotation about y): the front
    render of its capsules turned by the rotation. (The renderer's image
    rows follow PIFu's y-flip, which a rotation about y commutes with.)"""
    a, b, r, cloth = caps
    rot = torch.as_tensor(calib[:3, :3], dtype=a.dtype, device=a.device)
    return capsule.render_front((a @ rot.T, b @ rot.T, r, cloth), app, size)


def generate(spec: dict, seed: int, size: int, device) -> traffic.Traffic:
    """The ring mix: images [bodies, V, S, S, 3], one calib [V, 4, 4]."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    n = spec["bodies"]
    u = torch.rand((n, capsule.N_UNIFORMS), generator=gen, device=device)
    cam = spec["camera"]
    if cam["kind"] != "ring" or cam.get("pitch", 0.0) != 0.0:
        raise ValueError(f"the views driver takes a ring at pitch 0, not "
                         f"{cam}")
    calibs = ring_calibs(cam["yaws"])
    images = []
    for i in range(n):
        caps, app = capsule.body(u[i], spec["body"])
        images.append(torch.stack([render_view(caps, app, c, size)
                                   for c in calibs]))
    return traffic.Traffic(torch.stack(images), [calibs], 0, spec.get("hint"))


def build_engine(config: dict, states: dict, device):
    """(engine, seconds to build it): the port's ``ReconEngine`` with a
    netG of ``netG.head.num_views`` views at the profile of
    ``program.engine_config``. Raises where the program's netG takes no
    such key (it would run view 0 alone)."""
    from monoport_tpu_torch.config import CN
    from monoport_tpu_torch.engine import ReconEngine
    from monoport_tpu_torch.weights import build_net

    t0 = time.perf_counter()
    opt = CN(program._opt(config["netG"]))
    opt.num_views = config["netG"]["head"]["num_views"]
    net = build_net(opt, states["netG"], device)
    if getattr(net, "num_views", 1) != opt.num_views:
        raise ValueError(f"the program's netG has no {opt.num_views}-view "
                         f"form (num_views)")
    recon, cfg = program.engine_config(config)
    engine = ReconEngine(net, None, recon=recon, config=cfg, device=device)
    return engine, time.perf_counter() - t0


class ViewsCell(Cell):
    def setup(self) -> dict:
        if "netC" in self.config:
            raise ValueError("the views cell runs netG alone")
        t = time.perf_counter()
        if self.device.type == "cuda":
            self.timings["nvcc_s"] = program.build_kernels()
            self.timings["kernels_s"] = time.perf_counter() - t
            t = time.perf_counter()
        self.traffic = generate(self.spec, self.seed,
                                self.config["image_size"], self.device)
        self.images_c = None
        self._sync()
        self.timings["traffic_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.states = weights.states(self.config, self.seed, self.device,
                                     self.traffic.images)
        self._sync()
        self.timings["weights_s"] = time.perf_counter() - t
        if self.device.type == "cuda":      # the peak is the program's
            torch.cuda.reset_peak_memory_stats(self.device)
        self.engine, self.timings["engine_s"] = build_engine(
            self.config, self.states, self.device)
        return self.timings

    def frame(self, i: int, hint):
        b, c = self.traffic.frame(i)
        return self.engine.frame(self.traffic.images[b], None,
                                 self.traffic.calibs[c], compact_hint=hint)

    def inputs(self, win, i: int):
        b, c, hint = win.meta[i]
        return self.traffic.images[b], None, self.traffic.calibs[c], hint

    def reference(self, control: bool = False):
        """``reference/frames/dense_views.py``'s frame; with ``control``,
        on the configuration's control nets."""
        from ..reference.frame import control_nets

        nets = load_nets(self.config, self.states, self.device)
        if control:
            nets = control_nets(self.config, nets)
        return frame_path(FRAME).Frame(self.config, nets)

    def head_rows(self, body: int, pose: int):
        """The reference's points of each hierarchy level of the frame
        showing ``body`` (cached)."""
        if not hasattr(self, "_rows"):
            self._rows, self._rows_ref = {}, self.reference()
        if (body, pose) not in self._rows:
            with torch.inference_mode():
                self._rows[body, pose] = self._rows_ref.rows(
                    self.traffic.images[body], self.traffic.calibs[pose])
        return self._rows[body, pose]


CELL = ViewsCell

"""The system under test: the port's ``ReconEngine`` at a configuration's
operating point, built from the benchmark's weights, or the served demo
(``apps/rtl_main``'s pipeline and MJPEG server) at it. This is the one
module of the harness that imports the port."""

from __future__ import annotations

import os
import time

import torch

from .manifest import ROOT as _ROOT

_NET_KEYS = ("projection", "backbone", "normalizer", "head", "loss", "mean",
             "std")
_RAY_KEYS = ("fine_res", "taps", "window", "march_levels")


def _opt(spec: dict) -> dict:
    opt = {k: spec[k] for k in _NET_KEYS if k in spec}
    opt["head"] = {"IMF": spec["head"]["IMF"]}
    return opt


def build_kernels() -> dict:
    """Compile the port's kernel sources unless the checkout's build
    directory has them all; -> seconds by source (empty when cached)."""
    from monoport_tpu_torch.ops.cuda import build

    seconds: dict = {}
    if not all(os.path.exists(build.library_path(n))
               for n in build.sources()):
        build.build_all(seconds)
    for name in build.sources():
        build.library(name)
    return seconds


def engine_config(config: dict):
    """(HierarchicalRecon, EngineCfg) of a configuration's ``profile``: the
    hierarchy, and the path of its ``mode`` with the fields the profile
    gives (the engine's defaults for the rest)."""
    from monoport_tpu_torch.engine import EngineCfg, RayCfg, RotatedCfg
    from monoport_tpu_torch.recon.hierarchy import HierarchicalRecon

    p = config["profile"]
    h = p["hierarchy"]
    recon = HierarchicalRecon(
        resolutions=tuple(h["resolutions"]), budgets=tuple(h["budgets"]),
        b_min=tuple(p["b_min"]), b_max=tuple(p["b_max"]),
        balance_value=p["balance_value"], boundary_tau=h["boundary_tau"],
        dilate=h["dilate"], select=h["select"])
    ray = {k: tuple(p[k]) if isinstance(p[k], list) else p[k]
           for k in _RAY_KEYS if k in p}
    cfg = EngineCfg(
        render_size=p["render_size"],
        compute_dtype=getattr(torch, p["compute_dtype"]),
        ray=RayCfg(mode=p["mode"], **ray),
        rotated=RotatedCfg(**p.get("rotated", {})))
    return recon, cfg


def build_engine(config: dict, states: dict, device):
    """(engine, seconds to build it)."""
    from monoport_tpu_torch.config import CN
    from monoport_tpu_torch.engine import ReconEngine
    from monoport_tpu_torch.weights import build_net

    t0 = time.perf_counter()
    nets = {k: build_net(CN(_opt(config[k])), states[k], device)
            for k in states}
    recon, cfg = engine_config(config)
    engine = ReconEngine(nets["netG"], nets.get("netC"), recon=recon,
                         config=cfg, device=device)
    return engine, time.perf_counter() - t0


def served_config(config: dict):
    """(args, config tree) of ``rtl_main`` at a configuration's profile:
    the demo's own defaults with the profile's fields set. Raises where
    the demo's engine would differ from ``engine_config(config)``."""
    from monoport_tpu_torch.apps import rtl_main

    p = config["profile"]
    h = p["hierarchy"]
    args, cfg = rtl_main.parse_args(["--use_server", "--"] + [
        str(x) for kv in (
            ("recon.mode", p["mode"]), ("recon.fine_res", p["fine_res"]),
            ("recon.ray_taps", p["taps"]), ("recon.ray_window", p["window"]),
            ("recon.march_levels", list(p["march_levels"])),
            ("recon.march_rotated", p["rotated"]["march"]),
            ("recon.resolutions", list(h["resolutions"])),
            ("recon.budgets", list(h["budgets"])),
            ("recon.boundary_tau", h["boundary_tau"]),
            ("recon.dilate", h["dilate"]), ("recon.select", h["select"]),
            ("recon.balance_value", p["balance_value"]),
            ("tpu.compute_dtype", p["compute_dtype"])) for x in kv])
    if rtl_main.engine_config(cfg) != engine_config(config):
        raise ValueError(f"the served engine {rtl_main.engine_config(cfg)} "
                         f"is not the configuration's "
                         f"{engine_config(config)}")
    return args, cfg


def build_served(config: dict, stream, record, device):
    """(pipeline, server) of the served demo over ``stream``: the
    pipeline ``rtl_main.build_pipeline`` builds (not started) and an
    MJPEG server of its state on 127.0.0.1 at a free port (not serving).
    ``record`` sees the stages' use of the shared state:
    ``on_publish(jpeg)`` each JPEG as the composite stage publishes it,
    ``on_hint_write()`` each compaction hint the composite stage writes
    and ``on_hint_read()`` each hint the device stage reads, in the
    stage's own thread. Raises where the demo's segmenters, modes or
    queue depth are not the configuration's ``serve`` entry's."""
    from monoport_tpu_torch.apps import rtl_main
    from monoport_tpu_torch.weights import DATA

    serve = config["serve"]
    for key, name in (("mattenet", "mattenet.npz"),
                      ("detectnet", "detectnet.npz")):
        if not os.path.samefile(os.path.join(DATA, name),
                                os.path.join(_ROOT, serve[key])):
            raise ValueError(f"the demo's {name} is not {serve[key]}")

    class State(rtl_main.FrameState):
        def __init__(self):
            super().__init__()
            self._watched = True

        @property
        def latest_jpeg(self):
            return self._jpeg

        @latest_jpeg.setter
        def latest_jpeg(self, jpeg):
            self._jpeg = jpeg
            if jpeg is not None:
                record.on_publish(jpeg)

        @property
        def compact_hint(self):
            record.on_hint_read()
            return self._hint

        @compact_hint.setter
        def compact_hint(self, hint):
            self._hint = hint
            if getattr(self, "_watched", False):
                record.on_hint_write()

    args, cfg = served_config(config)
    args.device = str(device)
    state = State()
    state.server_mode = serve["server_mode"]
    state.view_mode = serve["view_mode"]
    pipeline = rtl_main.build_pipeline(args, cfg, state, stream)
    depth = {q.maxsize for q in pipeline._queues}
    if depth != {serve["max_queue"]}:
        raise ValueError(f"the demo's queues hold {depth}, not "
                         f"{serve['max_queue']}")
    return pipeline, rtl_main.make_server(state, "127.0.0.1", 0)


def served_floor_witness(config: dict, device):
    """The served scene's floor as the program's own rasterizer draws it
    from the prop's uvs that the program's own OBJ reader returns (the
    scene's ``load_floor`` takes another of its outputs for them) ->
    ``render(extrinsic, intrinsic)``, [S, S, 3] in [0, 1]."""
    from monoport_tpu_torch.pipeline import scene
    from monoport_tpu_torch.render.rasterizer import AlbedoRender
    from monoport_tpu_torch.utils.mesh import load_obj_mesh

    serve = config["serve"]
    obj = os.path.join(_ROOT, serve["floor_obj"])
    texture = scene.floor_textures()[serve["floor"]]
    _, _, uvs, face_uvs, _, _ = load_obj_mesh(obj, with_normal=True,
                                              with_texture=True)
    vert_data, _, _ = scene.load_floor(obj, texture)
    renderer = AlbedoRender(serve["size"], serve["size"], device=device)
    renderer.set_attrib(0, vert_data)
    renderer.set_attrib(1, uvs[face_uvs.reshape(-1)][:, :2])
    renderer.set_texture("TargetTexture", texture)

    def render(extrinsic, intrinsic):
        renderer.draw({"ModelMat": extrinsic, "PerspMat": intrinsic})
        return renderer.get_color()
    return render

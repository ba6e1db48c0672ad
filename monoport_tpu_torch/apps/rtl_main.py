"""Real-time volumetric capture demo on the card (port of
``monoport_tpu/apps/rtl_main.py``).

CLI: arguments before a literal ``--`` go to argparse, config overrides
after it; camera / video / image sources; a threaded 3-stage pipeline
(segment -> device frame -> composite) over ``engine.ReconEngine``;
desktop windows through cv2 when present; a stdlib MJPEG server at
``/video_feed``.

Per frame: the segment stage runs MatteNet and DetectNet on the card and
builds the calib on the host; the device stage runs the engine frame and
packs its display into one uint8 tensor (``_pack_display``), with no
stream sync; the composite stage renders the floor background on the
card, composites, and fetches the packed display and the served frame
with one ``.cpu()``, the frame's only fetch, then encodes the JPEG with
``pipeline/jpeg.py`` (always: the card's machine has no image library).
Each stage enters ``torch.inference_mode()`` itself (autograd state is
per thread).

Run:
    python -m monoport_tpu_torch.apps.rtl_main --image_folder ./frames \
        --use_server [--device cpu] [-- recon.fine_res 129 ...]
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from ..config import get_cfg_defaults
from ..convert import load_legacy_pifu
from ..engine import EngineCfg, RayCfg, ReconEngine, RotatedCfg
from ..models import MonoPortNet
from ..ops.constants import upload_async
from ..pipeline.jpeg import encode_jpeg
from ..pipeline.runtime import Pipeline
from ..pipeline.scene import MonoPortScene
from ..pipeline.segmentation import Segmentation
from ..pipeline.streamer import open_stream
from ..recon.calib import pifu_calib
from ..recon.hierarchy import HierarchicalRecon
from ..render.camera import orbit_extrinsic
from ..utils import compile_cache
from ..weights import DATA, build_net, load_params, resolve_device

MODES = {
    "desktop": "TEXTURE_NORM",   # SEGM | NORM | TEXTURE | TEXTURE_NORM
    "server": "TEXTURE",         # NORM | TEXTURE
    "view": "AUTO",              # FRONT | BACK | LEFT | RIGHT | AUTO | LOAD
}

_VIEW_ANGLES = {"FRONT": (20, 0), "BACK": (20, 180), "LEFT": (20, 90),
                "RIGHT": (20, 270)}

log = logging.getLogger("monoport_tpu_torch.rtl")


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-cfg", "--config_file", default=None)
    parser.add_argument("--camera", action="store_true")
    parser.add_argument("--images", default=[], nargs="*")
    parser.add_argument("--image_folder", default=None)
    parser.add_argument("--videos", default=[], nargs="*")
    parser.add_argument("--loop", action="store_true")
    parser.add_argument("--use_server", action="store_true")
    parser.add_argument("--desktop", action="store_true")
    parser.add_argument("--max_frames", type=int, default=0)
    parser.add_argument("--ip", type=str, default="0.0.0.0")
    parser.add_argument("--port", type=int, default=5555)
    parser.add_argument("--device", default=None,
                        help="torch device; default cuda (no CPU fallback)")

    argv = list(sys.argv[1:] if argv is None else argv)
    # args before a literal '--' go to argparse, after it to the config
    if "--" in argv:
        split = argv.index("--")
        argv, opts = argv[:split], argv[split + 1:]
    else:
        opts = []
    args = parser.parse_args(argv)

    cfg = get_cfg_defaults()
    # the demo profile: coarse 65^3 volume + 257-equivalent per-ray
    # refinement; a config file and CLI overrides still win below
    cfg.recon.mode = "ray"
    cfg.recon.resolutions = [17, 33, 65]
    cfg.recon.budgets = [0, 4096, 16384]
    cfg.recon.ray_window = 192
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(opts)
    cfg.freeze()
    return args, cfg


def _arch_matches_default(cfg, net_key: str) -> bool:
    """True iff cfg.<net_key>'s architecture equals the package default,
    the one the committed weights were trained with (every
    architecture-defining subtree)."""
    default = get_cfg_defaults()[net_key]
    net = cfg[net_key]
    return (dict(net.backbone) == dict(default.backbone)
            and dict(net.head) == dict(default.head)
            and dict(net.normalizer) == dict(default.normalizer)
            and net.projection == default.projection)


def load_networks(cfg, device=None, seed: int = 0):
    """netG and netC on ``device`` -> (netG, netC or None).

    A ``ckpt_path`` that exists on disk is a reference checkpoint (a legacy
    PIFu state dict or a Trainer dict), converted on the fly with the
    backbone map that ``backbone.IMF`` names (``convert.load_legacy_pifu``).
    One set but missing warns. Without a checkpoint the committed capsule
    netG loads when the architecture is the default, and the committed netC
    only with it (it was trained against that netG's features); any other
    netG gets random init from a seeded ``torch.Generator``, and no netC.
    """
    device = resolve_device(device)
    for net_key in ("netG", "netC"):
        path = cfg[net_key].ckpt_path
        if path and not os.path.exists(path):
            log.warning("%s.ckpt_path %r not found on disk", net_key, path)

    def from_ckpt(key: str):
        path = cfg[key].ckpt_path
        if not (path and os.path.exists(path)):
            return None
        state = load_legacy_pifu(path, cfg[key].backbone.IMF)
        return build_net(cfg[key], state, device)

    def committed(key: str, fname: str):
        path = os.path.join(DATA, fname)
        if not (_arch_matches_default(cfg, key) and os.path.exists(path)):
            return None
        if cfg[key].ckpt_path:
            log.warning("using the committed capsule %s demo weights "
                        "instead of %r", key, cfg[key].ckpt_path)
        return build_net(cfg[key], load_params(path)[0], device)

    netG = from_ckpt("netG")
    netC = from_ckpt("netC")
    if netG is None:
        netG = committed("netG", "netg_capsule.npz")
        if netG is None:
            netG = _init_random_net(cfg.netG, device, seed)
        elif netC is None:
            # the committed netC pairs only with the committed netG
            netC = committed("netC", "netc_capsule.npz")
    return netG, netC


def _init_random_net(opt_net, device, seed: int = 0) -> MonoPortNet:
    """Random init when no checkpoint applies (the demo still runs): conv
    and linear weights uniform in +-1/sqrt(fan_in) from a seeded generator,
    biases 0, norms weight 1 (BatchNorm with its default running stats);
    the head's input width from a probe of the backbone (its last stage's
    channels + the z feature)."""
    from ..models.backbones import BACKBONES
    from ..models.heads.surface_classifier import HEAD_SPECS

    with torch.no_grad():
        feats = BACKBONES[opt_net.backbone.IMF](opt_net.backbone).eval()(
            torch.zeros(1, 128, 128, 3))[-1]
    widths = HEAD_SPECS[opt_net.head.IMF][0]
    gen = torch.Generator().manual_seed(seed)
    net = MonoPortNet(opt_net, head_channels=(
        sum(f.shape[-1] for f in feats) + 1, *widths[1:]))
    with torch.no_grad():
        for p in net.parameters():
            if p.dim() > 1:
                bound = 1.0 / np.sqrt(p[0].numel())
                p.uniform_(-bound, bound, generator=gen)
            else:
                p.zero_()
    for m in net.modules():
        if isinstance(m, (torch.nn.GroupNorm, torch.nn.BatchNorm2d)):
            torch.nn.init.ones_(m.weight)
    return net.requires_grad_(False).eval().to(device)


class FrameState:
    """Mutable UI state shared by the stages, the server and the hotkeys."""

    def __init__(self):
        self.desktop_mode = MODES["desktop"]
        self.server_mode = MODES["server"]
        self.view_mode = MODES["view"]
        self.latest_jpeg: bytes | None = None
        self.lock = threading.Lock()
        # adaptive rotated-compaction hint: the composite stage writes the
        # fetched valid fraction back, the device stage feeds it to the
        # NEXT frame (engine.compact_hint_from_valid / COMPACT_LADDER)
        self.compact_hint: float | None = None
        # the running pipeline (main_loop), for a caller reading its stats
        self.pipeline: Pipeline | None = None


def _pack_display(out: dict) -> torch.Tensor:
    """[S, S, 8] uint8 on the device: render_norm, render_tex (render_norm
    without netC), mask, and the valid fraction broadcast to a plane (the
    depth-based fraction: stable under compaction drops, which whiten
    'mask'), so that one fetch carries all of it."""
    norm = torch.nan_to_num(out["render_norm"].float(), nan=1.0)
    tex = torch.nan_to_num(out.get("render_tex", out["render_norm"]).float(),
                           nan=1.0)
    mask = out["mask"].float()
    frac = out["valid"].float().mean()
    stack = torch.cat([norm, tex, mask, frac.expand(*mask.shape[:2], 1)],
                      dim=-1)
    return (stack * 255.0).clamp(0, 255).to(torch.uint8)


def engine_config(cfg) -> tuple[HierarchicalRecon, EngineCfg]:
    """The engine of the config tree (the demo's ``recon`` and ``tpu``
    sections; ``tpu.use_pallas`` means nothing on the card, where the
    kernels always run)."""
    recon = HierarchicalRecon(
        resolutions=tuple(cfg.recon.resolutions),
        budgets=tuple(cfg.recon.budgets),
        boundary_tau=cfg.recon.boundary_tau,
        dilate=cfg.recon.dilate,
        balance_value=cfg.recon.balance_value,
        select=cfg.recon.select)
    march = (tuple(cfg.recon.march_levels) if cfg.recon.mode == "ray"
             else None)
    config = EngineCfg(
        compute_dtype=getattr(torch, cfg.tpu.compute_dtype),
        ray=RayCfg(mode=cfg.recon.mode, fine_res=cfg.recon.fine_res,
                   taps=cfg.recon.ray_taps,
                   window=cfg.recon.ray_window or None,
                   march_levels=march or None),
        rotated=RotatedCfg(march=cfg.recon.march_rotated))
    return recon, config


def build_pipeline(args, cfg, state: FrameState,
                   stream: Optional[Iterable] = None) -> Pipeline:
    """The demo's pipeline over ``stream`` (frames [H, W, 3] in [0, 1]; None
    = the source the arguments name, ``open_stream``)."""
    device = resolve_device(getattr(args, "device", None))
    netG, netC = load_networks(cfg, device)
    recon, config = engine_config(cfg)
    engine = ReconEngine(netG, netC, recon=recon, config=config,
                         device=device)
    seg = Segmentation.load_default(device=device)
    scene = MonoPortScene(size=(256, 256), device=device)
    mean = torch.tensor(cfg.netG.mean, dtype=torch.float32, device=device)
    std = torch.tensor(cfg.netG.std, dtype=torch.float32, device=device)

    def stage_segment(frame):
        """Segmentation, camera and calib."""
        with torch.inference_mode():
            image = upload_async(np.asarray(frame, np.float32)[None], device)
            segm, bboxes, probs = seg(image)
            if state.view_mode in _VIEW_ANGLES:
                extrinsic = orbit_extrinsic(*_VIEW_ANGLES[state.view_mode])
                intrinsic = scene.intrinsic
            else:
                extrinsic, intrinsic = scene.update_camera(
                    load=(state.view_mode == "LOAD"))
            # the calib stays a host array: the engine picks its path from it
            calib = pifu_calib(extrinsic, intrinsic)
            rgb, alpha = segm[..., :3], segm[..., 3:4]
            return {"segm": segm, "bboxes": bboxes, "probs": probs,
                    "input_netG": (((rgb * 0.5 + 0.5) - mean) / std) * alpha,
                    "input_netC": rgb * alpha, "calib": calib,
                    "extrinsic": np.array(extrinsic),
                    "intrinsic": np.array(intrinsic)}

    def stage_device(d):
        """The engine frame and the packed display; no stream sync."""
        with torch.inference_mode():
            out = engine.frame(d["input_netG"], d["input_netC"], d["calib"],
                               compact_hint=state.compact_hint)
            d["display_packed"] = _pack_display(out)
            d.update(out)
            return d

    def stage_composite(d):
        """The floor background, the composite, the frame's one fetch, and
        the JPEG."""
        with torch.inference_mode():
            background = scene.render(d["extrinsic"], d["intrinsic"])
            packed = d["display_packed"]
            disp = packed.float() / 255.0
            fg = disp[..., 3:6] if state.server_mode == "TEXTURE" \
                else disp[..., 0:3]
            mask = disp[..., 6:7]
            frame = (mask * fg + (1.0 - mask) * background).clamp(0, 1)
            served = (frame * 255.0).to(torch.uint8)
            host = torch.cat([packed, served], dim=-1).cpu().numpy()
        # the valid fraction back as the NEXT frame's compaction hint (the
        # uint8 quantization, ~0.4%, is inside the hint's 1.3x headroom)
        state.compact_hint = engine.compact_hint_from_valid(
            host[0, 0, 7] / 255.0)
        d["display_host"] = host[..., :8]
        d["render_norm_host"] = host[..., 0:3].astype(np.float32) / 255.0
        d["render_tex_host"] = host[..., 3:6].astype(np.float32) / 255.0
        d["window_server"] = host[..., 8:11]
        t0 = time.perf_counter()
        jpeg = encode_jpeg(d["window_server"])
        d["jpeg_ms"] = (time.perf_counter() - t0) * 1e3
        with state.lock:
            state.latest_jpeg = jpeg
        return d

    stage_segment.__name__ = "segment"
    stage_device.__name__ = "device_frame"
    stage_composite.__name__ = "composite"

    if stream is None:
        stream = open_stream(camera=args.camera, videos=args.videos,
                             images=args.images,
                             image_folder=args.image_folder, loop=args.loop)
    pipeline = Pipeline(stream, [stage_segment, stage_device,
                                 stage_composite],
                        max_queue=2, name="rtl")
    pipeline.engine = engine      # for the end-of-run reports (main_loop)
    pipeline.segmentation = seg
    return pipeline


class MJPEGHandler(BaseHTTPRequestHandler):
    """``/``: the landing page; ``/video_feed``: the multipart MJPEG stream
    of ``state.latest_jpeg``. Bind a state with ``make_server``."""
    state: FrameState = None

    def log_message(self, *a):  # quiet
        pass

    def do_GET(self):
        if self.path == "/":
            page = os.path.join(os.path.dirname(__file__), "templates",
                                "index.html")
            try:
                with open(page, "rb") as f:
                    body = f.read()
            except OSError:
                body = b"<html><body><img src='/video_feed'/></body></html>"
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.end_headers()
            self.wfile.write(body)
            return
        if self.path != "/video_feed":
            self.send_error(404)
            return
        self.send_response(200)
        self.send_header("Content-Type",
                         "multipart/x-mixed-replace; boundary=frame")
        self.end_headers()
        try:
            while True:
                with self.state.lock:
                    jpeg = self.state.latest_jpeg
                if jpeg is not None:
                    self.wfile.write(b"--frame\r\n"
                                     b"Content-Type: image/jpeg\r\n\r\n")
                    self.wfile.write(jpeg)
                    self.wfile.write(b"\r\n")
                time.sleep(1.0 / 30)
        except (BrokenPipeError, ConnectionResetError):
            return


def make_server(state: FrameState, ip: str, port: int) -> ThreadingHTTPServer:
    """An MJPEG server of ``state`` (not yet serving; port 0 = any free
    port, read it from ``server_address``)."""
    handler = type("BoundMJPEGHandler", (MJPEGHandler,), {"state": state})
    return ThreadingHTTPServer((ip, port), handler)


_HOTKEYS = {"q": ("desktop_mode", "SEGM"), "w": ("desktop_mode", "NORM"),
            "e": ("desktop_mode", "TEXTURE"),
            "r": ("desktop_mode", "TEXTURE_NORM"),
            "s": ("server_mode", "NORM"), "d": ("server_mode", "TEXTURE"),
            "z": ("view_mode", "FRONT"), "x": ("view_mode", "BACK"),
            "c": ("view_mode", "LEFT"), "v": ("view_mode", "RIGHT"),
            "b": ("view_mode", "AUTO"), "n": ("view_mode", "LOAD")}


def main_loop(args, cfg, state: FrameState,
              stream: Optional[Iterable] = None,
              on_frame: Optional[Callable[[dict], None]] = None) -> int:
    """Run the pipeline over ``stream`` (None: the arguments' source) until
    it ends or ``args.max_frames``; ``on_frame(d)`` sees every served
    frame. Prints the stage report and the frame's band / compaction
    reports. -> frames served."""
    pipeline = build_pipeline(args, cfg, state, stream)
    state.pipeline = pipeline
    n, last = 0, None
    for d in pipeline:
        n += 1
        last = d
        if on_frame is not None:
            on_frame(d)
        if args.desktop:
            _desktop_window(d, state)
        if args.max_frames and n >= args.max_frames:
            pipeline.close()
            break
    print(pipeline.report())
    if last is not None and "recon_counts" in last:
        print(pipeline.engine.band_report(last))
    if last is not None and "compact_dropped" in last:
        # rotated-frame compaction overflow must be visible
        report = pipeline.engine.compact_report(last)
        print(report)
        if "OVERFLOW" in report:
            log.warning(report)
    return n


def _desktop_window(d, state: FrameState):  # pragma: no cover - UI path
    import cv2

    segm = d["segm"][0].float().cpu().numpy()
    input_img = segm[..., :3] * 0.5 + 0.5
    if state.desktop_mode == "SEGM":
        seg_img = (segm[..., :3] * segm[..., 3:4]) * 0.5 + 0.5
        window = np.hstack([input_img, seg_img])
    else:
        fg, norm = d["render_tex_host"], d["render_norm_host"]
        if state.desktop_mode == "TEXTURE_NORM":
            window = np.vstack([fg, norm])
        else:
            img = norm if state.desktop_mode == "NORM" else fg
            img = cv2.resize(img, input_img.shape[:2][::-1])
            window = np.hstack([input_img, img])
    cv2.imshow("monoport_tpu_torch", window[..., ::-1])
    key = cv2.waitKey(1)
    if key > 0 and chr(key & 0xFF) in _HOTKEYS:
        attr, value = _HOTKEYS[chr(key & 0xFF)]
        setattr(state, attr, value)


def main(argv=None):
    args, cfg = parse_args(argv)
    compile_cache.enable()      # reuse the kernel libraries of earlier runs
    state = FrameState()
    server = None
    if args.use_server:
        server = make_server(state, args.ip, args.port)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        print(f"MJPEG server at http://{args.ip}:{args.port}/video_feed")
    try:
        return main_loop(args, cfg, state)
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()


if __name__ == "__main__":
    main()

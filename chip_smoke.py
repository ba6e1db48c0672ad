"""Card check of the PyTorch port: build, kernel parity, full-width frame.

    python3 chip_smoke.py

Needs one CUDA card and the repository checkout around this file; exits
non-zero, printing no result, without either. Phases (one JSON line each):

1. device: the card's name and power limit (nvidia-smi) and versions;
2. build: compiles the frame's kernel from the checkout's source;
3. kernel: each kernel against its plain twin on the card, at the shapes
   the frame gives it, in bf16 and f32, with times (CUDA events) and the
   bound (the larger of FLOPs over the card's peak and bytes over its
   memory rate, H100 SXM data-sheet peaks);
4. frame: the committed netG + netC at full width through ReconEngine at
   the real-time operating point, bf16, a few frames timed; the launch
   counts are zeroed just before and read just after, and must be exactly
   4 ray-MLP launches a frame; the last bf16 frame and then one f32 frame
   are held to the JAX golden (f32) at ``frame_check``'s limits.

Then the kernels line, the card line, and last the result line. Any failed
check raises, and the script exits non-zero.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join("monoport_tpu_torch", "csrc", "fused_ray_mlp.cu")

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, f32 without them,
# HBM3 bandwidth
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
PEAK_BYTES = 3.35e12
TOL = {"f32": {"atol": 2e-5, "rtol": 1e-4}, "bf16": {"atol": 2e-2, "rtol": 0.0}}
FRAMES = 5


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ray_mlp_work(head, rays: int, taps: int, dtype: str):
    """(FLOPs, bytes) the ray MLP must do for rays x taps at the head's
    unpadded widths: W_f once per ray, the hidden products per tap."""
    layers = head.layers()
    c_f = layers[0].weight.shape[1] - 1
    outs = [lin.weight.shape[0] for lin in layers]
    mac_ray = c_f * sum(outs)
    mac_tap = sum(a * b for a, b in zip(outs[:-1], outs[1:]))
    flops = 2.0 * (rays * mac_ray + rays * taps * mac_tap)
    op = 2 if dtype == "bf16" else 4
    n_params = sum(lin.weight.numel() for lin in layers)
    nbytes = (rays * c_f * op + rays * taps * 4 + n_params * op
              + rays * taps * outs[-1] * 4)
    return flops, nbytes


def kernel_phase(netG, netC, tray):
    """Kernel vs plain twin at the four shapes of the frame."""
    import numpy as np
    import torch

    shapes = [("march", netG, 33 * 33, 33), ("refine65", netG, 65 * 65, 6),
              ("refine257", netG, 192 * 192, 6), ("colour", netC, 192 * 192, 1)]
    rows = []
    for dname, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        packs = {id(n): tray.pack_ray_mlp_params(n.surface_classifier,
                                                 dtype=dtype, device="cuda")
                 for n in (netG, netC)}
        for i, (name, net, rays, taps) in enumerate(shapes):
            p = packs[id(net)]
            rng = np.random.RandomState(100 + i)
            feat = torch.from_numpy(rng.randn(1, rays, p.c_f).astype(
                np.float32)).cuda()
            z = torch.from_numpy(rng.uniform(-1.3, 1.3, (1, rays, taps))
                                 .astype(np.float32)).cuda()
            got = tray.apply_ray(p, feat, z)
            want = tray.apply_ray_plain(p, feat, z)
            torch.cuda.synchronize()
            err = (got - want).abs()
            tol = TOL[dname]
            ok = bool(torch.all(err <= tol["atol"] + tol["rtol"]
                                * want.abs()).item()
                      and torch.isfinite(got).all().item())
            flops, nbytes = ray_mlp_work(net.surface_classifier, rays, taps,
                                         dname)
            t_flop, t_byte = flops / PEAK_FLOPS[dname], nbytes / PEAK_BYTES
            reps = 20 if dname == "bf16" else 5
            row = {"phase": "kernel", "kernel": "fused_ray_mlp",
                   "shape": name, "dtype": dname, "rays": rays, "taps": taps,
                   "c_f": p.c_f, "max_abs_err": float(err.max().item()),
                   "atol": tol["atol"], "rtol": tol["rtol"], "ok": ok,
                   "ms": cuda_ms(lambda: tray.apply_ray(p, feat, z), reps),
                   "plain_ms": cuda_ms(
                       lambda: tray.apply_ray_plain(p, feat, z), reps),
                   "gflop": flops / 1e9,
                   "bound_ms": max(t_flop, t_byte) * 1e3,
                   "bound_by": "operations" if t_flop >= t_byte else "bytes",
                   "library_ms": None}
            emit(row)
            if not ok:
                fail(f"fused_ray_mlp {name} {dname}: kernel disagrees with "
                     f"its twin (max abs err {row['max_abs_err']})")
            rows.append(row)
    return rows


def find_syncs(fn) -> list[str]:
    """The Python stacks at which ``fn`` synchronises the stream (torch's
    sync debug mode)."""
    import traceback
    import warnings

    import torch

    found = []

    def hook(message, *args, **kwargs):
        if "synchroniz" in str(message):
            found.append("".join(traceback.format_stack(limit=6)[:-1]))

    # (setting the mode warns once by itself: set it before listening)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = hook
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return found


def profile_phase(eng, image, calib, card: str, frame_ms: float,
                  frames: int = 2) -> None:
    """Device time by kernel over a few bf16 frames (torch.profiler), and
    the device's idle share of the unprofiled median frame time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            eng.frame(image, image, calib)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / frames
    kernels = [(e.key, e.self_device_time_total / 1e3 / frames,
                e.count // frames) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    kernels.sort(key=lambda k: -k[1])
    busy = sum(k[1] for k in kernels)
    emit({"phase": "profile", "dtype": "bf16", "frames": frames,
          "wall_ms_per_frame": wall_ms, "device_ms_per_frame": busy,
          "device_idle_share": 1.0 - busy / frame_ms,
          "device_idle_share_profiled": 1.0 - busy / wall_ms,
          "kernel_launches_per_frame": sum(k[2] for k in kernels),
          "top": [{"kernel": k[0][:90], "ms": k[1], "calls": k[2]}
                  for k in kernels[:20]], "card": card})


def frame_phase(netG, netC, tray, card: str):
    import torch

    from monoport_tpu_torch import frame_check
    from monoport_tpu_torch.engine import ReconEngine

    golden = frame_check.load_golden()
    image = torch.from_numpy(golden["image"]).cuda()
    calib = golden["calib"]

    recon, cfg = frame_check.rtl_config(torch.bfloat16)
    eng = ReconEngine(netG, netC, recon=recon, config=cfg)
    eng.frame(image, image, calib)                       # warm-up
    torch.cuda.synchronize()
    if not find_syncs(lambda: torch.zeros(1, device="cuda").item()):
        fail("the sync detector misses a known sync")
    syncs = find_syncs(lambda: eng.frame(image, image, calib))
    if syncs:
        fail(f"a frame synchronised the stream at {syncs}")
    torch.cuda.synchronize()
    tray.apply_ray.launches = 0
    times = []
    for _ in range(FRAMES):
        t0 = time.perf_counter()
        out = eng.frame(image, image, calib)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = tray.apply_ray.launches
    if launches != 4 * FRAMES:
        fail(f"fused_ray_mlp launched {launches} times in {FRAMES} frames, "
             f"expected {4 * FRAMES}")
    shapes = {k: tuple(v.shape) for k, v in out.items()}
    if shapes != {"depth": (257, 257), "valid": (257, 257),
                  "render_norm": (256, 256, 3), "render_tex": (256, 256, 3),
                  "mask": (256, 256, 1)}:
        fail(f"frame output shapes {shapes}")
    for k in ("depth", "render_norm", "render_tex"):
        if not torch.isfinite(out[k]).all():
            fail(f"bf16 frame: non-finite {k}")
    med = statistics.median(times)
    emit({"phase": "frame", "dtype": "bf16", "frames": FRAMES,
          "frame_ms_median": med, "fps": 1e3 / med, "frame_ms": times,
          "ray_mlp_launches": launches, "launches_per_frame": launches / FRAMES,
          "host_syncs_per_frame": len(syncs), "card": card})
    res16 = frame_check.compare_to_golden(out, golden,
                                          frame_check.BF16_LIMITS)
    emit({"phase": "golden", "dtype": "bf16", **res16,
          "limits": frame_check.BF16_LIMITS._asdict(), "card": card})
    profile_phase(eng, image, calib, card, med)

    recon, cfg = frame_check.rtl_config(torch.float32)
    eng32 = ReconEngine(netG, netC, recon=recon, config=cfg)
    t0 = time.perf_counter()
    out32 = eng32.frame(image, image, calib)
    torch.cuda.synchronize()
    ms32 = (time.perf_counter() - t0) * 1e3
    res = frame_check.compare_to_golden(out32, golden)
    emit({"phase": "golden", "dtype": "f32", "frame_ms": ms32, **res,
          "limits": frame_check.F32_LIMITS._asdict(), "card": card})
    for dname, r in (("bf16", res16), ("f32", res)):
        if not r["ok"]:
            fail(f"{dname} frame disagrees with the JAX golden: {r}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    if not os.path.exists(os.path.join(ROOT, SOURCE)):
        fail("the repository checkout is not beside this script")
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    emit({"phase": "device", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})

    from monoport_tpu_torch.ops.cuda import fused_ray_mlp as tray
    from monoport_tpu_torch.weights import load_default_networks

    t0 = time.perf_counter()
    lib = tray.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": os.path.relpath(lib, ROOT)})

    netG, netC = load_default_networks()
    rows = kernel_phase(netG, netC, tray)
    launches = frame_phase(netG, netC, tray, card)

    path = [r for r in rows if r["dtype"] == "bf16"]
    emit({"kernels": [{
        "name": "fused_ray_mlp", "route": "cuda",
        "source": SOURCE,
        "replaces": "monoport_tpu/ops/pallas/fused_ray_mlp.py:109",
        "launches": launches,
        # per frame: the four bf16 launches of the frame, summed
        "max_abs_err": max(r["max_abs_err"] for r in path),
        "ms": sum(r["ms"] for r in path),
        "plain_ms": sum(r["plain_ms"] for r in path),
        "bound_ms": sum(r["bound_ms"] for r in path),
        "bound_by": "operations"
        if all(r["bound_by"] == "operations" for r in path) else "bytes",
        "library_ms": None,
        "shapes": {f"{r['shape']}/{r['dtype']}": {
            k: r[k] for k in ("ms", "plain_ms", "bound_ms", "max_abs_err")}
            for r in rows}}]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

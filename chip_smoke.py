"""Card check of the PyTorch port: build, kernel parity, full-width frame.

    python3 chip_smoke.py

Needs one CUDA card and the repository checkout around this file; exits
non-zero, printing no result, without either. Phases (one JSON line each):

1. device: the card's name and power limit (nvidia-smi) and versions;
2. build: compiles every kernel source of the checkout, one compiler a
   source, all started together, each timed;
3. kernel: each of the four kernels against its plain version on the
   card, at every shape a frame of phases 4-8 or the gather A/B launches
   it on (the hierarchy levels' come from ``frame_check``'s budgets), in
   bf16 and f32, with times (CUDA events)
   and the bound (the larger of operations over the card's peak for their
   type and bytes over its memory rate, H100 SXM data-sheet peaks);
4. frame: the committed netG + netC at full width through ReconEngine at
   the real-time operating point, bf16, a few frontal frames timed; the
   launch counts are zeroed just before and read just after, and must be
   exactly 4 ray-MLP launches a frame and no other; no stream sync inside
   a frame; the profile; the last bf16 frame and then one f32 frame are
   held to the JAX golden (f32) at ``frame_check``'s limits;
5. rotated frame: the same engines on the orbit camera's calib
   (``frame_check.rotated_calib``): the counts zeroed and read again and
   held to what the pose's anchor plan implies (the per-point MLP once
   for the march and once for each per-point refine level, the anchored
   MLP once for each anchored level, the ray MLP never), no stream sync,
   a frame with a ``compact_hint`` held to the plain frame where nothing
   dropped, the profile, and the bf16 and f32 frames held to the rotated
   JAX golden;
6. dense frame: the same nets under ``frame_check.quality_config``
   (``mode='dense'``, the 257^3 hierarchy), frontal calib, bf16 timed and
   f32 once: the per-point MLP once for every hierarchy level and the ray
   MLP once for the frontal colour, no stream sync, ``recon_counts``
   against the budgets (``band_report``), the profile, the frames held
   to the dense JAX golden, its subsampled ``sdf`` and ``recon_counts``
   included, and to the same frames run through the plain versions of the
   kernels on the card (f32: ``recon_counts`` equal);
7. mesh: ``extract_mesh`` of the f32 dense frame's ``sdf``: counts, and
   every edge away from the volume's border shared by two faces;
8. hierarchy frame: the rotated calib under the real-time engine with
   ``rotated.march=False`` (hierarchy 17, 33, 65, then ``ray_refine``):
   the per-point MLP once a level, the anchored MLP as the pose's plan
   says, no stream sync, held to the same frame run through the plain
   versions of the kernels on the card, bf16 and f32 (f32:
   ``recon_counts`` and ``compact_dropped`` equal);
9. frames: a clip of two frontal frames and a rotated one through
   ``frames()``; each output equals the ``frame()`` of that input;
10. gather A/B: ``profile_gather.run``, the gathering kernel's entry
    point: ``index`` -> ray MLP, the gather inside the kernel, and the
    ``index_grid`` lattice -> ray MLP at two frame shapes.

Then the kernels line (four kernels), the card line, and last the result
line. Any failed check raises, and the script exits non-zero.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join("monoport_tpu_torch", "csrc")
F32_FMA_PEAK = 67e12
# anchors a ray of the hierarchy frame's refine (65 -> 257 at the rotated
# pose): the kernel phase measures the anchored MLP there, and the hierarchy
# phase fails if the pose's plan says otherwise
HIERARCHY_ANCHORS = 3

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


def _head_dims(head):
    layers = head.layers()
    outs = [lin.weight.shape[0] for lin in layers]
    return layers[0].weight.shape[1], outs, sum(
        lin.weight.numel() for lin in layers)


def ray_mlp_work(head, rays: int, taps: int, dtype: str, anchors: int = 1,
                 mixed: bool = False):
    """(seconds of operations at the card's peaks, bytes) the ray MLP
    (``anchors`` = 1) or the anchored MLP (``mixed``) must do for rays x
    taps at the head's unpadded widths: W_f once per ray and anchor, the
    hidden products per tap, and the K-term hat mix per tap and column as
    f32 multiply-adds."""
    c_in, outs, n_params = _head_dims(head)
    c_f = c_in - 1
    mac_ray = anchors * c_f * sum(outs)
    mac_tap = sum(a * b for a, b in zip(outs[:-1], outs[1:]))
    flops = 2.0 * (rays * mac_ray + rays * taps * mac_tap)
    mix = 2.0 * rays * taps * anchors * sum(outs) if mixed else 0.0
    op = 2 if dtype == "bf16" else 4
    nbytes = (rays * anchors * c_f * op + rays * taps * 4
              + (rays * taps * anchors * 4 if mixed else 0) + n_params * op
              + rays * taps * outs[-1] * 4)
    return flops + mix, flops / PEAK_FLOPS[dtype] + mix / F32_FMA_PEAK, nbytes


def point_mlp_work(head, points: int, dtype: str):
    """The same for the per-point MLP: every layer's W_x x and W_h h per
    point."""
    c_in, outs, n_params = _head_dims(head)
    mac = c_in * outs[0] + sum((a + c_in) * b
                               for a, b in zip(outs[:-1], outs[1:]))
    flops = 2.0 * points * mac
    op = 2 if dtype == "bf16" else 4
    nbytes = points * c_in * op + n_params * op + points * outs[-1] * 4
    return flops, flops / PEAK_FLOPS[dtype], nbytes


def gather_mlp_work(head, rays: int, taps: int, dtype: str, map_shape):
    """The same for the gathering ray MLP: the ray MLP's operations plus
    the 4-tap f32 combine of every ray's feature row; the bytes are the
    f32 map, uv, z, the weights and the output, each once (the gathered
    rows never reach device memory)."""
    c_in, outs, n_params = _head_dims(head)
    flops, t_ops, _ = ray_mlp_work(head, rays, taps, dtype)
    combine = 2.0 * rays * 4 * (c_in - 1)
    op = 2 if dtype == "bf16" else 4
    nbytes = (4 * map_shape[1] * map_shape[2] * (c_in - 1) + rays * 2 * 4
              + rays * taps * 4 + n_params * op + rays * taps * outs[-1] * 4)
    return flops + combine, t_ops + combine / F32_FMA_PEAK, nbytes


def hat_weights(rng, rays: int, taps: int, anchors: int):
    """Real hat weights [1, rays, taps, anchors]: each tap's two
    neighbouring anchors, summing to 1."""
    import numpy as np

    alpha = np.sort(rng.rand(1, rays, taps).astype(np.float32), axis=-1)
    pos = alpha[..., None] * (anchors - 1) - np.arange(anchors,
                                                       dtype=np.float32)
    return np.maximum(0.0, 1.0 - np.abs(pos)).astype(np.float32)


def kernel_phase(netG, netC, tray, tmlp, tgather):
    """Every kernel vs its plain version at the shapes of the frames, the
    hierarchy levels and the gather A/B."""
    import numpy as np
    import torch

    from monoport_tpu_torch import frame_check, profile_gather

    # a hierarchy queries its coarsest lattice whole, then a budget a level
    levels = set()
    for recon in (frame_check.rtl_config()[0],
                  frame_check.quality_config()[0]):
        levels |= {recon.resolutions[0] ** 3, *recon.budgets[1:]}
    fine = frame_check.QUALITY_RESOLUTIONS[-1]
    # (kernel, shape name, net, rays or points, taps, anchors)
    shapes = [("fused_ray_mlp", "march", netG, 33 * 33, 33, 1),
              ("fused_ray_mlp", "refine65", netG, 65 * 65, 6, 1),
              ("fused_ray_mlp", "refine257", netG, 192 * 192, 6, 1),
              ("fused_ray_mlp", "colour", netC, 192 * 192, 1, 1),
              ("fused_mlp", "march", netG, 33 ** 3, 1, 1),
              ("fused_mlp", "refine65_points", netG, 2304 * 6, 1, 1),
              ("fused_mlp", "colour_points", netC, 18432, 1, 1),
              ("fused_anchor_mlp", "refine65", netG, 2304, 6, 5),
              ("fused_anchor_mlp", "refine257", netG, 18432, 6, 3),
              ("fused_mlp", "coarse_4913", netG, 17 ** 3, 1, 1),
              ("fused_mlp", "level_16384", netG, 16384, 1, 1),
              ("fused_mlp", "level_262144", netG, 262144, 1, 1)]
    shapes += [("fused_gather_mlp", name, netG, rays, taps, 1)
               for name, rays, taps in profile_gather.SHAPES]
    # a row's inputs are seeded by its place in the list: new rows go at the
    # end, so that earlier rows keep their inputs and their errors compare
    # from run to run. Every hierarchy level not yet in the list gets a row.
    shapes += [("fused_ray_mlp", "colour_dense", netC, fine * fine, 1, 1),
               ("fused_anchor_mlp", "refine257_window", netG, 192 * 192, 6,
                HIERARCHY_ANCHORS)]
    have = {s[3] for s in shapes if s[0] == "fused_mlp" and s[2] is netG}
    shapes += [("fused_mlp", f"level_{n}", netG, n, 1, 1)
               for n in sorted(levels - have)]
    rows = []
    for dname, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        packs = {}
        for n in (netG, netC):
            packs[id(n), "ray"] = tray.pack_ray_mlp_params(
                n.surface_classifier, dtype=dtype, device="cuda")
            packs[id(n), "point"] = tmlp.pack_mlp_params(
                n.surface_classifier, dtype=dtype, device="cuda")
        for i, (kernel, name, net, rays, taps, k) in enumerate(shapes):
            head = net.surface_classifier
            rng = np.random.RandomState(100 + i)
            cuda = lambda a: torch.from_numpy(a.astype(np.float32)).cuda()
            if kernel == "fused_gather_mlp":
                p = packs[id(net), "ray"]
                fmap = cuda(rng.randn(*profile_gather.MAP))
                args = (fmap, cuda(rng.uniform(-0.74, 0.74, (1, rays, 2))),
                        cuda(rng.randn(1, rays, taps) * 0.3))
                fn = tgather.apply_gather_ray
                plain = tgather.apply_gather_plain
                work = gather_mlp_work(head, rays, taps, dname, fmap.shape)
            elif kernel == "fused_mlp":
                p = packs[id(net), "point"]
                args = (cuda(rng.randn(1, rays, p.c_f)),)
                fn, plain = tmlp.apply_mlp, tmlp.apply_mlp_plain
                work = point_mlp_work(head, rays, dname)
            else:
                p = packs[id(net), "ray"]
                z = cuda(rng.uniform(-1.3, 1.3, (1, rays, taps)))
                if kernel == "fused_ray_mlp":
                    args = (cuda(rng.randn(1, rays, p.c_f)), z)
                    fn, plain = tray.apply_ray, tray.apply_ray_plain
                    work = ray_mlp_work(head, rays, taps, dname)
                else:
                    args = (cuda(rng.randn(1, rays, k, p.c_f)),
                            cuda(hat_weights(rng, rays, taps, k)), z)
                    fn, plain = tray.apply_anchor, tray.apply_anchor_plain
                    work = ray_mlp_work(head, rays, taps, dname, anchors=k,
                                        mixed=True)
            got = fn(p, *args)
            want = plain(p, *args)
            torch.cuda.synchronize()
            err = (got - want).abs()
            tol = TOL[dname]
            ok = bool(torch.all(err <= tol["atol"] + tol["rtol"]
                                * want.abs()).item()
                      and torch.isfinite(got).all().item())
            flops, t_ops, nbytes = work
            t_byte = nbytes / PEAK_BYTES
            reps = 20 if dname == "bf16" else 5
            row = {"phase": "kernel", "kernel": kernel, "shape": name,
                   "dtype": dname, "rays": rays, "taps": taps, "anchors": k,
                   "c_in": p.c_f, "max_abs_err": float(err.max().item()),
                   "atol": tol["atol"], "rtol": tol["rtol"], "ok": ok,
                   "ms": cuda_ms(lambda: fn(p, *args), reps),
                   "plain_ms": cuda_ms(lambda: plain(p, *args), reps),
                   "gflop": flops / 1e9,
                   "bound_ms": max(t_ops, t_byte) * 1e3,
                   "bound_by": "operations" if t_ops >= t_byte else "bytes",
                   "library_ms": None}
            emit(row)
            if not ok:
                fail(f"{kernel} {name} {dname}: the kernel disagrees with "
                     f"its plain version (max abs err {row['max_abs_err']})")
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
                  view: str, frames: int = 2) -> None:
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
    emit({"phase": "profile", "view": view, "dtype": "bf16",
          "frames": frames,
          "wall_ms_per_frame": wall_ms, "device_ms_per_frame": busy,
          "device_idle_share": 1.0 - busy / frame_ms,
          "device_idle_share_profiled": 1.0 - busy / wall_ms,
          "kernel_launches_per_frame": sum(k[2] for k in kernels),
          "top": [{"kernel": k[0][:90], "ms": k[1], "calls": k[2]}
                  for k in kernels[:20]], "card": card})


FRAME_SHAPES = {"depth": (257, 257), "valid": (257, 257),
                "render_norm": (256, 256, 3), "render_tex": (256, 256, 3),
                "mask": (256, 256, 1)}


def timed_frames(eng, image, calib, counters: dict, expect: dict,
                 view: str, card: str, shapes: dict = FRAME_SHAPES,
                 depth_on_valid: bool = False):
    """Warm up, check for stream syncs, then time FRAMES bf16 frames with
    the launch counts zeroed just before and read just after; ``expect``
    is the launches a frame of each kernel, ``shapes`` the outputs'.
    ``depth_on_valid``: a frame whose depth is peeled from a volume carries
    none (0/0) on a ray with no hit, and is held finite on valid pixels
    only. -> (last output, median ms, launches by kernel)."""
    import torch

    eng.frame(image, image, calib)                       # warm-up
    torch.cuda.synchronize()
    syncs = find_syncs(lambda: eng.frame(image, image, calib))
    if syncs:
        fail(f"a {view} frame synchronised the stream at {syncs}")
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    times = []
    for _ in range(FRAMES):
        t0 = time.perf_counter()
        out = eng.frame(image, image, calib)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {name: fn.launches for name, fn in counters.items()}
    want = {name: n * FRAMES for name, n in expect.items()}
    if launches != want:
        fail(f"{view} frames launched {launches} in {FRAMES} frames, "
             f"expected {want}")
    got = {k: tuple(v.shape) for k, v in out.items()
           if k != "compact_dropped"}
    if got != shapes:
        fail(f"{view} frame output shapes {got}")
    depth = out["depth"][out["valid"]] if depth_on_valid else out["depth"]
    finite = {"depth": depth,
              "render_norm": out["render_norm"],
              "render_tex": out["render_tex"]}
    for k, v in finite.items():
        if not torch.isfinite(v).all():
            fail(f"bf16 {view} frame: non-finite {k}")
    med = statistics.median(times)
    emit({"phase": "frame", "view": view, "dtype": "bf16", "frames": FRAMES,
          "frame_ms_median": med, "fps": 1e3 / med, "frame_ms": times,
          "launches": launches,
          "launches_per_frame": {k: v / FRAMES for k, v in launches.items()},
          "host_syncs_per_frame": len(syncs), "card": card})
    return out, med, launches


def golden_phase(eng32, out16, image, golden, limits16, view: str,
                 card: str):
    """The last bf16 frame and one f32 frame against a JAX golden."""
    import torch

    from monoport_tpu_torch import frame_check

    res16 = frame_check.compare_to_golden(out16, golden, limits16)
    emit({"phase": "golden", "view": view, "dtype": "bf16", **res16,
          "limits": limits16._asdict(), "card": card})
    t0 = time.perf_counter()
    out32 = eng32.frame(image, image, golden["calib"])
    torch.cuda.synchronize()
    ms32 = (time.perf_counter() - t0) * 1e3
    res = frame_check.compare_to_golden(out32, golden)
    emit({"phase": "golden", "view": view, "dtype": "f32", "frame_ms": ms32,
          **res, "limits": frame_check.F32_LIMITS._asdict(), "card": card})
    for dname, r in (("bf16", res16), ("f32", res)):
        if not r["ok"]:
            fail(f"{dname} {view} frame disagrees with the JAX golden: {r}")
    return out32


def frame_phases(netG, netC, counters: dict, card: str) -> dict:
    """The frontal and the rotated frame. -> launches by kernel, each
    from the run of the path that launches it."""
    import numpy as np
    import torch

    from monoport_tpu_torch import frame_check
    from monoport_tpu_torch.engine import ReconEngine

    golden = frame_check.load_golden()
    rotated = frame_check.load_golden(frame_check.GOLDEN_ROTATED)
    image = torch.from_numpy(golden["image"]).cuda()
    if not np.array_equal(rotated["calib"], frame_check.rotated_calib()):
        fail("the rotated golden was written for another pose")

    recon, cfg = frame_check.rtl_config(torch.bfloat16)
    eng = ReconEngine(netG, netC, recon=recon, config=cfg)
    recon, cfg = frame_check.rtl_config(torch.float32)
    eng32 = ReconEngine(netG, netC, recon=recon, config=cfg)
    if not find_syncs(lambda: torch.zeros(1, device="cuda").item()):
        fail("the sync detector misses a known sync")

    # frontal: 4 ray-MLP launches a frame and no other
    out, med, launches = timed_frames(
        eng, image, golden["calib"], counters,
        {"fused_ray_mlp": 4, "fused_mlp": 0, "fused_anchor_mlp": 0,
         "fused_gather_mlp": 0},
        "frontal", card)
    total = {"fused_ray_mlp": launches["fused_ray_mlp"]}
    profile_phase(eng, image, golden["calib"], card, med, "frontal")
    golden_phase(eng32, out, image, golden, frame_check.BF16_LIMITS,
                 "frontal", card)

    # rotated: the counts follow the pose's anchor plan
    calib = rotated["calib"]
    plan = eng._rot_anchor_plan(calib, image.shape[1])
    if [k or 0 for k in plan] != rotated["anchor_plan"].tolist():
        fail(f"anchor plan {plan} != the golden's {rotated['anchor_plan']}")
    expect = {"fused_ray_mlp": 0, "fused_gather_mlp": 0,
              "fused_mlp": 1 + sum(1 for k in plan if not k),
              "fused_anchor_mlp": sum(1 for k in plan if k)}
    out, med, launches = timed_frames(eng, image, calib, counters, expect,
                                      "rotated", card)
    total.update({k: launches[k] for k in ("fused_mlp", "fused_anchor_mlp")})
    dropped = out["compact_dropped"].tolist()
    emit({"phase": "rotated", "anchor_plan": [k or 0 for k in plan],
          "launches_per_frame_expected": expect, "compact_dropped": dropped,
          "compact_report": eng.compact_report(out)})

    # a smaller budget from the measured valid fraction: the same frame
    # where nothing dropped (the per-point colour head is a library GEMM,
    # whose sums may split otherwise at another batch: held to 1e-5)
    hint = eng.compact_hint_from_valid(float(out["valid"].float().mean()))
    hinted = eng.frame(image, image, calib, compact_hint=hint)
    torch.cuda.synchronize()
    dropped_h = hinted["compact_dropped"].tolist()
    same = {k: bool(torch.equal(hinted[k], out[k])) for k in FRAME_SHAPES}
    tex_diff = float((hinted["render_tex"] - out["render_tex"]).abs().max())
    emit({"phase": "compact_hint", "hint": hint, "compact_dropped": dropped_h,
          "bit_identical": same, "render_tex_max_diff": tex_diff})
    if not any(dropped) and not any(dropped_h):
        if not all(same[k] for k in ("depth", "valid", "render_norm")):
            fail(f"the hinted frame's geometry differs: {same}")
        if tex_diff > 1e-5:
            fail(f"the hinted frame's texture differs by {tex_diff}")
    profile_phase(eng, image, calib, card, med, "rotated")
    out32 = golden_phase(eng32, out, image, rotated,
                         frame_check.BF16_ROTATED_LIMITS, "rotated", card)
    dropped32 = out32["compact_dropped"].tolist()
    if dropped32 != rotated["compact_dropped"].tolist():
        fail(f"f32 rotated frame dropped {dropped32}, the golden "
             f"{rotated['compact_dropped'].tolist()}")
    return total


@contextlib.contextmanager
def plain_kernels():
    """Inside, the engine's MLPs take their plain versions on the card."""
    from monoport_tpu_torch import engine
    from monoport_tpu_torch.ops.cuda import fused_mlp as tmlp
    from monoport_tpu_torch.ops.cuda import fused_ray_mlp as tray

    kept = (engine.apply_ray, engine.apply_anchor, engine.apply_mlp)
    engine.apply_ray = tray.apply_ray_plain
    engine.apply_anchor = tray.apply_anchor_plain
    engine.apply_mlp = tmlp.apply_mlp_plain
    try:
        yield
    finally:
        engine.apply_ray, engine.apply_anchor, engine.apply_mlp = kept


def as_golden(out: dict) -> dict:
    """A frame's outputs as the numpy arrays ``compare_to_golden`` takes."""
    return {k: (v if k == "valid" else v.float()).cpu().numpy()
            for k, v in out.items()}


def dense_phases(netG, netC, counters: dict, card: str) -> dict:
    """The dense frame, its mesh, the hierarchy frame and a clip. ->
    launches by kernel over the dense and hierarchy runs."""
    import dataclasses

    import numpy as np
    import torch

    from monoport_tpu_torch import frame_check
    from monoport_tpu_torch.engine import ReconEngine, RotatedCfg
    from monoport_tpu_torch.recon.marching import extract_mesh

    golden = frame_check.load_golden(frame_check.GOLDEN_DENSE)
    image = torch.from_numpy(frame_check.load_golden()["image"]).cuda()
    eye = golden["calib"]
    res = frame_check.QUALITY_RESOLUTIONS[-1]
    levels = len(frame_check.QUALITY_RESOLUTIONS)

    # dense: the per-point MLP once a level, the ray MLP for the colour
    recon, cfg = frame_check.quality_config(torch.bfloat16)
    eng = ReconEngine(netG, netC, recon=recon, config=cfg)
    shapes = {"depth": (res, res), "valid": (res, res),
              "render_norm": (256, 256, 3), "render_tex": (256, 256, 3),
              "mask": (256, 256, 1), "sdf": (res, res, res),
              "recon_counts": (levels - 1,)}
    expect = {"fused_ray_mlp": 1, "fused_mlp": levels, "fused_anchor_mlp": 0,
              "fused_gather_mlp": 0}
    torch.cuda.reset_peak_memory_stats()
    out, med, launches = timed_frames(eng, image, eye, counters, expect,
                                      "dense", card, shapes,
                                      depth_on_valid=True)
    total = dict(launches)
    counts = out["recon_counts"].tolist()
    emit({"phase": "dense", "dtype": "bf16", "recon_counts": counts,
          "golden_recon_counts": golden["recon_counts"].tolist(),
          "budgets": list(recon.budgets[1:]),
          "band_report": eng.band_report(out),
          "peak_memory_mb": torch.cuda.max_memory_allocated() / 2 ** 20})
    if any(c > b for c, b in zip(counts, recon.budgets[1:])):
        fail(f"the dense frame overflowed its budgets: {counts}")
    profile_phase(eng, image, eye, card, med, "dense")
    res16 = frame_check.compare_to_golden(out, golden,
                                          frame_check.BF16_DENSE_LIMITS)
    emit({"phase": "golden", "view": "dense", "dtype": "bf16", **res16,
          "limits": frame_check.BF16_DENSE_LIMITS._asdict(), "card": card})
    recon32, cfg32 = frame_check.quality_config(torch.float32)
    eng32 = ReconEngine(netG, netC, recon=recon32, config=cfg32)
    t0 = time.perf_counter()
    out32 = eng32.frame(image, image, eye)
    torch.cuda.synchronize()
    ms32 = (time.perf_counter() - t0) * 1e3
    res32 = frame_check.compare_to_golden(out32, golden)
    sdf32 = frame_check.compare_sdf(out32, golden)
    counts32 = out32["recon_counts"].tolist()
    drift = max(abs(a - b) / max(b, 1) for a, b in
                zip(counts32, golden["recon_counts"].tolist()))
    emit({"phase": "golden", "view": "dense", "dtype": "f32",
          "frame_ms": ms32, **res32,
          **{k: v for k, v in sdf32.items() if k != "ok"},
          "sdf_ok": sdf32["ok"], "recon_counts": counts32,
          "golden_recon_counts": golden["recon_counts"].tolist(),
          "recon_counts_max_rel_diff": drift,
          "limits": frame_check.F32_LIMITS._asdict(), "card": card})
    if not res16["ok"]:
        fail(f"bf16 dense frame disagrees with the JAX golden: {res16}")
    if not (res32["ok"] and sdf32["ok"]):
        fail(f"f32 dense frame disagrees with the JAX golden: {res32} "
             f"{sdf32}")
    if drift > 2e-3:
        fail(f"f32 dense recon_counts {counts32} against the golden's "
             f"{golden['recon_counts'].tolist()}")

    # the same frames through the plain versions of the kernels on the card
    for dname, e, got, limits in (
            ("bf16", eng, out, frame_check.BF16_DENSE_LIMITS),
            ("f32", eng32, out32, frame_check.F32_LIMITS)):
        with plain_kernels():
            want = e.frame(image, image, eye)
        torch.cuda.synchronize()
        cmp = frame_check.compare_to_golden(got, as_golden(want), limits)
        sdf_diff = float((got["sdf"].float() - want["sdf"].float())
                         .abs().max())
        same_counts = got["recon_counts"].tolist() == \
            want["recon_counts"].tolist()
        emit({"phase": "dense_vs_plain", "dtype": dname, **cmp,
              "sdf_max_diff": sdf_diff, "recon_counts_equal": same_counts,
              "limits": limits._asdict(), "card": card})
        if not cmp["ok"]:
            fail(f"{dname} dense frame disagrees with its plain-kernel "
                 f"run: {cmp}")
        if dname == "f32" and not (same_counts and sdf_diff <= 2e-3):
            fail(f"f32 dense frame against its plain-kernel run: sdf differs "
                 f"by {sdf_diff}, recon_counts {got['recon_counts'].tolist()}"
                 f" / {want['recon_counts'].tolist()}")
        del want

    # mesh of the f32 volume: closed away from the volume's border
    t0 = time.perf_counter()
    verts, faces = extract_mesh(out32["sdf"], recon32.balance_value,
                                b_min=recon32.b_min, b_max=recon32.b_max)
    mesh_ms = (time.perf_counter() - t0) * 1e3
    edges = np.sort(np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                                    faces[:, [2, 0]]]), axis=1)
    uniq, n_shared = np.unique(edges, axis=0, return_counts=True)
    step = 2.0 / (res - 1)
    inner = (np.abs(verts) < 1.0 - 1.5 * step).all(axis=1)
    away = inner[uniq[:, 0]] & inner[uniq[:, 1]]
    closed = float((n_shared[away] == 2).mean()) if away.any() else 0.0
    emit({"phase": "mesh", "vertices": int(len(verts)),
          "faces": int(len(faces)), "edges": int(len(uniq)),
          "edges_away_from_border": int(away.sum()),
          "edges_shared_by_two_faces": closed, "extract_ms": mesh_ms})
    if len(faces) < 1000 or closed < 0.999:
        fail(f"the mesh is not closed: {len(faces)} faces, {closed} of the "
             "inner edges shared by two faces")

    # hierarchy: a rotated calib with the march off, against the plain
    # versions of the kernels on the card
    calib = frame_check.rotated_calib()
    off = RotatedCfg(march=False)
    engines = {}
    for dname, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        recon_h, cfg_h = frame_check.rtl_config(dtype)
        engines[dname] = ReconEngine(
            netG, netC, recon=recon_h,
            config=dataclasses.replace(cfg_h, rotated=off))
    eng_h = engines["bf16"]
    plan = eng_h._rot_anchor_plan(calib, image.shape[1])
    n_levels = len(eng_h.recon.resolutions)
    expect = {"fused_ray_mlp": 0, "fused_gather_mlp": 0,
              "fused_mlp": n_levels + sum(1 for k in plan if not k),
              "fused_anchor_mlp": sum(1 for k in plan if k)}
    rc = eng_h.recon.resolutions[-1]
    shapes = {**FRAME_SHAPES, "sdf": (rc, rc, rc),
              "recon_counts": (n_levels - 1,)}
    if tuple(plan) != (HIERARCHY_ANCHORS,):
        fail(f"the kernel phase measured the hierarchy frame's anchored MLP "
             f"at plan ({HIERARCHY_ANCHORS},), the pose gives {plan}")
    out_h, med_h, launches = timed_frames(eng_h, image, calib, counters,
                                          expect, "hierarchy", card, shapes,
                                          depth_on_valid=True)
    for k, v in launches.items():
        total[k] += v
    emit({"phase": "hierarchy", "anchor_plan": [k or 0 for k in plan],
          "launches_per_frame_expected": expect,
          "recon_counts": out_h["recon_counts"].tolist(),
          "budgets": list(eng_h.recon.budgets[1:]),
          "band_report": eng_h.band_report(out_h),
          "compact_dropped": out_h["compact_dropped"].tolist(),
          "compact_report": eng_h.compact_report(out_h)})
    for dname, limits in (("bf16", frame_check.BF16_ROTATED_LIMITS),
                          ("f32", frame_check.F32_LIMITS)):
        e = engines[dname]
        got = out_h if dname == "bf16" else e.frame(image, image, calib)
        with plain_kernels():
            want = e.frame(image, image, calib)
        torch.cuda.synchronize()
        cmp = frame_check.compare_to_golden(got, as_golden(want), limits)
        same = {k: got[k].tolist() == want[k].tolist()
                for k in ("recon_counts", "compact_dropped")}
        emit({"phase": "hierarchy_vs_plain", "dtype": dname, **cmp,
              "recon_counts_equal": same["recon_counts"],
              "compact_dropped_equal": same["compact_dropped"],
              "limits": limits._asdict(), "card": card})
        if not cmp["ok"]:
            fail(f"{dname} hierarchy frame disagrees with its plain-kernel "
                 f"run: {cmp}")
        if dname == "f32" and not all(same.values()):
            fail(f"f32 hierarchy frame against its plain-kernel run: "
                 f"recon_counts {got['recon_counts'].tolist()} / "
                 f"{want['recon_counts'].tolist()}, compact_dropped "
                 f"{got['compact_dropped'].tolist()} / "
                 f"{want['compact_dropped'].tolist()}")

    # a clip: two frontal frames and a rotated one, each its own path
    recon_r, cfg_r = frame_check.rtl_config(torch.bfloat16)
    eng_r = ReconEngine(netG, netC, recon=recon_r, config=cfg_r)
    flipped = torch.flip(image, dims=(2,))
    images = torch.cat([image, image, flipped])
    calibs = np.concatenate([eye, calib, eye])
    clip = eng_r.frames(images, images, calibs)
    torch.cuda.synchronize()
    syncs = find_syncs(lambda: eng_r.frames(images, images, calibs))
    if syncs:
        fail(f"frames() synchronised the stream at {syncs}")
    t0 = time.perf_counter()
    clip = eng_r.frames(images, images, calibs)
    torch.cuda.synchronize()
    clip_ms = (time.perf_counter() - t0) * 1e3
    diffs = {}
    for i in range(3):
        one = eng_r.frame(images[i:i + 1], images[i:i + 1], calibs[i:i + 1])
        for k in clip:
            d = float((clip[k][i].float() - one[k].float()).abs().max())
            diffs[k] = max(diffs.get(k, 0.0), d)
    emit({"phase": "frames", "dtype": "bf16", "clip": 3,
          "keys": sorted(clip), "clip_ms": clip_ms,
          "max_diff_vs_frame": diffs, "host_syncs": len(syncs)})
    if set(clip) != set(FRAME_SHAPES):
        fail(f"frames() keys {sorted(clip)}")
    if any(diffs[k] > 0 for k in ("depth", "valid", "render_norm", "mask")) \
            or diffs["render_tex"] > 1e-5:
        fail(f"frames() differs from frame(): {diffs}")
    return total


def gather_phase(counters: dict) -> int:
    """The gathering kernel's entry point. -> its launches there."""
    from monoport_tpu_torch import profile_gather

    for fn in counters.values():
        fn.launches = 0
    res = profile_gather.run()
    launches = {name: fn.launches for name, fn in counters.items()}
    emit({"phase": "gather_ab", **res, "launches": launches})
    if launches["fused_gather_mlp"] < 1 or launches["fused_ray_mlp"] < 1:
        fail(f"the gather A/B launched {launches}")
    return launches["fused_gather_mlp"]


KERNELS = [
    # name, source, the TPU kernel it replaces, its shapes on the main path
    ("fused_ray_mlp", "fused_ray_mlp.cu",
     "monoport_tpu/ops/pallas/fused_ray_mlp.py:109",
     ("march", "refine65", "refine257", "colour")),
    ("fused_mlp", "fused_mlp.cu",
     "monoport_tpu/ops/pallas/fused_mlp.py:78", ("march",)),
    ("fused_anchor_mlp", "fused_ray_mlp.cu",
     "monoport_tpu/ops/pallas/fused_ray_mlp.py:181",
     ("refine65", "refine257")),
    ("fused_gather_mlp", "fused_gather_mlp.cu",
     "monoport_tpu/ops/pallas/fused_gather_mlp.py:70",
     ("fine_192x6", "point_36k_t1")),
]


def kernels_line(rows: list, launches: dict) -> dict:
    """One entry a kernel: the bf16 launches of its frame summed (ms,
    plain_ms, bound_ms a frame), the largest error among them, and every
    measured shape under ``shapes``."""
    entries = []
    for name, source, replaces, on_path in KERNELS:
        mine = [r for r in rows if r["kernel"] == name]
        path = [r for r in mine if r["dtype"] == "bf16"
                and r["shape"] in on_path]
        if launches[name] < 1:
            fail(f"{name} was not launched on its frame's path")
        entries.append({
            "name": name, "route": "cuda",
            "source": os.path.join(CSRC, source), "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in path),
            "ms": sum(r["ms"] for r in path),
            "plain_ms": sum(r["plain_ms"] for r in path),
            "bound_ms": sum(r["bound_ms"] for r in path),
            "bound_by": "operations"
            if all(r["bound_by"] == "operations" for r in path) else "bytes",
            "library_ms": None,
            "shapes": {f"{r['shape']}/{r['dtype']}": {
                k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                  "max_abs_err")} for r in mine}})
    return {"kernels": entries}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    if not os.path.isdir(os.path.join(ROOT, CSRC)):
        fail("the repository checkout is not beside this script")
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    emit({"phase": "device", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})

    from monoport_tpu_torch.ops.cuda import build
    from monoport_tpu_torch.ops.cuda import fused_gather_mlp as tgather
    from monoport_tpu_torch.ops.cuda import fused_mlp as tmlp
    from monoport_tpu_torch.ops.cuda import fused_ray_mlp as tray
    from monoport_tpu_torch.weights import load_default_networks

    t0 = time.perf_counter()
    seconds: dict = {}
    libs = build.build_all(seconds)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": {os.path.join(CSRC, f"{name}.cu"): {
              "seconds": seconds[name],
              "library": os.path.relpath(path, ROOT)}
              for name, path in libs.items()}})

    netG, netC = load_default_networks()
    rows = kernel_phase(netG, netC, tray, tmlp, tgather)
    counters = {"fused_ray_mlp": tray.apply_ray, "fused_mlp": tmlp.apply_mlp,
                "fused_anchor_mlp": tray.apply_anchor,
                "fused_gather_mlp": tgather.apply_gather_ray}
    launches = frame_phases(netG, netC, counters, card)
    for name, n in dense_phases(netG, netC, counters, card).items():
        launches[name] = launches.get(name, 0) + n
    launches["fused_gather_mlp"] = gather_phase(counters)

    emit(kernels_line(rows, launches))
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

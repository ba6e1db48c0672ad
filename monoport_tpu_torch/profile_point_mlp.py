"""The per-point MLP kernel (kernel 2) and the ray MLP kernel (kernel 1) at
every shape the frames launch them on, bf16, and an A/B of two trees on one
card.

    python -m monoport_tpu_torch.profile_point_mlp
    python -m monoport_tpu_torch.profile_point_mlp --ab OTHER_ROOT
    python -m monoport_tpu_torch.profile_point_mlp --variants A.cu B.cu ...

OTHER_ROOT holds another tree's ``monoport_tpu_torch/`` (say the parent
commit, unpacked with ``git archive``). ``--ab`` measures the trees in turn,
OTHER, this, this, OTHER, each in its own process with its tree first on
``sys.path`` (each builds its own kernel), and prints one JSON line a run
and then the summary: per shape the two runs of each tree and this tree's
mean over OTHER's. The measurement uses only what every tree since the
kernels' ports has: ``pack_mlp_params`` + ``apply_mlp`` for kernel 2 and
``pack_ray_mlp_params`` + ``apply_ray`` for kernel 1 (the ``ray_`` shapes).

``--variants`` builds each given source, a variant of ``csrc/fused_mlp.cu``
with the same C entry points (a design tried against the kernel), and
times it beside this tree's kernel on this tree's packed bf16 operands at
``VARIANT_SHAPES``: the kernel (bf16 input, no wrapper), its ring alone
(``fused_mlp_wgmma_stream``) and its largest error against the plain
version.

Heads: netG (257, 1024, 512, 256, 128, 1, sigmoid) and netC (513, 1024,
512, 256, 128, 3, tanh) with weights and inputs from a numpy seed. Times
are CUDA events around ``REPS`` calls after a warm-up: ``ms`` as the host
issues the calls, ``device_ms`` with the calls queued behind a sleep of the
card, so that they run back to back (under ~0.1 ms a call the host's
enqueue rate, not the card, sets ``ms``); ``host_ms`` is the host's clock
a call while it queues them.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HEADS = {"netG": ((257, 1024, 512, 256, 128, 1), "sigmoid"),
         "netC": ((513, 1024, 512, 256, 128, 3), "tanh")}
# (name, head, points): chip_smoke's kernel-2 rows, from the rotated
# march, the per-point refine and colour, and the hierarchy levels
SHAPES = (("march", "netG", 33 ** 3), ("refine65_points", "netG", 2304 * 6),
          ("colour_points", "netC", 18432), ("level_4096", "netG", 4096),
          ("coarse_4913", "netG", 17 ** 3), ("level_16384", "netG", 16384),
          ("level_65536", "netG", 65536), ("level_131072", "netG", 131072),
          ("level_262144", "netG", 262144))
# (name, head, rays, taps): chip_smoke's kernel-1 rows, from the frontal
# frame's march, refines and colour query, and the dense frame's colour
RAY_SHAPES = (("ray_march", "netG", 33 * 33, 33),
              ("ray_refine65", "netG", 65 * 65, 6),
              ("ray_refine257", "netG", 192 * 192, 6),
              ("ray_colour", "netC", 192 * 192, 1),
              ("ray_colour_dense", "netC", 257 * 257, 1))
REPS = 20
# ~25 ms of the card's clock: longer than the host takes to enqueue REPS
# calls of any shape here
SLEEP_CYCLES = 50_000_000
VARIANT_SHAPES = (("netG", 262144), ("netC", 18432))


def _packs(pack) -> dict:
    """Both heads, seeded, packed by ``pack`` in bf16 on the card."""
    import numpy as np
    import torch

    from monoport_tpu_torch.models.heads.surface_classifier import \
        SurfaceClassifier

    if not torch.cuda.is_available():
        raise SystemExit("profile_point_mlp times the card: it needs CUDA")
    packs = {}
    for name, (chans, last_op) in HEADS.items():
        rng = np.random.RandomState(0)
        head = SurfaceClassifier(chans, last_op=last_op)
        with torch.no_grad():
            for lin in head.layers():
                o, i = lin.weight.shape
                lin.weight.copy_(torch.from_numpy(
                    (rng.randn(o, i) / np.sqrt(i)).astype(np.float32)))
                lin.bias.copy_(torch.from_numpy(
                    (rng.randn(o) * 0.1).astype(np.float32)))
        packs[name] = pack(head, torch.bfloat16, "cuda")
    return packs


def _ms(fn, queued: bool = False) -> tuple[float, float]:
    """(ms a call on the card, ms a call on the host's clock while issuing
    it) over REPS calls after a warm-up. ``queued``: the card first sleeps
    (``torch.cuda._sleep``) while the host enqueues every call, so the calls
    run back to back and the first time is the device's, not the host's
    enqueue rate (which sets it, unqueued, for calls under ~0.1 ms)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    host = (time.perf_counter() - t0) * 1e3 / REPS
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS, host


def measure(root: str) -> dict:
    """ms a call of the tree at ``root`` at every shape."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from monoport_tpu_torch.ops.cuda import fused_mlp, fused_ray_mlp

    packs = _packs(fused_mlp.pack_mlp_params)
    out = {"root": os.path.abspath(root), "ms": {}, "device_ms": {},
           "host_ms": {}}

    def timed(label, fn):
        out["ms"][label] = _ms(fn)[0]
        out["device_ms"][label], out["host_ms"][label] = _ms(fn, queued=True)

    for i, (label, name, points) in enumerate(SHAPES):
        rng = np.random.RandomState(100 + i)
        x = torch.from_numpy(rng.randn(1, points, HEADS[name][0][0]).astype(
            np.float32)).cuda()
        timed(label, lambda: fused_mlp.apply_mlp(packs[name], x))
    packs = _packs(fused_ray_mlp.pack_ray_mlp_params)
    for i, (label, name, rays, taps) in enumerate(RAY_SHAPES):
        rng = np.random.RandomState(200 + i)
        feat = torch.from_numpy(rng.randn(
            1, rays, HEADS[name][0][0] - 1).astype(np.float32)).cuda()
        z = torch.from_numpy(rng.uniform(-1.3, 1.3, (1, rays, taps)).astype(
            np.float32)).cuda()
        timed(label, lambda: fused_ray_mlp.apply_ray(packs[name], feat, z))
    return out


def variants(sources: list[str]) -> dict:
    """This tree's kernel and each variant source at VARIANT_SHAPES."""
    import ctypes
    import tempfile

    import torch

    this = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, this)
    from monoport_tpu_torch.ops.cuda import build, fused_mlp
    from monoport_tpu_torch.ops.cuda.fused_ray_mlp import LAST_OPS

    packs = _packs(fused_mlp.pack_mlp_params)
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=build.BUILD_DIR)
    built = {src: os.path.join(tmp, f"variant{i}.so")
             for i, src in enumerate(sources)}
    procs = {src: subprocess.Popen(build.nvcc_command(src, lib),
                                   stderr=subprocess.DEVNULL)
             for src, lib in built.items()}
    libs = {"tree": build.library(fused_mlp.LIBRARY)}
    for src, proc in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed on {src}")
        libs[src] = ctypes.CDLL(built[src])
    out = {}
    for name, points in VARIANT_SHAPES:
        p = packs[name]
        x = torch.randn(1, points, p.c_f, device="cuda")
        xr = fused_mlp.pad_feat(p, x).reshape(points, -1).contiguous()
        want = fused_mlp.apply_mlp_plain(p, x)[0]
        res = torch.empty(points, p.out_dim, device="cuda")
        widths = (ctypes.c_int * len(p.tile_widths))(*p.tile_widths)
        args = (xr.data_ptr(), res.data_ptr(), p.tiles.data_ptr(),
                p.tile_bias.data_ptr(), widths, len(p.tile_widths),
                p.widths[0], p.out_dim, LAST_OPS[p.last_op], points,
                torch.cuda.current_stream().cuda_stream)
        for src, lib in libs.items():
            row = {}
            for entry, key in (("fused_mlp_wgmma_forward", "ms"),
                               ("fused_mlp_wgmma_stream", "stream_ms")):
                fn = getattr(lib, entry)
                fn.argtypes = [ctypes.c_void_p] * 4 + [
                    ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 5 + [
                    ctypes.c_void_p]
                fn.restype = ctypes.c_int
                if fn(*args) != 0:
                    raise RuntimeError(f"{src} {entry} refused")
                if key == "ms":
                    torch.cuda.synchronize()
                    row["max_err"] = float((res - want).abs().max())
                row[key] = _ms(lambda: fn(*args))[0]
            out.setdefault(src, {})[f"{name}_{points}"] = row
    return {"phase": "point_mlp_variants", "variants": out,
            "card": card_line()}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def ab(other: str) -> dict:
    """OTHER, this, this, OTHER, one process each -> the summary."""
    this = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    runs = []
    for root in (other, this, this, other):
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--measure", root],
            check=True, capture_output=True, text=True, timeout=900)
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    summary = {}
    rows = [(label, points) for label, _, points in SHAPES] + [
        (label, rays * taps) for label, _, rays, taps in RAY_SHAPES]
    for label, n in rows:
        summary[label] = {"rows": n}
        for key in ("ms", "device_ms", "host_ms"):
            old = [runs[0][key][label], runs[3][key][label]]
            new = [runs[1][key][label], runs[2][key][label]]
            summary[label].update({f"other_{key}": old, f"this_{key}": new,
                                   f"this_over_other_{key}":
                                   sum(new) / sum(old)})
    return {"phase": "point_mlp_ab", "other": os.path.abspath(other),
            "shapes": summary, "card": card_line()}


def main(argv: list[str]) -> int:
    if argv[:1] == ["--measure"]:
        print(json.dumps(measure(argv[1])))
    elif argv[:1] == ["--ab"]:
        print(json.dumps(ab(argv[1])))
    elif argv[:1] == ["--variants"]:
        print(json.dumps(variants(argv[1:])))
    else:
        this = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        print(json.dumps({**measure(this), "card": card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""One run of one cell of the port's benchmark on the card.

    python3 cardbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration, its traffic mix, its comparison limits and
its per-layer metrics' readers are found by the names in ``BENCHMARK.json``
(``harness/manifest.py``). A run: pin the process-wide settings, build the
port's kernels (only a checkout's first run compiles), load or draw the
weights, render the traffic on the device, warm up every shape the window
runs, then drive ``ReconEngine.frame`` in a closed loop for ``--seconds``
(``harness/cell.py``), or, where the traffic file names a ``driver``, the
cell of ``harness/<driver>.py`` (``serve``: the served demo). With
``--trace 0`` the result's metrics are the cell's end-to-end metrics;
with ``--trace 1`` the window is followed by a profiled stretch of
``PROFILE_FRAMES`` frames and the metrics are the cell's per-layer ones.
After the window and the reading of the peak memory, the engine is
freed and a sample of the window's frames is held to the plain reference
(``reference/``), each number beside its limit.

Earlier lines of standard output are JSON objects with an ``info`` key
(the card, versions, pinned settings, set-up times, the traced stretch's
rate); the last is the result. The numbers compared close standard error.
Exits 2, printing no result, without a CUDA card, and 3 when a module of
JAX or of the JAX package is loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(
        os.path.abspath(__file__)):
    sys.path[0] = ROOT
os.environ.setdefault("CUDA_CACHE_PATH",
                      os.path.join(ROOT, ".cache", "cardbench", "nv"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cardbench.harness import card, compare  # noqa: E402
from cardbench.harness.cell import Cell  # noqa: E402
from cardbench.harness.manifest import Manifest  # noqa: E402

PROFILE_FRAMES = 20


@dataclasses.dataclass
class Context:
    """What a per-layer reader reads (``metrics/<name>.py``: ``read``)."""
    cell: Cell                 # or the cell class its traffic names
    window: object             # its Window: the unprofiled stretch
    trace: object              # trace.Trace: the profiled stretch


def info(kind: str, **fields) -> None:
    print(json.dumps({"info": kind, **fields}, default=str), flush=True)


def end_to_end(win, setup_s: float) -> dict:
    times = np.asarray(win.times)
    return {"fps": win.frames / win.elapsed,
            "frame_ms_p95": float(np.percentile(times, 95)) * 1e3,
            "setup_s": setup_s}


def driver(spec: dict):
    """The cell class of a traffic mix: ``Cell``, or the ``CELL`` of
    ``harness/<driver>.py`` where the mix names a ``driver``."""
    if "driver" not in spec:
        return Cell
    return importlib.import_module(
        f"cardbench.harness.{spec['driver']}").CELL


def run(manifest: Manifest, workload: str, seed: int, seconds: float,
        traced: bool, device="cuda", t_start: float = T_START):
    """-> (result dict, the numbers compared)."""
    cell = driver(manifest.traffic(manifest.workload(workload)["traffic"]))(
        manifest, workload, seed, device)
    info("settings", pinned=card.pin(), **card.versions())
    cell.setup()
    cell.warm_up()
    cell.prepare_sample(seconds)
    info("setup", **cell.timings)
    setup_s = time.perf_counter() - t_start
    win = cell.window(seconds)
    info("window", frames=win.frames, seconds=win.elapsed, **win.host)
    dev = (card.device(cell.entry["chips"]) if cell.device.type == "cuda"
           else {"platform": "cpu", "kind": "cpu", "count": 1,
                 "memory_peak_bytes": 0})
    units = {m["name"]: m["unit"] for m in manifest.end_to_end(workload)}
    e2e = end_to_end(win, setup_s)
    result = {"correct": False, "attempted": win.frames, "failed": 0}
    if traced:
        tr, rate = cell.profile(win, PROFILE_FRAMES)
        info("trace", unprofiled_fps=e2e["fps"], profiled_fps=rate,
             profiled_frames=tr.frames)
        ctx = Context(cell, win, tr)
        metrics = {}
        for m in manifest.per_layer(workload):
            value = manifest.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.top_gaps()}
    else:
        metrics = {k: {"value": e2e[k], "unit": u} for k, u in units.items()}
    cell.free_program()
    frames = cell.checked(win)
    per_frame = cell.compare(win, frames, cell.reference())
    numbers = compare.pooled(per_frame)
    correct, checks = compare.judge(numbers, cell.limits["limits"])
    info("checked", frames=frames, shares=numbers, per_frame=per_frame)
    result.update(correct=correct, metrics=metrics, device=dev)
    if traced:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    manifest = Manifest()
    chips = manifest.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"cardbench: needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    info("card", **card.smi())
    result, checks = run(manifest, args.workload, args.seed, args.seconds,
                         bool(args.trace))
    info("card_after", **card.smi())
    found = card.forbidden_modules()
    if found:
        print(f"cardbench: JAX modules loaded: {found}", file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

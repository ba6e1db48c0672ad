"""The readings the comparison's limits are set from, on the card: for
each seed, one cell's run up to its check (set-up, warm-up, a window of
``--seconds``), then its checked frames read four ways against the plain
f32 reference of the same inputs:

* ``program``: the window's frames (the configuration's compute dtype):
  the lower reading;
* ``control``: the reference with every convolution and linear layer on
  float8 e4m3 (``reference.frame.quantize_fp8``), one precision step below
  the configuration's bf16: the upper reading;
* ``program_f32``: the port's engine in f32 on the same inputs, a second
  witness of the reference (read at tolerances of 1e-3);
* ``stale`` (each checked frame answered with the one checked before it)
  and ``shifted`` (the depth moved by two fine voxels where it is
  produced): planted faults.

    python3 cardbench/calibrate.py --workload <name> --seeds 1,2,3 \
        --seconds 8

One JSON line a seed, then the summary: the largest ``program`` and
``program_f32`` shares and the smallest ``control`` and fault shares.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from cardbench.harness import card, compare, program  # noqa: E402
from cardbench.harness.cell import Cell  # noqa: E402
from cardbench.harness.manifest import Manifest  # noqa: E402

KINDS = ("program", "control", "program_f32", "stale", "shifted")


def readings(manifest, workload: str, seed: int, seconds: float,
             device="cuda") -> dict:
    cell = Cell(manifest, workload, seed, device)
    cell.setup()
    cell.warm_up()
    cell.prepare_sample(seconds)
    win = cell.window(seconds)
    cell.free_program()
    config32 = copy.deepcopy(cell.config)
    config32["profile"]["compute_dtype"] = "float32"
    eng32, _ = program.build_engine(config32, cell.states, cell.device)
    ref, ctrl = cell.reference(), cell.reference(control=True)
    frames = cell.checked(win)
    counts = {k: [] for k in KINDS}
    t0 = time.perf_counter()
    prev, hints = None, []
    with torch.inference_mode():
        for i in frames:
            inputs = cell.reference_inputs(win, i, ref)
            want = ref(*inputs)
            got = cell.output(win, i)
            tols = cell.limits["tolerances"]
            counts["program"].append(compare.frame_counts(got, want, tols))
            counts["control"].append(compare.frame_counts(ctrl(*inputs), want,
                                                          tols))
            img, img_c, calib, hint = inputs
            counts["program_f32"].append(compare.frame_counts(
                eng32.frame(img, img_c, calib, compact_hint=hint), want,
                dict(tols, depth=1e-3, norm=1e-3, tex=1e-3)))
            shifted = dict(got, depth=got["depth"] + 2.0)
            counts["shifted"].append(compare.frame_counts(shifted, want,
                                                          tols))
            if prev is not None:
                counts["stale"].append(compare.frame_counts(prev, want, tols))
            prev = {k: v.clone() for k, v in got.items()}
            hints.append([win.meta[i][2], inputs[3]])
    cell._sync()
    return {"seed": seed, "frames": len(frames), "window_frames": win.frames,
            "fps": win.frames / win.elapsed,
            "check_s": time.perf_counter() - t0, "hints": hints,
            **{k: compare.pooled(v) for k, v in counts.items()},
            **{f"{k}_p995": [{n: v for n, v in f.items() if "p995" in n}
                             for f in counts[k]]
               for k in ("program", "program_f32")}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    card.pin()
    manifest = Manifest()
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        rows.append(readings(manifest, args.workload, seed, args.seconds))
        print(json.dumps(rows[-1]), flush=True)
    summary = {"workload": args.workload, "seeds": len(rows), "card": card.smi()}
    for kind, pick in (("program", max), ("program_f32", max),
                       ("control", min), ("stale", min), ("shifted", min)):
        summary[kind] = {k: pick(r[kind][k] for r in rows)
                         for k in rows[0][kind]}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

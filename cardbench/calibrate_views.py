"""The readings the limits of a ``views`` cell (PIFu's multi-view netG,
``harness/views.py``) are set from, on the card: for each seed, the cell's
run up to its check (set-up, warm-up, a window of ``--seconds``), then its
checked frames read against the plain f32 reference of the same inputs
(``reference/frames/dense_views.py``):

* ``program``: the window's frames: the lower reading;
* ``control``: the reference on TF32 operands, one precision step below
  the configuration's float32 (``reference.frame.control_nets``): the
  upper reading;
* ``stale`` (each checked frame answered with the one checked before it),
  ``shifted`` (the depth moved by two fine voxels where it is produced)
  and ``empty`` (no silhouette at all): planted faults.

The port's engine has no bf16 form of this net, so there is no
``program_bf16`` witness as ``calibrate.py`` reads for the single-view
cells.

    python3 cardbench/calibrate_views.py --workload hg4-mv4-dense \
        --seeds 1,2,3 --seconds 8

One JSON line a seed, then the summary: the largest ``program`` share and
the smallest control and fault shares, at the limits file's tolerances.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from cardbench.harness import card, compare  # noqa: E402
from cardbench.harness.manifest import Manifest  # noqa: E402
from cardbench.harness.views import ViewsCell  # noqa: E402

KINDS = ("program", "control", "stale", "shifted", "empty")


def readings(manifest, workload: str, seed: int, seconds: float,
             device="cuda") -> dict:
    cell = ViewsCell(manifest, workload, seed, device)
    cell.setup()
    cell.warm_up()
    cell.prepare_sample(seconds)
    win = cell.window(seconds)
    cell.free_program()
    ref, ctrl = cell.reference(), cell.reference(control=True)
    frames = cell.checked(win)
    counts = {k: [] for k in KINDS}
    tols = cell.limits["tolerances"]

    def read(kind, got, want):
        counts[kind].append(compare.frame_counts(got, want, tols, cell.level))

    t0 = time.perf_counter()
    prev = None
    with torch.inference_mode():
        for i in frames:
            inputs = cell.reference_inputs(win, i, ref)
            want = ref(*inputs)
            got = cell.output(win, i)
            read("program", got, want)
            read("control", ctrl(*inputs), want)
            read("shifted", dict(got, depth=got["depth"] + 2.0), want)
            read("empty", dict(got, valid=torch.zeros_like(got["valid"])),
                 want)
            if prev is not None:
                read("stale", prev, want)
            prev = {k: v.clone() for k, v in got.items()}
    cell._sync()
    return {"seed": seed, "frames": len(frames), "window_frames": win.frames,
            "fps": win.frames / win.elapsed, "tolerances": tols,
            "check_s": time.perf_counter() - t0,
            **{k: compare.pooled(v) for k, v in counts.items()},
            **{f"{k}_errors": [{n: v for n, v in f.items()
                                if n.endswith(("_p995", "_flip"))}
                               for f in counts[k]]
               for k in ("program", "control")}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate_views: needs a CUDA card", file=sys.stderr)
        return 2
    card.pin()
    manifest = Manifest()
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        rows.append(readings(manifest, args.workload, seed, args.seconds))
        print(json.dumps(rows[-1]), flush=True)
    summary = {"workload": args.workload, "seeds": len(rows),
               "card": card.smi()}
    for kind in KINDS:
        pick = max if kind == "program" else min
        summary[kind] = {k: pick(r[kind][k] for r in rows)
                         for k in rows[0][kind]}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

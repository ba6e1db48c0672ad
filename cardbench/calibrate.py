"""The readings the comparison's limits are set from, on the card: for
each seed, one cell's run up to its check (set-up, warm-up, a window of
``--seconds``), then its checked frames read several ways against the
plain f32 reference of the same inputs:

* ``program``: the window's frames (the configuration's compute dtype):
  the lower reading;
* ``control``: the reference one precision step below the configuration
  (``reference.frame.control_nets``): every convolution and linear layer
  on float8 e4m3 under a bf16 configuration, on TF32 under a float32 one:
  the upper reading;
* under bf16, ``program_f32``: the port's engine in f32 on the same
  inputs, a second witness of the reference (read at tolerances of 1e-3);
* under float32, ``program_bf16``: the port's engine in bf16 on the same
  inputs, and ``control_fp8``: the reference on float8 e4m3; two more
  upper readings;
* ``stale`` (each checked frame answered with the one checked before it),
  ``shifted`` (the depth moved by two fine voxels where it is produced)
  and ``empty`` (no silhouette at all): planted faults.

A cell whose traffic names the ``serve`` driver reads its served frames
instead (``serve_readings``): the program, the control, the floor's
witness and the faults, every share of ``serve.served_counts``.

    python3 cardbench/calibrate.py --workload <name> --seeds 1,2,3 \
        --seconds 8

The sample keeps enough window frames for the limits file's ``frames``
at any ``--seconds`` (``cell.keep_block``). One JSON line a seed, then
the summary: the largest ``program`` and witness shares and the smallest
control and fault shares, at the limits file's tolerances.
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
from cardbench.harness.manifest import ROOT, Manifest  # noqa: E402
from cardbench.reference.frame import (load_nets, quantize_fp8,  # noqa: E402
                                       reference_frame)

# the port's engine at the other dtype, by the configuration's
WITNESS = {"bfloat16": ("float32", "program_f32"),
           "float32": ("bfloat16", "program_bf16")}


def readings(manifest, workload: str, seed: int, seconds: float,
             device="cuda") -> dict:
    cell = Cell(manifest, workload, seed, device)
    cell.setup()
    cell.warm_up()
    cell.prepare_sample(seconds)
    win = cell.window(seconds)
    cell.free_program()
    dtype, witness = WITNESS[cell.config["profile"]["compute_dtype"]]
    config_w = copy.deepcopy(cell.config)
    config_w["profile"]["compute_dtype"] = dtype
    eng_w, _ = program.build_engine(config_w, cell.states, cell.device)
    ref, ctrl = cell.reference(), cell.reference(control=True)
    others = {}
    if dtype == "bfloat16":
        others["control_fp8"] = reference_frame(cell.config, quantize_fp8(
            load_nets(cell.config, cell.states, cell.device)))
    frames = cell.checked(win)
    kinds = ("program", "control", witness, *others, "stale", "shifted",
             "empty")
    counts = {k: [] for k in kinds}
    tols = cell.limits["tolerances"]
    # an f32 witness is read at 1e-3; a bf16 one at the cell's tolerances,
    # as the control is
    tols_w = (dict(tols, depth=1e-3, norm=1e-3, tex=1e-3)
              if dtype == "float32" else tols)

    def read(kind, got, want, t=tols):
        counts[kind].append(compare.frame_counts(got, want, t, cell.level))

    t0 = time.perf_counter()
    prev, hints = None, []
    with torch.inference_mode():
        for i in frames:
            inputs = cell.reference_inputs(win, i, ref)
            want = ref(*inputs)
            got = cell.output(win, i)
            read("program", got, want)
            read("control", ctrl(*inputs), want)
            for k, other in others.items():
                read(k, other(*inputs), want)
            img, img_c, calib, hint = inputs
            read(witness, eng_w.frame(img, img_c, calib, compact_hint=hint),
                 want, tols_w)
            read("shifted", dict(got, depth=got["depth"] + 2.0), want)
            read("empty", dict(got, valid=torch.zeros_like(got["valid"])),
                 want)
            if prev is not None:
                read("stale", prev, want)
            prev = {k: v.clone() for k, v in got.items()}
            hints.append([win.meta[i][2], inputs[3]])
    cell._sync()
    return {"seed": seed, "frames": len(frames), "window_frames": win.frames,
            "fps": win.frames / win.elapsed, "tolerances": tols,
            "check_s": time.perf_counter() - t0, "hints": hints,
            **{k: compare.pooled(v) for k, v in counts.items()},
            **{f"{k}_errors": [{n: v for n, v in f.items()
                                if n.endswith(("_p995", "_flip"))}
                               for f in counts[k]]
               for k in kinds if k not in ("stale", "empty")}}


def serve_readings(manifest, workload: str, seed: int, seconds: float,
                   device="cuda") -> dict:
    """A served cell's readings: the program, the control (the reference
    on the configuration's control nets, its segmenters on TF32), the
    floor's witness (the program's served canvas with its floor drawn by
    the program's own rasterizer from the uvs that its own OBJ reader
    returns) and the faults (stale, shifted, empty; the served canvas's
    JPEG coded at quality 75 and 50)."""
    from cardbench.harness.serve import ServeCell, matte_iou, served_counts
    from cardbench.reference.frame import _tf32
    from cardbench.reference.segmentation import segmenter
    from cardbench.reference.served import camera
    from monoport_tpu_torch.pipeline.jpeg import encode_jpeg

    cell = ServeCell(manifest, workload, seed, device)
    cell.setup()
    cell.warm_up()
    cell.prepare_sample(seconds)
    win = cell.window(seconds)
    cell.free_program()
    ref = cell.reference()
    ctrl = cell.reference(control=True, segment=segmenter(
        cell.config["serve"], ROOT, cell.device, _tf32))
    floor = program.served_floor_witness(cell.config, cell.device)
    frames = cell.checked(win)
    kinds = ("program", "control", "witness", "stale", "shifted", "empty",
             "jpeg_q75", "jpeg_q50")
    counts = {k: [] for k in kinds}
    tols = cell.limits["tolerances"]
    bodies = len(cell.frames)

    def read(kind, got, want):
        c = served_counts(got, want, tols, cell.level)
        if kind in ("control", "witness"):
            c.pop("jpeg_bad")        # no JPEG of its own canvas
        counts[kind].append(c)

    t0 = time.perf_counter()
    prev, ious = None, []
    with torch.inference_mode():
        for j in frames:
            got = cell.output(win, j)
            n = got["n"]
            want = cell.reference_answer(ref, n, got["hint_of"])
            read("program", got, want)
            ious.append(matte_iou(got["alpha"], cell.silhouettes[n % bodies]))
            c = cell.reference_answer(ctrl, n, got["hint_of"])
            read("control", dict(c, jpeg=got["jpeg"]), want)
            subject = ~(got["render_tex"].float() >= 1.0).all(dim=-1)
            bg = torch.floor(floor(*camera(cell.config["serve"], n)) * 255.0)
            read("witness", dict(got, served=torch.where(
                subject[..., None], got["served"], bg.to(torch.uint8))), want)
            read("shifted", dict(got, depth=got["depth"] + 2.0), want)
            read("empty", dict(got, valid=torch.zeros_like(got["valid"])),
                 want)
            canvas = got["served"].cpu().numpy()
            for q in (75, 50):
                read(f"jpeg_q{q}", dict(got, jpeg=encode_jpeg(canvas, q)),
                     want)
            if prev is not None:
                read("stale", dict(prev, jpeg=got["jpeg"],
                                   served=prev["served"]), want)
            prev = got
    cell._sync()
    return {"seed": seed, "frames": len(frames), "window_frames": win.frames,
            "fps": win.frames / win.elapsed, "tolerances": tols,
            "check_s": time.perf_counter() - t0,
            "matte_iou": ious,
            **{k: compare.pooled(v) for k, v in counts.items()},
            **{f"{k}_errors": [{n: v for n, v in f.items()
                                if n.endswith("_p995")} for f in counts[k]]
               for k in ("program", "control")}}


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
    spec = manifest.traffic(manifest.workload(args.workload)["traffic"])
    read = serve_readings if spec.get("driver") == "serve" else readings
    for seed in (int(s) for s in args.seeds.split(",")):
        rows.append(read(manifest, args.workload, seed, args.seconds))
        print(json.dumps(rows[-1]), flush=True)
    summary = {"workload": args.workload, "seeds": len(rows), "card": card.smi()}
    for kind in ("program", "program_f32", "control", "program_bf16",
                 "control_fp8", "witness", "stale", "shifted", "empty",
                 "jpeg_q75", "jpeg_q50"):
        if kind in rows[0]:
            pick = max if kind in ("program", "program_f32",
                                   "witness") else min
            summary[kind] = {k: pick(r[kind][k] for r in rows)
                             for k in rows[0][kind]}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

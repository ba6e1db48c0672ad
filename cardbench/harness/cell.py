"""One cell of the benchmark: its configuration under its traffic mix,
driven as the live demo drives the engine.

Closed loop, batch 1, one frame in flight: each frame is timed on the
host clock from the call to ``ReconEngine.frame`` to the
``synchronize`` after it, and the next is issued at once. A sample of
the window's frames (one a block of ``KEEP_BLOCK``, at an offset drawn
from the seed) is copied into pinned host buffers allocated before the
window, so the sample takes no device memory; after it, the limits
file's ``frames`` of them, drawn from the seed, are held to the
reference.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import time

import numpy as np
import torch

from ..reference.frame import ReferenceFrame, load_nets, quantize_fp8
from . import compare, host, program, traffic, weights
from . import trace as tracing

KEEP_BLOCK = 32
MAX_FPS = 120                      # sizes the sample's buffers
OUTPUTS = ("depth", "valid", "render_norm", "render_tex")


@dataclasses.dataclass
class Window:
    times: list                    # seconds a frame
    elapsed: float                 # the window's seconds, first call to last sync
    meta: list                     # (body, pose, hint) a frame
    kept: dict                     # frame -> slot
    next_hint: object
    host: dict                     # what the host did (host.Watch)

    @property
    def frames(self) -> int:
        return len(self.times)


class Cell:
    def __init__(self, manifest, workload: str, seed: int, device):
        self.entry = manifest.workload(workload)
        self.config = manifest.config(self.entry["config"])
        self.spec = manifest.traffic(self.entry["traffic"])
        self.limits = manifest.limits(workload)
        self.seed = int(seed)
        self.device = torch.device(device)
        self.engine = None
        self.timings: dict = {}

    # -- set-up ---------------------------------------------------------
    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup(self) -> dict:
        t = time.perf_counter()
        if self.device.type == "cuda":
            self.timings["nvcc_s"] = program.build_kernels()
            self.timings["kernels_s"] = time.perf_counter() - t
            t = time.perf_counter()
        self.traffic = traffic.generate(self.spec, self.seed,
                                        self.config["image_size"], self.device)
        self.images_c = self.traffic.images if "netC" in self.config else None
        self._sync()
        self.timings["traffic_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.states = weights.states(self.config, self.seed, self.device,
                                     self.traffic.images)
        self._sync()
        self.timings["weights_s"] = time.perf_counter() - t
        if self.device.type == "cuda":      # the peak is the program's
            torch.cuda.reset_peak_memory_stats(self.device)
        self.engine, self.timings["engine_s"] = program.build_engine(
            self.config, self.states, self.device)
        return self.timings

    def frame(self, i: int, hint):
        b, c = self.traffic.frame(i)
        img = self.traffic.images[b:b + 1]
        return self.engine.frame(
            img, None if self.images_c is None else img,
            self.traffic.calibs[c], compact_hint=hint)

    def hint_after(self, out):
        if self.traffic.hint != "previous_valid":
            return None
        return self.engine.compact_hint_from_valid(
            float(out["valid"].float().mean()))

    def warm_up(self) -> int:
        """Every shape the window runs: the frontal frames a few times
        over the bodies; the orbit's every pose once, with its hints."""
        t = time.perf_counter()
        cam = self.spec["camera"]
        n = max(len(self.traffic.images), cam.get("poses", 0)) + 2
        hint = None
        with torch.inference_mode():
            for i in range(n):
                out = self.frame(i, hint)
                self._sync()
                hint = self.hint_after(out)
        self.out_shapes = {k: (v.shape, v.dtype) for k, v in out.items()
                           if k in OUTPUTS}
        self.timings["warm_up_s"] = time.perf_counter() - t
        self.timings["warm_up_frames"] = n
        return n

    def prepare_sample(self, seconds: float):
        """The frames to keep and the buffers they go to."""
        rng = np.random.default_rng([self.seed, 1])
        blocks = math.ceil(seconds * MAX_FPS / KEEP_BLOCK) + 1
        self.keep = {j * KEEP_BLOCK + int(r): j for j, r in
                     enumerate(rng.integers(KEEP_BLOCK, size=blocks))}
        pin = self.device.type == "cuda"
        self.slots = [{k: torch.empty(s, dtype=d, pin_memory=pin)
                       for k, (s, d) in self.out_shapes.items()}
                      for _ in range(blocks)]
        self.check_rng = rng
        gc.collect()
        gc.freeze()          # the set-up's objects leave the collector's scans

    # -- the window ---------------------------------------------------------
    def window(self, seconds: float) -> Window:
        times, meta, kept = [], [], {}
        hint = None
        i = 0
        with torch.inference_mode(), host.Watch() as watch:
            start = time.perf_counter()
            while time.perf_counter() - start < seconds:
                t0 = time.perf_counter()
                out = self.frame(i, hint)
                self._sync()
                times.append(time.perf_counter() - t0)
                meta.append((*self.traffic.frame(i), hint))
                if i in self.keep:
                    slot = self.slots[self.keep[i]]
                    for k in slot:
                        slot[k].copy_(out[k], non_blocking=True)
                    kept[i] = self.keep[i]
                hint = self.hint_after(out)
                i += 1
            self._sync()
            elapsed = time.perf_counter() - start
        return Window(times, elapsed, meta, kept, hint,
                      dict(watch.record, fps_by_chunk=host.chunk_rates(times)))

    def profile(self, win: Window, frames: int):
        """(Trace, frames a second) of ``frames`` more frames under the
        profiler, each annotated, continuing the window's order."""
        from torch.profiler import ProfilerActivity, profile, record_function

        hint = win.next_hint
        with torch.inference_mode(), profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(win.frames, win.frames + frames):
                with record_function(tracing.FRAME):
                    out = self.frame(i, hint)
                    self._sync()
                with record_function("cardbench.host"):
                    hint = self.hint_after(out)
            rate = frames / (time.perf_counter() - t0)
        return tracing.reduce(prof, frames), rate

    def free_program(self):
        self.engine = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- correctness ---------------------------------------------------------
    def checked(self, win: Window) -> list:
        """The kept frames held to the reference, drawn from the seed."""
        kept = sorted(win.kept)
        n = min(self.limits["frames"], len(kept))
        return sorted(self.check_rng.choice(kept, size=n, replace=False)
                      .tolist()) if n else []

    def reference(self, control: bool = False) -> ReferenceFrame:
        nets = load_nets(self.config, self.states, self.device)
        return ReferenceFrame(self.config, quantize_fp8(nets) if control
                              else nets)

    def output(self, win: Window, i: int) -> dict:
        """Frame i's kept outputs, back on the device."""
        return {k: v.to(self.device) for k, v in
                self.slots[win.kept[i]].items()}

    def inputs(self, win: Window, i: int):
        b, c, hint = win.meta[i]
        img = self.traffic.images[b:b + 1]
        return (img, None if self.images_c is None else img,
                self.traffic.calibs[c], hint)

    def reference_inputs(self, win: Window, i: int, ref: ReferenceFrame):
        """Frame i's inputs for ``ref``: the window's image and calib, and
        where the traffic passes the previous frame's hint, the hint that
        the reference's own answer to frame i-1 (at the ceiling's budget)
        gives, not the program's."""
        img, img_c, calib, hint = self.inputs(win, i)
        if self.traffic.hint == "previous_valid" and i > 0:
            hint = ref.hint_after(ref(*self.inputs(win, i - 1)[:3], None))
        return img, img_c, calib, hint

    def compare(self, win: Window, frames: list, ref: ReferenceFrame) -> list:
        """Each frame's counts, the window's output against ``ref``, with
        the program's hint and the reference's beside them."""
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            out = []
            for i in frames:
                inputs = self.reference_inputs(win, i, ref)
                counts = compare.frame_counts(self.output(win, i),
                                              ref(*inputs),
                                              self.limits["tolerances"])
                counts["hints"] = [win.meta[i][2], inputs[3]]
                out.append(counts)
            return out
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev

"""One cell of the benchmark: its configuration under its traffic mix,
driven as the live demo drives the engine.

Closed loop, batch 1, one frame in flight: each frame is timed on the
host clock from the call to ``ReconEngine.frame`` to the
``synchronize`` after it, and the next is issued at once. A sample of
the window's frames (one a block of ``keep_block``, at an offset drawn
from the seed) is copied into pinned host buffers allocated before the
window, so the sample takes no device memory; after it, the limits
file's ``frames`` of them, drawn from the seed, are held to the
reference. Of a frame's volume (``sdf``) the sample keeps the voxels
above the iso-level (``inside``), where the limits compare ``sdf_bad``.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import time

import numpy as np
import torch

from ..reference.frame import control_nets, load_nets, reference_frame
from . import compare, host, program, traffic, weights
from . import trace as tracing

KEEP_BLOCK = 32
MAX_FPS = 120                      # sizes the draw of the sample's offsets
OUTPUTS = ("depth", "valid", "render_norm", "render_tex")


def keep_block(seconds: float, rate: float, frames: int) -> int:
    """One window frame kept in so many: ``KEEP_BLOCK``, or fewer where a
    window of ``seconds`` at ``rate`` frames a second would keep fewer
    than 1.25 x the ``frames`` the limits file checks."""
    return max(1, min(KEEP_BLOCK, int(seconds * rate / (1.25 * frames))))


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
        self.level = self.config["profile"]["balance_value"]
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
        hint, times = None, []
        with torch.inference_mode():
            for i in range(n):
                t0 = time.perf_counter()
                out = self.frame(i, hint)
                self._sync()
                times.append(time.perf_counter() - t0)
                hint = self.hint_after(out)
        self.out_shapes = {k: (v.shape, v.dtype) for k, v in out.items()
                           if k in OUTPUTS}
        if "sdf" in out and "sdf_bad" in self.limits["limits"]:
            self.out_shapes["inside"] = (out["sdf"].shape, torch.bool)
        # frames a second of the warm-up's second half, built and captured
        self.warm_rate = 1.0 / float(np.median(times[n // 2:]))
        self.timings["warm_up_s"] = time.perf_counter() - t
        self.timings["warm_up_frames"] = n
        return n

    def prepare_sample(self, seconds: float):
        """The frames to keep and the buffers they go to: buffers for the
        blocks that a window at twice the warm-up's rate reaches."""
        rng = np.random.default_rng([self.seed, 1])
        block = keep_block(seconds, self.warm_rate, self.limits["frames"])
        blocks = math.ceil(seconds * MAX_FPS / block) + 1
        offsets = rng.integers(block, size=blocks)
        n = min(blocks, math.ceil(seconds * 2 * self.warm_rate / block) + 1)
        self.keep = {j * block + int(r): j for j, r in
                     enumerate(offsets[:n])}
        pin = self.device.type == "cuda"
        self.slots = [{k: torch.empty(s, dtype=d, pin_memory=pin)
                       for k, (s, d) in self.out_shapes.items()}
                      for _ in range(n)]
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
                        slot[k].copy_(compare.inside(out, self.level)
                                      if k == "inside" else out[k],
                                      non_blocking=True)
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

    def reference(self, control: bool = False):
        """The reference frame of the profile's mode; with ``control``, on
        the configuration's control nets (``control_nets``)."""
        nets = load_nets(self.config, self.states, self.device)
        return reference_frame(self.config, control_nets(self.config, nets)
                               if control else nets)

    def head_rows(self, body: int, pose: int):
        """The reference's rows of each query of the frame showing ``body``
        from ``pose``, on a path whose rows follow the image (cached;
        ``work.frame_head_works``'s ``rows``); None on the 'ray' path,
        whose rows follow the calib and the hint alone."""
        if self.config["profile"]["mode"] == "ray":
            return None
        if not hasattr(self, "_rows"):
            self._rows, self._rows_ref = {}, self.reference()
        if (body, pose) not in self._rows:
            with torch.inference_mode():
                self._rows[body, pose] = self._rows_ref.rows(
                    self.traffic.images[body:body + 1],
                    self.traffic.calibs[pose])
        return self._rows[body, pose]

    def output(self, win: Window, i: int) -> dict:
        """Frame i's kept outputs, back on the device."""
        return {k: v.to(self.device) for k, v in
                self.slots[win.kept[i]].items()}

    def inputs(self, win: Window, i: int):
        b, c, hint = win.meta[i]
        img = self.traffic.images[b:b + 1]
        return (img, None if self.images_c is None else img,
                self.traffic.calibs[c], hint)

    def reference_inputs(self, win: Window, i: int, ref):
        """Frame i's inputs for ``ref``: the window's image and calib, and
        where the traffic passes the previous frame's hint, the hint that
        the reference's own answer to frame i-1 (at the ceiling's budget)
        gives, not the program's."""
        img, img_c, calib, hint = self.inputs(win, i)
        if self.traffic.hint == "previous_valid" and i > 0:
            hint = ref.hint_after(ref(*self.inputs(win, i - 1)[:3], None))
        return img, img_c, calib, hint

    def compare(self, win: Window, frames: list, ref) -> list:
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
                                              self.limits["tolerances"],
                                              self.level)
                counts["hints"] = [win.meta[i][2], inputs[3]]
                out.append(counts)
            return out
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev

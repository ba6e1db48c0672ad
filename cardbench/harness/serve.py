"""A cell of the served demo: the configuration's ``serve`` entry under
a traffic mix with ``"driver": "serve"``, driven as upstream's
``RTL/main.py --use_server`` runs: ``apps/rtl_main``'s three-stage
pipeline (segment, device frame, composite with its JPEG) over a camera
stream, its MJPEG server on 127.0.0.1 and one local client reading
``/video_feed`` all through the run.

The stream yields the traffic's bodies (rendered on the device, copied
once to host float32 [S, S, 3] arrays in [0, 1]) as a looped clip does,
unpaced: frame i is body i mod bodies, handed over when the pipeline's
first bounded queue takes it. The camera (the scene's auto orbit) and the
compaction hint (the composite stage's) are the program's own. A served
frame is timed on the host clock from the stream's ``yield`` of its image
to the publication of its JPEG (the state's ``latest_jpeg`` set by the
composite stage), so its time holds its wait for room in the first queue.
The window is the served frames published within ``seconds`` after the
last warm-up frame's publication (at least one); its seconds run from
that publication to its last frame's. The warm-up serves ``warm_up_frames`` frames, so
that every pose's stage graphs are captured before the window.

A sample of the window's frames (one a block of ``cell.keep_block``, at
an offset drawn from the seed) is copied at the consumer, after the
composite stage, into pinned host buffers allocated before the window:
the segment's alpha, the engine's outputs, the served canvas and its JPEG
bytes. After it, the limits file's ``frames`` of them, drawn from the
seed, are held to the reference served frame (``reference/served.py``)
at the frame's place in the stream, the reference's hint from its
own answer to the frame whose valid share gave the program's frame its
hint.
"""

from __future__ import annotations

import dataclasses
import gc
import http.client
import math
import os
import socket
import statistics
import threading
import time

import numpy as np
import torch

from ..reference.frame import control_nets, load_nets
from ..reference.jpeg import decode_jpeg
from ..reference.served import ServedFrame
from . import compare, host, program, traffic, weights
from . import trace as tracing
from .cell import MAX_FPS, keep_block
from .manifest import ROOT

OUTPUTS = ("depth", "valid", "render_norm", "render_tex")
SETTLE_FRAMES = 12          # frames served before a profiled stretch
BOUNDARY = b"--frame\r\n"


def stage_name(fn) -> str:
    return f"cardbench.serve.{fn.__name__}"


@dataclasses.dataclass
class Window:
    times: list                    # seconds a served frame, yield to publish
    elapsed: float                 # the window's seconds
    first: int                     # the stream's index of its first frame
    kept: dict                     # frame -> slot
    host: dict                     # what the host did; the stages' medians
    stages: dict                   # stage -> median host ms at the close
    jpeg_ms: list                  # the composite stage's JPEG ms a frame
    client_parts: int              # parts the local client received

    @property
    def frames(self) -> int:
        return len(self.times)


class Stream:
    """The clip the demo reads: ``frames`` in a loop, each hand-over
    stamped, until ``stop`` is set."""

    def __init__(self, frames: list):
        self.frames = frames
        self.stamps: list = []
        self.stop = threading.Event()

    def __iter__(self):
        i = 0
        while not self.stop.is_set():
            self.stamps.append(time.perf_counter())
            yield self.frames[i % len(self.frames)]
            i += 1


class Client(threading.Thread):
    """A viewer of ``/video_feed``: the time each part's boundary
    arrives."""

    def __init__(self, port: int):
        super().__init__(name="cardbench-client", daemon=True)
        self.port = port
        self.stamps: list = []
        self.stop = threading.Event()
        self.sock = None

    def run(self):
        conn = http.client.HTTPConnection("127.0.0.1", self.port)
        conn.request("GET", "/video_feed")
        self.sock = conn.sock
        res = conn.getresponse()
        tail = b""
        while not self.stop.is_set():
            try:                 # blocks until a part comes or ``close``
                chunk = res.read1(1 << 16)
            except OSError:
                break
            if not chunk:
                break
            data = tail + chunk
            now = time.perf_counter()
            self.stamps.extend([now] * data.count(BOUNDARY))
            tail = data[-(len(BOUNDARY) - 1):]
        res.close()
        conn.close()

    def close(self):
        self.stop.set()
        if self.sock is not None:
            try:
                self.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        self.join(timeout=10)


class ServeCell:
    def __init__(self, manifest, workload: str, seed: int, device):
        self.entry = manifest.workload(workload)
        self.config = manifest.config(self.entry["config"])
        self.spec = manifest.traffic(self.entry["traffic"])
        self.limits = manifest.limits(workload)
        self.seed = int(seed)
        self.device = torch.device(device)
        self.level = self.config["profile"]["balance_value"]
        self.timings: dict = {}
        self.published: list = []      # publication times, by frame
        self.jpegs: dict = {}           # frame -> JPEG, until consumed
        self.hints_written = 0          # frames whose hint has been written
        self.hint_source: list = []     # frame -> the frame its hint is of
        self.served = 0                 # frames the consumer has taken
        self.profiling = False

    # -- set-up ---------------------------------------------------------
    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def on_publish(self, jpeg: bytes):
        now = time.perf_counter()
        self.jpegs[len(self.published)] = jpeg
        self.published.append(now)

    def on_hint_write(self):
        self.hints_written += 1

    def on_hint_read(self):
        self.hint_source.append(self.hints_written - 1
                                if self.hints_written else None)

    def _annotated(self, fn):
        name = stage_name(fn)

        def stage(d):
            if not self.profiling:
                return fn(d)
            from torch.profiler import record_function

            with record_function(name):
                return fn(d)
        stage.__name__ = fn.__name__
        return stage

    def setup(self) -> dict:
        t = time.perf_counter()
        if self.device.type == "cuda":
            self.timings["nvcc_s"] = program.build_kernels()
            self.timings["kernels_s"] = time.perf_counter() - t
            t = time.perf_counter()
        spec = dict(self.spec, camera={"kind": "identity"})
        self.traffic = traffic.generate(spec, self.seed,
                                        self.config["image_size"], self.device)
        self.images = self.traffic.images * 0.5 + 0.5
        self.frames = [np.ascontiguousarray(x) for x in
                       self.images.cpu().numpy().astype(np.float32)]
        self.silhouettes = (self.traffic.images != 0).any(dim=-1)
        self._sync()
        self.timings["traffic_s"] = time.perf_counter() - t
        if self.device.type == "cuda":      # the peak is the program's
            torch.cuda.reset_peak_memory_stats(self.device)
        t = time.perf_counter()
        self.stream = Stream(self.frames)
        self.pipeline, self.server = program.build_served(
            self.config, self.stream, self, self.device)
        self.pipeline.processors = [self._annotated(p)
                                    for p in self.pipeline.processors]
        self.server_thread = threading.Thread(
            target=self.server.serve_forever, name="cardbench-server",
            daemon=True)
        self.server_thread.start()
        self.client = Client(self.server.server_address[1])
        self.client.start()
        self.it = iter(self.pipeline)
        self.timings["engine_s"] = time.perf_counter() - t
        return self.timings

    def _captures(self) -> int:
        """The stage graphs the served engine has captured so far."""
        graphs = getattr(self.pipeline.engine, "graphs", None)
        return sum(v.get("capture", 0) for v in graphs.counts.values()) \
            if graphs is not None else 0

    def _next(self) -> tuple[int, dict]:
        """(its index, the next served frame) and its JPEG, taken off the
        record."""
        d = next(self.it)
        n = self.served
        self.served += 1
        d["jpeg"] = self.jpegs.pop(n)
        return n, d

    def warm_up(self) -> int:
        """``warm_up_frames`` served frames: every pose of the orbit with
        the hints it meets, each stage graph captured."""
        t = time.perf_counter()
        n = self.spec["warm_up_frames"]
        with torch.inference_mode():
            for _ in range(n):
                i, d = self._next()
        size = self.config["serve"]["size"]
        if d["window_server"].shape != (size, size, 3):
            raise ValueError(f"the demo serves {d['window_server'].shape}, "
                             f"not the scene's {size}^2")
        self.out_shapes = {k: (d[k].shape, d[k].dtype) for k in OUTPUTS}
        self.out_shapes["alpha"] = (d["segm"].shape[1:3], torch.float32)
        pub = np.diff(self.published[n // 2:n])
        self.warm_rate = 1.0 / float(np.median(pub))
        self.timings["warm_up_s"] = time.perf_counter() - t
        self.timings["warm_up_frames"] = n
        return n

    def prepare_sample(self, seconds: float):
        """The window frames to keep and the pinned buffers they go to."""
        rng = np.random.default_rng([self.seed, 1])
        block = keep_block(seconds, self.warm_rate, self.limits["frames"])
        blocks = math.ceil(seconds * MAX_FPS / block) + 1
        offsets = rng.integers(block, size=blocks)
        n = min(blocks, math.ceil(seconds * 2 * self.warm_rate / block) + 1)
        self.keep = {j * block + int(r): j for j, r in enumerate(offsets[:n])}
        pin = self.device.type == "cuda"
        self.slots = [{k: torch.empty(s, dtype=dt, pin_memory=pin)
                       for k, (s, dt) in self.out_shapes.items()}
                      for _ in range(n)]
        self.host_kept: dict = {}
        self.check_rng = rng
        gc.collect()
        gc.freeze()

    def _keep(self, j: int, n: int, d: dict):
        slot = self.slots[self.keep[j]]
        for k in slot:
            src = d["segm"][0, ..., 3] if k == "alpha" else d[k]
            slot[k].copy_(src, non_blocking=True)
        self.host_kept[j] = {"n": n, "served": d["window_server"].copy(),
                             "jpeg": d["jpeg"], "calib": np.array(d["calib"]),
                             "hint_of": self.hint_source[n]}

    # -- the window ---------------------------------------------------------
    def window(self, seconds: float) -> Window:
        times, kept, jpeg_ms = [], {}, []
        first = self.served
        t0 = self.published[first - 1]
        parts0 = len(self.client.stamps)
        captures0 = self._captures()
        with torch.inference_mode(), host.Watch() as watch:
            while True:
                n, d = self._next()
                if self.published[n] - t0 > seconds and n > first:
                    break
                j = n - first
                times.append(self.published[n] - self.stream.stamps[n])
                jpeg_ms.append(d["jpeg_ms"])
                if j in self.keep:
                    self._keep(j, n, d)
                    kept[j] = self.keep[j]
            elapsed = self.published[n - 1] - t0
        stages = {st.name: st.median_ms for st in self.pipeline.stats[1:]}
        parts = sum(1 for s in self.client.stamps[parts0:]
                    if t0 < s <= t0 + elapsed)
        self._sync()
        record = dict(watch.record, stages_ms=stages,
                      jpeg_ms=statistics.median(jpeg_ms) if jpeg_ms
                      else None,
                      client_parts=parts,
                      graph_captures=self._captures() - captures0)
        return Window(times, elapsed, first, kept, record, stages, jpeg_ms,
                      parts)

    def profile(self, win: Window, frames: int):
        """(Trace, frames a second) of ``frames`` more served frames under
        the profiler (every thread's host operations, where the profiler
        can), after ``SETTLE_FRAMES`` that let the pipeline refill."""
        from torch.profiler import ProfilerActivity, profile, record_function

        kw = {}
        try:
            kw["experimental_config"] = torch._C._profiler._ExperimentalConfig(
                profile_all_threads=True)
        except (AttributeError, TypeError):
            pass
        with torch.inference_mode():
            for _ in range(SETTLE_FRAMES):
                self._next()
            self.profiling = True
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA], **kw) as prof:
                with record_function(tracing.FRAME):
                    t0 = time.perf_counter()
                    for _ in range(frames):
                        self._next()
                    rate = frames / (time.perf_counter() - t0)
                self._sync()
            self.profiling = False
        return tracing.reduce(prof, frames), rate

    def free_program(self):
        """Stop the stream, serve what is in flight, stop the client and
        the server; the program's memory back to the device."""
        self.stream.stop.set()
        with torch.inference_mode():
            for d in self.it:
                self.jpegs.pop(self.served, None)
                self.served += 1
        self.pipeline.close()
        self.client.close()
        self.server.shutdown()
        self.server.server_close()
        self.server_thread.join(timeout=10)
        self.pipeline = self.it = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- correctness ---------------------------------------------------------
    def checked(self, win: Window) -> list:
        kept = sorted(win.kept)
        n = min(self.limits["frames"], len(kept))
        return sorted(self.check_rng.choice(kept, size=n, replace=False)
                      .tolist()) if n else []

    def reference(self, control: bool = False, segment=None):
        """The reference served frame; with ``control``, on the
        configuration's control nets; ``segment``: another segmenter."""
        if not hasattr(self, "states"):
            self.states = weights.states(self.config, self.seed, self.device)
        nets = load_nets(self.config, self.states, self.device)
        if control:
            nets = control_nets(self.config, nets)
        return ServedFrame(self.config, nets, ROOT, self.device, segment)

    def output(self, win: Window, j: int) -> dict:
        """Window frame j's kept outputs, the device's back on it."""
        out = {k: v.to(self.device) for k, v in
               self.slots[win.kept[j]].items()}
        kept = self.host_kept[j]
        out.update(served=torch.as_tensor(kept["served"], device=self.device),
                   jpeg=kept["jpeg"], calib=kept["calib"], n=kept["n"],
                   hint_of=kept["hint_of"])
        return out

    def reference_answer(self, ref, n: int, hint_of):
        """The reference's answer to the stream's frame n. Its hint, where
        the program's frame n had one, is the one that the reference's own
        answer (at the ceiling's budget) to the frame ``hint_of`` gives:
        the frame whose valid share the composite stage had written last
        when the device stage took frame n (the stages run frames apart,
        so that is not always frame n - 1)."""
        bodies = len(self.frames)
        hint = None
        if hint_of is not None:
            hint = ref.hint_after(ref(self.images[hint_of % bodies][None],
                                      hint_of, None))
        return ref(self.images[n % bodies][None], n, hint)

    def compare(self, win: Window, frames: list, ref) -> list:
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            out = []
            for j in frames:
                got = self.output(win, j)
                want = self.reference_answer(ref, got["n"], got["hint_of"])
                counts = served_counts(got, want, self.limits["tolerances"],
                                       self.level)
                body = got["n"] % len(self.frames)
                counts["matte_iou"] = matte_iou(got["alpha"],
                                                self.silhouettes[body])
                counts["calib_gap"] = float(np.abs(got["calib"]
                                                   - want["calib"]).max())
                counts["hint_of"] = [got["n"], got["hint_of"]]
                out.append(counts)
            return out
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev


def matte_iou(alpha: torch.Tensor, silhouette: torch.Tensor) -> float:
    a = alpha > 0.5
    return float((a & silhouette).sum()) / max(int((a | silhouette).sum()), 1)


def _off_pixels(a: torch.Tensor, b: torch.Tensor, tol: float) -> torch.Tensor:
    return ~((a.float() - b.float()).abs().amax(dim=-1) <= tol)


def served_counts(got: dict, want: dict, tols: dict, level=None) -> dict:
    """One served frame's {share: [off, counted]}: the frame's shares
    (``compare.frame_counts``); ``alpha_bad``, matte pixels (alpha over
    ``matte_floor`` on either side) off by more than ``alpha``;
    ``served_bad`` and ``floor_bad``, pixels of the served canvas off from
    the reference's by more than ``served`` uint8 steps in a channel,
    where either side's subject mask is set and where neither's is;
    ``jpeg_bad``, pixels of the served JPEG, decoded by the reference
    decoder, off from the program's own served canvas by more than
    ``jpeg`` steps (all of them where it does not decode)."""
    out = compare.frame_counts(got, want, tols, level)
    ga, wa = got["alpha"].float(), want["alpha"].float()
    matte = (ga > tols["matte_floor"]) | (wa > tols["matte_floor"])
    err = (ga - wa).abs()[matte]
    out["alpha_bad"] = [int((~(err <= tols["alpha"])).sum()), int(matte.sum())]
    out["alpha_p995"] = compare._p995(err)
    off = _off_pixels(got["served"], want["served"], tols["served"])
    subject = want["mask"] | _subject_of(got)
    out["served_bad"] = [int(off[subject].sum()), int(subject.sum())]
    out["floor_bad"] = [int(off[~subject].sum()), int((~subject).sum())]
    try:
        shown = torch.as_tensor(decode_jpeg(got["jpeg"]),
                                device=got["served"].device)
        jpeg_off = (int(_off_pixels(shown, got["served"], tols["jpeg"]).sum())
                    if shown.shape == got["served"].shape
                    else got["served"][..., 0].numel())
    except ValueError:
        jpeg_off = got["served"][..., 0].numel()
    out["jpeg_bad"] = [jpeg_off, got["served"][..., 0].numel()]
    return out


def _subject_of(got: dict) -> torch.Tensor:
    """The program's subject mask, as the reference reads one: a pixel of
    its texture render that is not white in every channel."""
    tex = got.get("render_tex", got["render_norm"]).float()
    return ~(tex >= 1.0).all(dim=-1)


CELL = ServeCell

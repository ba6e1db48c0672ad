"""Streaming pipeline runtime: threaded software pipelining (the port's
copy of ``monoport_tpu/pipeline/runtime.py``; pure Python).

Each stage owns a daemon thread and bounded in/out queues (backpressure),
so stage k of frame i overlaps stage k-1 of frame i+1:

  * exceptions are captured per stage and re-raised at the consumer with
    the stage name;
  * ordered delivery holds by construction (one thread a stage, FIFO
    queues);
  * shutdown: a sentinel flows through all stages; ``close()`` is
    idempotent and joins every thread;
  * per-stage latency stats: the EMA and the median of the recent frames
    (``report``).

A stage that runs torch code enters ``torch.inference_mode()`` itself:
autograd state is per thread, so the consumer's mode does not reach the
stage threads.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import statistics
import threading
import time
from typing import Any, Callable, Iterable, Iterator, Sequence


RECENT = 64      # frames a stage's median looks back over


class _Sentinel:
    pass


_DONE = _Sentinel()


@dataclasses.dataclass
class StageStats:
    """A stage's latency: the EMA, the last, and the recent frames' (the
    last ``RECENT``; their median does not carry a slow first frame for
    long, as the EMA does)."""
    name: str
    frames: int = 0
    ema_ms: float = 0.0
    last_ms: float = 0.0
    recent_ms: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=RECENT))

    def update(self, dt: float) -> None:
        ms = dt * 1e3
        self.frames += 1
        self.last_ms = ms
        self.recent_ms.append(ms)
        self.ema_ms = ms if self.frames == 1 else (
            0.9 * self.ema_ms + 0.1 * ms)

    @property
    def median_ms(self) -> float:
        return statistics.median(self.recent_ms) if self.recent_ms else 0.0


class _StageError:
    def __init__(self, stage: str, exc: BaseException):
        self.stage = stage
        self.exc = exc


class Pipeline:
    """N-stage threaded pipeline over a source iterable.

    Args:
      source: iterable producing the initial payloads (frames).
      processors: stage callables, each ``payload -> payload`` (the
        demo passes dicts through; any object works).
      max_queue: per-queue bound (backpressure depth; 2 = double buffer).
    """

    def __init__(self, source: Iterable, processors: Sequence[Callable],
                 max_queue: int = 2, name: str = "pipeline"):
        self.source = source
        self.processors = list(processors)
        self.name = name
        self._queues = [queue.Queue(maxsize=max_queue)
                        for _ in range(len(self.processors) + 1)]
        self.stats = [StageStats("source")] + [
            StageStats(getattr(p, "__name__", f"stage{i}"))
            for i, p in enumerate(self.processors)]
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()
        self._started = False

    # -- workers ------------------------------------------------------------
    def _source_loop(self) -> None:
        st = self.stats[0]
        try:
            t_prev = time.perf_counter()
            for item in self.source:
                if self._stop.is_set():
                    break
                now = time.perf_counter()
                st.update(now - t_prev)
                t_prev = now
                self._put(self._queues[0], item)
            self._put(self._queues[0], _DONE, force=True)
        except BaseException as exc:  # noqa: BLE001 - forwarded to consumer
            self._put(self._queues[0], _StageError("source", exc), force=True)

    def _stage_loop(self, idx: int) -> None:
        fn = self.processors[idx]
        in_q, out_q = self._queues[idx], self._queues[idx + 1]
        st = self.stats[idx + 1]
        while not self._stop.is_set():
            item = in_q.get()
            if isinstance(item, (_Sentinel, _StageError)):
                self._put(out_q, item, force=True)
                return
            try:
                t0 = time.perf_counter()
                out = fn(item)
                st.update(time.perf_counter() - t0)
            except BaseException as exc:  # noqa: BLE001
                self._put(out_q, _StageError(st.name, exc), force=True)
                return
            self._put(out_q, out)

    def _put(self, q: queue.Queue, item: Any, force: bool = False) -> None:
        while not self._stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue
        if force:  # drain one slot so shutdown markers always land
            try:
                q.get_nowait()
            except queue.Empty:
                pass
            try:
                q.put_nowait(item)
            except queue.Full:
                pass

    # -- public API ---------------------------------------------------------
    def start(self) -> "Pipeline":
        if self._started:
            return self
        self._started = True
        self._threads = [threading.Thread(
            target=self._source_loop, name=f"{self.name}-source",
            daemon=True)]
        for i in range(len(self.processors)):
            self._threads.append(threading.Thread(
                target=self._stage_loop, args=(i,),
                name=f"{self.name}-{self.stats[i + 1].name}", daemon=True))
        for t in self._threads:
            t.start()
        return self

    def __iter__(self) -> Iterator[Any]:
        self.start()
        out_q = self._queues[-1]
        while True:
            item = out_q.get()
            if isinstance(item, _Sentinel):
                return
            if isinstance(item, _StageError):
                self.close()
                raise RuntimeError(
                    f"pipeline stage '{item.stage}' failed") from item.exc
            yield item

    def close(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)

    def __enter__(self) -> "Pipeline":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def report(self) -> str:
        lines = [f"[{self.name}] per-stage latency (EMA, median of the "
                 f"last {RECENT}):"]
        for st in self.stats:
            lines.append(f"  {st.name:>24}: {st.ema_ms:7.2f} ms, "
                         f"{st.median_ms:7.2f} ms ({st.frames} frames)")
        return "\n".join(lines)

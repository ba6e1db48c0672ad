"""What the host did during a window, for the record: the seconds in
Python's garbage collector, the share of the machine's CPU time that its
hypervisor took for others (``steal`` in ``/proc/stat``), the process's
context switches, and the frame rate of each stretch of ``CHUNK_S``
seconds."""

from __future__ import annotations

import gc
import resource
import time

CHUNK_S = 5.0


def _cpu_times():
    """The machine's CPU time fields ('cpu' line of /proc/stat), or None."""
    try:
        with open("/proc/stat") as fh:
            return [int(x) for x in fh.readline().split()[1:]]
    except (OSError, ValueError):
        return None


class Watch:
    def __enter__(self):
        self.gc_s, self.gc_runs, self._t = 0.0, 0, None
        gc.callbacks.append(self._on_gc)
        self._cpu = _cpu_times()
        self._ru = resource.getrusage(resource.RUSAGE_SELF)
        return self

    def _on_gc(self, phase, _info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.gc_s += time.perf_counter() - self._t
            self.gc_runs += 1

    def __exit__(self, *exc):
        gc.callbacks.remove(self._on_gc)
        ru = resource.getrusage(resource.RUSAGE_SELF)
        cpu = _cpu_times()
        self.record = {
            "gc_s": self.gc_s, "gc_runs": self.gc_runs,
            "cpu_user_s": ru.ru_utime - self._ru.ru_utime,
            "cpu_sys_s": ru.ru_stime - self._ru.ru_stime,
            "switches_involuntary": ru.ru_nivcsw - self._ru.ru_nivcsw,
            "switches_voluntary": ru.ru_nvcsw - self._ru.ru_nvcsw}
        if cpu and self._cpu and len(cpu) > 7:
            d = [b - a for a, b in zip(self._cpu, cpu)]
            self.record["steal_share"] = d[7] / max(sum(d), 1)
        return False


def chunk_rates(times: list) -> list:
    """Frames a second in each ``CHUNK_S`` of the window, in order."""
    rates, n, t = [], 0, 0.0
    for dt in times:
        n, t = n + 1, t + dt
        if t >= CHUNK_S:
            rates.append(n / t)
            n, t = 0, 0.0
    return rates

"""The window's host record: rates by stretch and the collector's time."""

import gc

from cardbench.harness import host


def test_chunk_rates():
    times = [0.5] * 25                      # 12.5 s of 2 frames a second
    assert host.chunk_rates(times) == [2.0, 2.0]


def test_watch_records_the_collector():
    with host.Watch() as watch:
        gc.collect()
    rec = watch.record
    assert rec["gc_runs"] >= 1 and rec["gc_s"] >= 0.0
    assert rec["switches_involuntary"] >= 0
    assert gc.callbacks.count(watch._on_gc) == 0

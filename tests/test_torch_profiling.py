"""PyTorch port, profiling: ``utils/profiling.py`` on the CPU, held to the
contract of ``monoport_tpu/utils/profiling.py``: ``device_time`` runs one
warm-up call and then ``iters`` calls, each on the previous call's output
through ``chain``, and returns seconds a call; ``trace`` writes a Chrome
trace, with the program's spans on a track of their own. On the card
``device_time`` reads CUDA events, which only a card run exercises."""

import json
import os

import torch

from monoport_tpu_torch.utils import profiling as prof

torch.set_num_threads(2)


def test_device_time_chains_its_calls():
    """Default chain: + 1e-12 x the sum of the first output tensor."""
    seen = []

    def fn(x):
        seen.append(x.clone())
        return {"y": x * 2.0, "note": "not a tensor"}

    x0 = torch.full((4,), 1e6, dtype=torch.float64)
    sec = prof.device_time(fn, x0, iters=5)
    assert 0.0 < sec < 1.0 and len(seen) == 6
    for a, b in zip(seen, seen[1:]):
        torch.testing.assert_close(b, a + (2.0 * a).sum() * 1e-12,
                                   rtol=0, atol=0)


def test_device_time_takes_a_chain():
    """``chain(arg, out) -> arg``: here the next input is the output."""
    inputs = []

    def fn(x):
        inputs.append(float(x[0]))
        return x + 1.0

    prof.device_time(fn, torch.zeros(3), chain=lambda a, o: o, iters=3)
    assert inputs == [0.0, 1.0, 2.0, 3.0]


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with prof.trace(log_dir) as d:
        assert d == log_dir
        torch.rand(32, 32) @ torch.rand(32, 32)
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_trace_puts_the_spans_over_the_ops(tmp_path):
    """The spans on their own track, on the ops' time base: each span
    holds the matrix product run inside it (within 100 us)."""
    log_dir = str(tmp_path / "trace")
    a = torch.rand(64, 64)
    with prof.trace(log_dir):
        for i in range(4):
            with prof.span(prof.FRAME, step=i):
                with prof.span("inner"):
                    prof.query("q", 64)
                    a @ a
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("cat") == "program_span"]
    mms = [e for e in events if e.get("name") == "aten::mm"]
    assert [e["name"] for e in spans] == [prof.FRAME, "inner"] * 4
    assert len(mms) == 4
    track = {e["pid"] for e in spans}
    assert len(track) == 1 and not track & {e["pid"] for e in mms}
    names = {e["pid"]: e["args"]["name"] for e in events
             if e.get("name") == "process_name"}
    assert names[track.pop()] == "program spans"
    for i, mm in enumerate(mms):
        frame, inner = spans[2 * i], spans[2 * i + 1]
        assert frame["args"] == {"step": i, "frame": i}
        assert inner["args"]["queries"] == [
            {"name": "q", "rows": 64, "taps": 1, "anchors": 0}]
        for s in (frame, inner):
            assert s["ts"] - 100 <= mm["ts"]
            assert mm["ts"] + mm["dur"] <= s["ts"] + s["dur"] + 100

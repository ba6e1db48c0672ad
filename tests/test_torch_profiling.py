"""PyTorch port, profiling: ``utils/profiling.py`` on the CPU, held to the
contract of ``monoport_tpu/utils/profiling.py``: ``device_time`` runs one
warm-up call and then ``iters`` calls, each on the previous call's output
through ``chain``, and returns seconds a call; ``measure_rtt`` fetches a
tiny result; ``trace`` writes a Chrome trace. On the card ``device_time``
reads CUDA events, which only a card run exercises."""

import json
import os

import pytest
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
    sec = prof.device_time(fn, x0, iters=5, rtt=123.0)   # rtt is ignored
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


def test_measure_rtt_runs_on_the_card_unless_asked(monkeypatch):
    assert prof.measure_rtt(device="cpu") > 0.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prof.measure_rtt()


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with prof.trace(log_dir) as d:
        assert d == log_dir
        torch.rand(32, 32) @ torch.rand(32, 32)
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)

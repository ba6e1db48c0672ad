"""The command as the check runs it. Without a card it refuses, exit 2
and no result; on the card (marked ``cuda``) each cell's short run ends
correct, its last line holding the contract's keys."""

import json
import os
import subprocess
import sys

import pytest
import torch

from cardbench.harness.manifest import ROOT, Manifest

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _run(workload: str, seconds: float, trace: int = 0):
    return subprocess.run(
        [sys.executable, "cardbench/run.py", "--workload", workload,
         "--seed", str(2 ** 31 + 77), "--seconds", str(seconds),
         "--trace", str(trace)], cwd=ROOT, capture_output=True, text=True,
        timeout=900)


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal needs none")
    out = _run("hg4-frontal", 1)
    assert out.returncode == 2
    assert "correct" not in out.stdout


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      Manifest().data["workloads"]])
def test_cell_on_the_card(card, workload):
    out = _run(workload, 3)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(res) == KEYS
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert set(res["metrics"]) == {m["name"] for m in
                                   Manifest().end_to_end(workload)}
    assert os.path.isdir(os.path.join(ROOT, "monoport_tpu_torch", "_build"))

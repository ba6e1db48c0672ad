"""``correct`` has to come out false: the control (the reference on
float8 e4m3 inputs and weights, put in the engine's place) and planted
faults, each driven through the rest of a run on the CPU at a small size
(the look for a card skipped). A sound run of the same size is correct.
The control's readings at the cells' own size on the card come from
``cardbench/calibrate.py`` (PERF.md)."""

import time

import pytest
import torch

import monoport_tpu_torch.engine as engine_mod
from cardbench import run as bench_run
from cardbench.harness.cell import Cell
from cardbench.reference.frame import ReferenceFrame, load_nets, quantize_fp8

from .small import SmallManifest

SEED = 4_100_000_003
CELLS = ("hg4-frontal", "hg4-orbit", "hrnet-frontal")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(workload, bodies=4):
    res, checks = bench_run.run(SmallManifest(bodies=bodies), workload, SEED,
                                1.5, False, device="cpu",
                                t_start=time.perf_counter())
    return res


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    res = _run(workload)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("workload", CELLS)
def test_control_in_the_engines_place(monkeypatch, workload):
    """The f32 reference rounded to fp8 answers every frame."""
    def control_frame(self, i, hint):
        if not hasattr(self, "_control"):
            nets = load_nets(self.config, self.states, self.device)
            self._control = ReferenceFrame(self.config, quantize_fp8(nets))
        b, c = self.traffic.frame(i)
        img = self.traffic.images[b:b + 1]
        return self._control(img, None if self.images_c is None else img,
                             self.traffic.calibs[c], hint)

    monkeypatch.setattr(Cell, "frame", control_frame)
    res = _run(workload)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_stale_frame(monkeypatch, workload):
    """A frame that returns the state it had: every frame answers with the
    first frame's outputs."""
    frame = Cell.frame

    def stale(self, i, hint):
        out = frame(self, i, hint)
        if not hasattr(self, "_first"):
            self._first = {k: v.clone() for k, v in out.items()}
        return self._first

    monkeypatch.setattr(Cell, "frame", stale)
    res = _run(workload)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_altered_answers(monkeypatch, workload):
    """Every head's occupancy moved by 0.2 where the kernels produce it."""
    for name in ("apply_ray", "apply_mlp", "apply_anchor"):
        fn = getattr(engine_mod, name)
        monkeypatch.setattr(engine_mod, name,
                            lambda *a, fn=fn: fn(*a) + 0.2)
    res = _run(workload)
    assert not res["correct"], res["checks"]

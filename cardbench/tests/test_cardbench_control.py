"""``correct`` has to come out false: the control (the reference one
precision step below the configuration, float8 e4m3 under bf16 and TF32
under float32, put in the engine's place) and planted faults (a stale
state, altered answers, a frame with no silhouette, and in the dense cell
a volume altered only behind the surface the peel sees), each driven
through the rest of a run on the CPU at a small size (the look for a card
skipped). A sound run of the same size is correct.
The control's readings at the cells' own size on the card come from
``cardbench/calibrate.py`` (PERF.md)."""

import time

import pytest
import torch

import monoport_tpu_torch.engine as engine_mod
from cardbench import run as bench_run
from cardbench.harness.cell import Cell
from cardbench.harness.manifest import Manifest
from cardbench.reference.frame import control_nets, load_nets, reference_frame

from .small import SmallManifest

SEED = 4_100_000_003
CELLS = ("hg4-frontal", "hg4-orbit", "hrnet-frontal", "hg4-dense")


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
    """The f32 reference one precision step below the configuration (its
    full-size file's: the small cut computes in f32) answers every
    frame."""
    def control_frame(self, i, hint):
        if not hasattr(self, "_control"):
            nets = load_nets(self.config, self.states, self.device)
            stated = Manifest().config(self.entry["config"])
            self._control = reference_frame(self.config,
                                            control_nets(stated, nets))
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


@pytest.mark.parametrize("workload", CELLS)
def test_empty_frame(monkeypatch, workload):
    """Every frame answers with no silhouette at all."""
    frame = Cell.frame

    def empty(self, i, hint):
        out = dict(frame(self, i, hint))
        out["valid"] = torch.zeros_like(out["valid"])
        return out

    monkeypatch.setattr(Cell, "frame", empty)
    res = _run(workload)
    assert not res["correct"], res["checks"]


def test_hidden_voxels_altered(monkeypatch):
    """The volume's far half emptied where the frame produces it: the
    peeled depth, silhouette and renders stay the reference's, the
    ``sdf`` does not."""
    frame = Cell.frame
    seen = []

    def hollow(self, i, hint):
        out = dict(frame(self, i, hint))
        sdf = out["sdf"].clone()
        sdf[:sdf.shape[0] // 2] = 0.0
        seen.append(bool((out["sdf"][:sdf.shape[0] // 2] > 0.5).any()))
        out["sdf"] = sdf
        return out

    monkeypatch.setattr(Cell, "frame", hollow)
    res = _run("hg4-dense")
    assert any(seen)
    assert not res["correct"], res["checks"]
    checks = res["checks"]
    assert checks["sdf_bad"]["value"] > checks["sdf_bad"]["limit"]
    for k in ("valid_bad", "depth_bad", "norm_bad", "tex_bad"):
        assert checks[k]["value"] <= checks[k]["limit"], k

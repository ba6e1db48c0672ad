"""The multi-view cell (``harness/views.py``, traffic ``ring4``): a small
run on the CPU is held to its reference and reads its per-layer metrics;
the view-pooled roofline counts the pooled head's work; a run and the new
reference load nothing they should not."""

import json
import os
import subprocess
import sys
import time
import types

import pytest
import torch

from cardbench import run
from cardbench.harness import spans, views
from cardbench.harness.manifest import ROOT, Manifest
from cardbench.tests.small import SmallManifest

CELL = "hg4-mv4-dense"
SMALL_YAWS = [0.0, 20.0, 40.0, 60.0]


class ViewsManifest(SmallManifest):
    """The small manifest on a ring whose pooled z is not 0, so that the
    seeded small net's -8 z weight makes a surface inside the volume (at
    0/90/180/270 the pooled z is 0 and the small net's surface is the
    volume's front face, whose peeled depth is 0/0)."""

    def traffic(self, name: str) -> dict:
        spec = super().traffic(name)
        if spec.get("driver") == "views":
            spec["camera"] = dict(spec["camera"], yaws=SMALL_YAWS)
        return spec


def _metric(name):
    return Manifest.reader(name)


def test_the_cell_is_its_entries():
    m = Manifest()
    w = m.workload(CELL)
    assert (w["config"], w["traffic"], w["chips"]) == (
        "monoport-hg4-mv4", "ring4", 1)
    config = m.config(w["config"])
    assert config["netG"]["head"]["num_views"] == 4 and "netC" not in config
    assert run.driver(m.traffic("ring4")) is views.ViewsCell
    names = {p["name"] for p in m.per_layer(CELL)}
    assert {"kernel2.views.roofline", "recon.views.sample_ms",
            "recon.query_rows"} <= names
    assert not names & {"kernel2.roofline", "backbone.ms", "frame.mfu"}


def test_small_run_is_correct():
    torch.set_num_threads(2)
    res, checks = run.run(ViewsManifest(bodies=2), CELL, 5, 1.0, False,
                          device="cpu", t_start=time.perf_counter())
    assert res["correct"], checks
    assert set(checks) == {"valid_bad", "depth_bad", "norm_bad", "sdf_bad"}


def test_span_readers_of_a_small_cell(capsys):
    torch.set_num_threads(2)
    cell = views.ViewsCell(ViewsManifest(bodies=2), CELL, 5, "cpu")
    cell.setup()
    ctx = types.SimpleNamespace(
        cell=cell, window=types.SimpleNamespace(frames=3, elapsed=1.0),
        trace=types.SimpleNamespace(frames=2))
    r = spans.readings(ctx)
    assert "recon.views.sample" in r.host_ms
    levels = len(cell.config["profile"]["hierarchy"]["resolutions"])
    assert r.host_ms["recon.views.sample"][0] > 0.0
    for name in ("backbone.host_ms", "recon.host_ms", "recon.query_rows",
                 "engine.self_ms"):
        assert _metric(name).read(ctx) > 0.0, name
    assert r.rows["query_occ"] > levels
    # the CPU launches no device operation: the device readings are 0 and
    # the kernel's share has nothing to read
    assert _metric("recon.views.sample_ms").read(ctx) == 0.0
    assert _metric("kernel2.views.roofline").read(ctx) is None
    capsys.readouterr()


def test_views_work_is_the_pooled_head():
    reader = _metric("kernel2.views.roofline")
    flops, t, nbytes = reader.views_point_work(
        [257, 1024, 512, 256, 128, 1], 10, 4)
    assert flops == 2.0 * 10 * (4 * 1_115_904 + 66_049)
    assert t == pytest.approx(flops / 67e12)
    assert nbytes > 10 * 4 * 257 * 4
    config = Manifest().config("monoport-hg4-mv4")
    widths = [257, 1024, 512, 256, 128, 1]
    assert reader.frame_bound_s(config, (4913, 0)) == pytest.approx(
        max(t / 10 * 4913, reader.views_point_work(widths, 4913, 4)[2]
            / 3.35e12)
        + reader.views_point_work(widths, 0, 4)[2] / 3.35e12)


def test_readers_read_nothing_without_the_program_span():
    class Ctx:
        class cell:
            span_readings = None
            config = {"netG": {"head": {"num_views": 4}}}
    assert _metric("recon.views.sample_ms").read(Ctx) is None
    assert _metric("kernel2.views.roofline").read(Ctx) is None


def _top_level(body: str) -> set:
    probe = ("import json, sys, time\n"
             f"sys.path.insert(0, {ROOT!r})\n{body}\n"
             "print(json.dumps(sorted({m.split('.')[0] "
             "for m in sys.modules})))")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_and_a_run_load_what_they_should():
    forbidden = {"jax", "jaxlib", "flax", "monoport_tpu"}
    names = _top_level("from cardbench.reference.frame import frame_path\n"
                       "frame_path('dense_views')\n"
                       "import cardbench.calibrate_views")
    assert not names & (forbidden | {"monoport_tpu_torch"})
    names = _top_level(
        "import torch; torch.set_num_threads(2)\n"
        "from cardbench.tests.test_cardbench_views import ViewsManifest\n"
        "from cardbench import run\n"
        f"res, _ = run.run(ViewsManifest(bodies=2), {CELL!r}, 5, 0.5, "
        "False, device='cpu', t_start=time.perf_counter())\n"
        "assert res['attempted'] > 0, res")
    assert "monoport_tpu_torch" in names and not names & forbidden

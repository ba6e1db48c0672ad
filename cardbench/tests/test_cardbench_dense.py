"""The reference of ``mode='dense'`` (``reference/frames/dense.py``)
against the port's dense frame on the CPU at a small size (f32, the
port's kernels through their plain versions, seeded weights), with the
levels under their budgets and over them; the engine a configuration's
profile builds against ``frame_check.quality_config``; and the work
counts against the reference's rows."""

import types

import numpy as np
import pytest
import torch

from cardbench.harness import program, spans, work
from cardbench.harness.cell import Cell
from cardbench.harness.manifest import Manifest
from cardbench.reference.frame import frame_path

from .small import SmallManifest

SEED = 3_000_000_019
CONFIG = "monoport-hg4-quality"


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class _Budgets(SmallManifest):
    """The small cut with budgets its levels overflow."""

    def config(self, name):
        c = super().config(name)
        c["profile"]["hierarchy"]["budgets"] = [0, 128, 512]
        return c


def _cell(manifest):
    cell = Cell(manifest, "hg4-dense", SEED, "cpu")
    cell.setup()
    return cell


@pytest.mark.parametrize("manifest,overflow", [(SmallManifest, False),
                                               (_Budgets, True)])
def test_dense_frames_match_the_port(manifest, overflow):
    cell = _cell(manifest(bodies=2))
    ref = cell.reference()
    budgets = cell.config["profile"]["hierarchy"]["budgets"][1:]
    with torch.inference_mode():
        for i in range(2):
            got = cell.frame(i, None)
            b, c = cell.traffic.frame(i)
            img = cell.traffic.images[b:b + 1]
            want = ref(img, img, cell.traffic.calibs[c], None)
            counts = got["recon_counts"].tolist()
            assert list(want["rows"][1:]) == [min(n, k) for n, k in
                                             zip(counts, budgets)]
            assert any(n > k for n, k in zip(counts, budgets)) == overflow
            assert torch.equal(got["sdf"] > 0.5, want["sdf"] > 0.5)
            assert float((got["sdf"] - want["sdf"]).abs().max()) < 1e-5
            assert torch.equal(got["valid"], want["valid"])
            v = want["valid"]
            assert 0.05 < float(v.float().mean())
            assert float((got["depth"] - want["depth"])[v].abs().max()) < 1e-3
            for key in ("render_norm", "render_tex"):
                assert float((got[key] - want[key]).abs().max()) < 1e-3, key


def test_engine_config_is_quality_config():
    from monoport_tpu_torch.frame_check import quality_config

    assert program.engine_config(Manifest().config(CONFIG)) == \
        quality_config()


def test_head_works_count_the_reference_rows():
    cfg = Manifest().config(CONFIG)
    g = cfg["netG"]["head"]["widths"]
    rows = (17 ** 3, 9000, 40000, 100000, 200000)
    eye = np.eye(4, dtype=np.float32)[None]
    want = [work.point_mlp_work(g, n) for n in rows]
    want.append(work.ray_mlp_work(cfg["netC"]["head"]["widths"], 257 * 257, 1))
    assert work.frame_head_works(cfg, eye, None, rows) == want
    assert work.frame_flops(cfg, eye, None, rows) == pytest.approx(
        work.backbone_flops(cfg["netG"]["backbone"], 512)
        + work.backbone_flops(cfg["netC"]["backbone"], 512)
        + sum(w[0] for w in want), rel=1e-12)
    # a calib off the grid colours per point
    tilted = frame_path("dense").queries(cfg, np.array([[[1, 0, 0.5, 0],
                                                          [0, 1, 0, 0],
                                                          [0, 0, 1, 0],
                                                          [0, 0, 0, 1]]]),
                                         rows)
    assert tilted[-1] == ("netC", "point", 257 * 257, 1)


def test_cell_rows_are_the_references():
    cell = _cell(SmallManifest(bodies=2))
    ref = cell.reference()
    with torch.inference_mode():
        for body in range(2):
            img = cell.traffic.images[body:body + 1]
            want = ref(img, img, cell.traffic.calibs[0], None)["rows"]
            assert cell.head_rows(body, 0) == want
    ray = Cell(SmallManifest(bodies=2), "hg4-frontal", SEED, "cpu")
    assert ray.head_rows(0, 0) is None


def test_kernel2_roofline_reads_the_hierarchy_span():
    """Kernel 2's time is that of the port's MLP kernels launched in
    ``recon.hierarchy`` (kernel 1's f32 colour shares their names); the
    bound, the reference's rows of the traced frames' bodies."""
    cell = _cell(SmallManifest(bodies=2))
    r = spans.Readings(frames=3, host_ms={}, layer_host_ms={}, device_ms={},
                       idle_ms={}, rows={}, layer_rows={}, plans={},
                       recorded_fps=1.0, traced_fps=1.0, traced_from=5,
                       op_ms={("recon.hierarchy", "void mlp_kernel<F32>"): 1.5,
                              ("recon.hierarchy", "void xproj_kernel<F"): 0.5,
                              ("recon.hierarchy", "aten::copy_"): 7.0,
                              ("texture.query", "void mlp_kernel<F32>"): 9.0})
    cell.span_readings = r
    ctx = types.SimpleNamespace(cell=cell, window=None, trace=None)
    g = cell.config["netG"]["head"]["widths"]
    bound = 0.0
    for i in (5, 6, 7):
        for n in cell.head_rows(cell.traffic.frame(i)[0], 0):
            bound += work.bound_s(work.point_mlp_work(g, n, 4,
                                                      work.PEAK_F32))
    got = Manifest.reader("kernel2.roofline").read(ctx)
    assert got == pytest.approx(100.0 * bound / 3 / 2e-3, rel=1e-12)
    r.op_ms = {("texture.query", "void mlp_kernel<F32>"): 9.0}
    assert Manifest.reader("kernel2.roofline").read(ctx) is None


def test_frame_mfu_counts_each_bodys_rows():
    cell = _cell(SmallManifest(bodies=2))
    meta = [(i % 2, 0, None) for i in range(5)]
    ctx = types.SimpleNamespace(cell=cell, window=types.SimpleNamespace(
        meta=meta, elapsed=2.0), trace=None)
    eye = cell.traffic.calibs[0]
    flops = [work.frame_flops(cell.config, eye, None, cell.head_rows(b, 0))
             for b in (0, 1)]
    assert flops[0] != flops[1]
    want = 100.0 * (3 * flops[0] + 2 * flops[1]) / 2.0 / work.PEAK_BF16
    assert Manifest.reader("frame.mfu").read(ctx) == pytest.approx(want,
                                                                   rel=1e-12)


def test_kernel1_f32_roofline_reads_the_texture_span():
    """Kernel 1's f32 colour: the f32 route's kernels launched in
    ``texture.query`` against netC's query of the last level's lattice,
    one tap a ray on the frontal calib, at the f32 peak."""
    cell = _cell(SmallManifest(bodies=2))
    r = spans.Readings(frames=2, host_ms={}, layer_host_ms={}, device_ms={},
                       idle_ms={}, rows={}, layer_rows={}, plans={},
                       recorded_fps=1.0, traced_fps=1.0, traced_from=3,
                       op_ms={("texture.query", "void mlp_kernel<F32>"): 0.5,
                              ("texture.query", "void xproj_kernel<F"): 0.5,
                              ("texture.query", "aten::copy_"): 4.0,
                              ("recon.hierarchy", "void mlp_kernel<F"): 9.0})
    cell.span_readings = r
    ctx = types.SimpleNamespace(cell=cell, window=None, trace=None)
    side = cell.config["profile"]["hierarchy"]["resolutions"][-1]
    bound = work.bound_s(work.ray_mlp_work(
        cell.config["netC"]["head"]["widths"], side * side, 1, op_bytes=4,
        peak=work.PEAK_F32))
    reader = Manifest.reader("kernel1.f32.roofline")
    assert reader.read(ctx) == pytest.approx(100.0 * bound / 1e-3, rel=1e-12)
    r.op_ms = {("recon.hierarchy", "void mlp_kernel<F"): 9.0}
    assert reader.read(ctx) is None

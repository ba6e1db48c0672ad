"""The served demo's cell on the CPU at small sizes: the plain references
of its segment stage, floor and JPEG against the port's, the look-up of
a traffic mix's cell class, a ``ServeCell`` run end to end (frames
served, the client's parts, every share computed), and ``correct``
coming out false for the control and for faults planted where the served
frame is produced.

The port's scene takes the floor prop's uvs from the wrong output of its
OBJ reader, so its floor shows one texel (PERF.md, Open questions); the
runs that must come out correct draw the floor from the reader's uvs
(``floor_from_obj_uvs``), as the reference does."""

import copy
import json
import os
import time

import numpy as np
import pytest
import torch

import monoport_tpu_torch.engine as engine_mod
from cardbench import run as bench_run
from cardbench.harness import program, traffic, weights
from cardbench.harness.cell import Cell
from cardbench.harness.manifest import ROOT, Manifest
from cardbench.harness.serve import ServeCell
from cardbench.reference.floor import Floor
from cardbench.reference.frame import control_nets, load_nets
from cardbench.reference.jpeg import decode_jpeg
from cardbench.reference.segmentation import Segmenter, detect
from cardbench.reference.served import ServedFrame
from monoport_tpu_torch.pipeline import jpeg as jpeg_mod
from monoport_tpu_torch.pipeline import scene as scene_mod
from monoport_tpu_torch.pipeline.segmentation import Segmentation

SEED = 3_900_000_017
WORKLOAD = "hg4-serve"
CONFIG = {
    "name": "monoport-hg4-rtl",
    "source": "https://github.com/Project-Splinter/MonoPort",
    "file": "cardbench/configs/monoport-hg4-rtl.json", "reduced": [],
    "why": "the served demo"}
CELL = {"name": WORKLOAD, "config": "monoport-hg4-rtl", "traffic": "serve",
        "chips": 1, "why": "the served demo"}


def stated() -> dict:
    """The served configuration as its file states it."""
    with open(os.path.join(ROOT, CONFIG["file"])) as fh:
        return json.load(fh)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class ServeManifest(Manifest):
    """The repository's manifest with the served cell, its configuration
    at 64^2 frames and a small real-time profile in f32 (the committed
    nets at their widths; the scene at its 256^2), two bodies, four
    warm-up frames."""

    def __init__(self):
        super().__init__()
        if all(w["name"] != WORKLOAD for w in self.data["workloads"]):
            self.data["configs"].append(CONFIG)
            self.data["workloads"].append(CELL)

    def config(self, name: str) -> dict:
        c = copy.deepcopy(super().config(name))
        if name == CONFIG["name"]:
            c["image_size"] = 64
            c["profile"].update(compute_dtype="float32", fine_res=33,
                                window=24, march_levels=[9, 17])
            c["profile"]["hierarchy"].update(resolutions=[5, 9, 17],
                                             budgets=[0, 512, 2048])
        return c

    def traffic(self, name: str) -> dict:
        spec = dict(Manifest.traffic(name))
        if spec.get("driver") == "serve":
            spec.update(bodies=2, warm_up_frames=4)
        return spec


def _load_floor_from_obj_uvs(mesh_path, texture, floor_size=3.0,
                             floor_center=(0.0, -0.9, 0.0)):
    from monoport_tpu_torch.utils.mesh import load_obj_mesh

    verts, faces, uvs, face_uvs = load_obj_mesh(mesh_path, with_texture=True)
    verts = verts[:, [0, 2, 1]] / 150.0 * floor_size
    verts = verts - verts.mean(axis=0) + np.asarray(floor_center, np.float32)
    return (verts[faces.reshape(-1)], uvs[face_uvs.reshape(-1)][:, :2],
            texture)


@pytest.fixture
def floor_from_obj_uvs(monkeypatch):
    monkeypatch.setattr(scene_mod, "load_floor", _load_floor_from_obj_uvs)


def _run(seconds=3.0):
    res, _ = bench_run.run(ServeManifest(), WORKLOAD, SEED, seconds, False,
                           device="cpu", t_start=time.perf_counter())
    return res


def _bodies(size, n=3):
    spec = Manifest.traffic("frontal")
    return traffic.generate(spec, SEED, size, "cpu").images[:n] * 0.5 + 0.5


# -- the references ------------------------------------------------------
@pytest.mark.parametrize("size", (64, 128))
def test_reference_segmenter_against_the_port(size):
    config = stated()["serve"]
    ref = Segmenter(f"{ROOT}/{config['mattenet']}",
                    f"{ROOT}/{config['detectnet']}", "cpu")
    seg = Segmentation.load_default(device="cpu")
    images = _bodies(size)
    segm, _, _ = seg(images)
    assert float((ref(images) - segm[..., 3]).abs().max()) < 1e-4
    boxes, scores = detect(ref.det, ref.det_meta, images * 2.0 - 1.0)
    want_boxes, want_scores = seg.detector(images)
    torch.testing.assert_close(boxes, want_boxes, rtol=0, atol=1e-3)
    torch.testing.assert_close(scores, want_scores, rtol=0, atol=1e-5)


def test_reference_jpeg_decodes_the_served_encoder():
    rng = np.random.default_rng(SEED)
    y, x = np.mgrid[:32, :32]
    smooth = np.stack([4 * x, 4 * y, 2 * (x + y)], -1)
    img = np.clip(smooth + rng.normal(0, 6, smooth.shape), 0, 255).astype(
        np.uint8)
    err = {q: np.abs(decode_jpeg(jpeg_mod.encode_jpeg(img, q)).astype(int)
                     - img) for q in (95, 50)}
    assert decode_jpeg(jpeg_mod.encode_jpeg(img)).shape == (32, 32, 3)
    # the noise's chroma is what quality 95 quantises most (mean ~3 steps)
    assert err[95].mean() < 4.0 and np.percentile(err[95], 99) <= 13
    assert err[50].mean() > 1.3 * err[95].mean()
    data = jpeg_mod.encode_jpeg(img)
    for cut in (len(data) // 2, len(data) - 2):
        with pytest.raises(ValueError):
            decode_jpeg(data[:cut])


def test_reference_floor_against_the_scene():
    """The port's scene covers the reference floor's pixels; the port's
    rasterizer fed the OBJ reader's uvs draws the reference's colours."""
    config = stated()
    config["serve"]["size"] = 64
    serve = config["serve"]
    tex = np.load(f"{ROOT}/{serve['floor_texture']}")[serve["floor"]]
    floor = Floor(f"{ROOT}/{serve['floor_obj']}", tex, 64, "cpu")
    scene = scene_mod.MonoPortScene(size=(64, 64), device="cpu")
    witness = program.served_floor_witness(config, "cpu")
    for _ in range(5):
        ext, intr = scene.update_camera()
        ext = np.array(ext)
        want = floor.render(ext, intr)
        got = scene.render(ext, intr)
        assert torch.equal(got.sum(-1) > 0, want.sum(-1) > 0)
        assert float((witness(ext, intr) - want).abs().max()) < 1e-5


def test_load_networks_loads_the_states_the_reference_gets():
    from monoport_tpu_torch.apps import rtl_main

    config = stated()
    _, cfg = program.served_config(config)
    nets = rtl_main.load_networks(cfg, "cpu")
    states = weights.states(config, SEED, "cpu")
    for key, net in zip(("netG", "netC"), nets):
        got = net.state_dict()
        assert set(got) == set(states[key])
        for name, value in states[key].items():
            assert torch.equal(got[name].float(), value), name


def test_every_traffic_file_names_its_cell():
    manifest = ServeManifest()
    for w in manifest.data["workloads"]:
        spec = manifest.traffic(w["traffic"])
        want = ServeCell if w["name"] == WORKLOAD else Cell
        assert bench_run.driver(spec) is want, w["name"]


# -- the cell --------------------------------------------------------------
def test_serve_cell_serves_and_compares(floor_from_obj_uvs):
    cell = ServeCell(ServeManifest(), WORKLOAD, SEED, "cpu")
    cell.setup()
    cell.warm_up()
    cell.prepare_sample(3.0)
    win = cell.window(3.0)
    cell.free_program()
    assert win.frames > 0 and win.elapsed > 0
    assert win.client_parts >= 1
    assert set(win.stages) == {"segment", "device_frame", "composite"}
    assert len(win.jpeg_ms) == win.frames
    frames = cell.checked(win)
    per_frame = cell.compare(win, frames, cell.reference())
    assert frames and len(per_frame) == len(frames)
    for share in ("valid_disagree", "depth_bad", "norm_bad", "tex_bad",
                  "alpha_bad", "served_bad", "floor_bad", "jpeg_bad"):
        assert sum(f[share][1] for f in per_frame) > 0, share
    assert all(f["calib_gap"] < 1e-5 for f in per_frame)


def test_sound_run_is_correct(floor_from_obj_uvs):
    res = _run()
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


def test_the_port_floor_fails_the_floor_share_alone():
    res = _run()
    checks = res["checks"]
    assert checks["floor_bad"]["value"] > checks["floor_bad"]["limit"]
    assert all(c["value"] <= c["limit"] for k, c in checks.items()
               if k != "floor_bad"), checks


def test_control_in_the_engines_place(monkeypatch, floor_from_obj_uvs):
    """The configuration's control (its full-size file's: fp8 under bf16)
    answers every device frame in the engine's place."""
    full = stated()

    def control_frame(self, image_g, image_c=None, calib=None,
                      compact_hint=None):
        if not hasattr(self, "_control"):
            small = ServeManifest().config("monoport-hg4-rtl")
            nets = load_nets(small, weights.states(small, SEED, "cpu"),
                             "cpu")
            self._control = ServedFrame(small, control_nets(full, nets),
                                        ROOT, "cpu").frame
        out = dict(self._control(image_g, image_c, calib, compact_hint))
        out["mask"] = ~(out["render_tex"] >= 1.0).all(-1, keepdim=True)
        return out

    monkeypatch.setattr(engine_mod.ReconEngine, "frame", control_frame)
    res = _run()
    assert not res["correct"], res["checks"]


def test_altered_answers(monkeypatch, floor_from_obj_uvs):
    """Every head's occupancy moved by 0.2 where the kernels produce it."""
    for name in ("apply_ray", "apply_mlp", "apply_anchor"):
        fn = getattr(engine_mod, name)
        monkeypatch.setattr(engine_mod, name,
                            lambda *a, fn=fn: fn(*a) + 0.2)
    res = _run()
    assert not res["correct"], res["checks"]


def test_stale_frame(monkeypatch, floor_from_obj_uvs):
    """The engine answers every frame with its first frame's outputs."""
    frame = engine_mod.ReconEngine.frame

    def stale(self, *a, **kw):
        out = frame(self, *a, **kw)
        if not hasattr(self, "_first"):
            self._first = {k: v.clone() for k, v in out.items()}
        return dict(self._first)

    monkeypatch.setattr(engine_mod.ReconEngine, "frame", stale)
    res = _run()
    assert not res["correct"], res["checks"]


def test_matte_altered(monkeypatch, floor_from_obj_uvs):
    """The segment stage's alpha scaled by 0.9 where it is produced."""
    call = Segmentation.__call__

    def scaled(self, images, scaled_boxes=None):
        segm, bbox, probs = call(self, images, scaled_boxes)
        return torch.cat([segm[..., :3], segm[..., 3:] * 0.9], -1), bbox, probs

    monkeypatch.setattr(Segmentation, "__call__", scaled)
    res = _run()
    checks = res["checks"]
    assert checks["alpha_bad"]["value"] > checks["alpha_bad"]["limit"]


def test_jpeg_coded_less(monkeypatch, floor_from_obj_uvs):
    """The served JPEG coded at quality 50 where it is produced."""
    from monoport_tpu_torch.apps import rtl_main

    encode = jpeg_mod.encode_jpeg
    monkeypatch.setattr(rtl_main, "encode_jpeg",
                        lambda rgb, quality=95: encode(rgb, 50))
    res = _run()
    checks = res["checks"]
    assert checks["jpeg_bad"]["value"] > checks["jpeg_bad"]["limit"]

"""PyTorch port, the demo apps: ``apps/rtl_main`` (CLI, the 3-stage
pipeline, the packed display, the MJPEG server), ``apps/run_camera`` and
``apps/infer`` against the JAX package's apps, headless on the CPU.

The small runs use the JAX test's small netG (1 stack, 1 hourglass, width
32) with JAX-initialised weights carried across through the weights bridge
(both packages' ``load_networks`` monkeypatched to them), the committed
MatteNet and DetectNet, and the 512^2 frames the streamers make of small
JPEGs. Tolerances: segm's rgb within 1e-6 and its 512^2 matte within 1e-3
(both packages' f32 GroupNorm moments over 512^2 pixels a group; see
tests/test_torch_perception.py), calib equal, the packed display's
uint8 planes within 1 (a render within 1e-5 may truncate to the next
level) on all but 2% of the pixels (measured 0.77%: the mattes' 1e-3
moves rays that a random-init net puts on the 0.5 knife edge, as in
tests/test_torch_engine.py).

The serve golden: ``python tests/test_torch_app.py --write`` runs the JAX
app's stages in f32 (CPU, matmul precision "highest") on the committed
weights for one raw 512^2 capsule frame (the held-out render of
tests/test_trained_pipeline.py, as uint8 the way a camera gives it) and
stores the frame, the matte, the segmenter's and detector's boxes, the
calib of the first AUTO pose, the frame's depth / valid, the packed
display and the served composite in
``monoport_tpu_torch/data/serve_golden.npz``. The slow test holds the
port's f32 CPU stages to it; ``chip_smoke.py`` holds the card's served
bf16 frame to it.
"""

import os
import sys

import cv2
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

from monoport_tpu_torch import frame_check  # noqa: E402

torch.set_num_threads(2)
# pixels of the small frame's packed display more than one uint8 step off:
# the mattes differ by up to 1e-3, and a random-init net puts its rays on
# the occupancy's knife edge (measured 0.77%)
DISPLAY_FLIPS = 0.02
SMALL_G = ["netG.backbone.num_stack", "1", "netG.backbone.num_hourglass", "1",
           "netG.backbone.hourglass_dim", "32"]
SMALL_RECON = ["recon.resolutions", "[9,17,33]", "recon.budgets",
               "[0,2048,8192]"]


def capsule_frame() -> np.ndarray:
    """The raw 512^2 capsule frame: the held-out render in [0, 1] as uint8."""
    import jax

    from monoport_tpu.training.datasets.capsule import (render_front,
                                                        skeleton3d)
    image, _ = render_front(skeleton3d(jax.random.PRNGKey(4242)), 512)
    raw = np.asarray(image, np.float64) * 0.5 + 0.5
    return np.clip(np.round(raw * 255.0), 0, 255).astype(np.uint8)


def write_serve_golden(path: str = frame_check.GOLDEN_SERVE) -> dict:
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    from monoport_tpu.apps import rtl_main as J
    from monoport_tpu.pipeline.segmentation import Segmentation

    frame_u8 = capsule_frame()
    frame = frame_u8.astype(np.float32) / 255.0
    args, cfg = J.parse_args(["--camera", "--", "tpu.compute_dtype",
                              "float32"])
    pipeline = J.build_pipeline(args, cfg, J.FrameState())
    pipeline.source = [frame]
    d = next(iter(pipeline))
    pipeline.close()
    seg = Segmentation.load_default()
    segm, bbox, probs = seg(jnp.asarray(frame[None]))
    person = seg.detector.person_box(jnp.asarray(frame[None]),
                                     fallback=seg.default_box[0])
    plan = pipeline.engine._rot_anchor_plan(d["calib"], 512)
    golden = {
        "frame": frame_u8,
        "segm_alpha": np.asarray(segm[0, ..., 3], np.float32),
        "bbox": np.asarray(bbox[0], np.float32),
        "probs": np.asarray(probs, np.float32),
        "person_box": np.asarray(person[0], np.float32),
        "calib": np.asarray(d["calib"], np.float32),
        "extrinsic": np.asarray(d["extrinsic"], np.float32),
        "depth": np.asarray(d["depth"], np.float32),
        "valid": np.asarray(d["valid"], bool),
        "display_packed": np.asarray(d["display_packed"], np.uint8),
        "served": (d["window_server"] * 255).astype(np.uint8),
        "anchor_plan": np.asarray([k or 0 for k in plan], np.int32),
        "compact_dropped": np.asarray(d["compact_dropped"], np.int32)}
    np.savez_compressed(path, **golden)
    return golden


def _tree(node):
    return {k: _tree(v) if hasattr(v, "items") else v
            for k, v in node.items()}


@pytest.mark.parametrize("argv", [
    [],
    ["--camera", "--port", "7777", "--", "learning_rate", "0.5"],
    ["--images", "a.png", "b.png", "--loop", "--", "recon.fine_res", "129",
     "tpu.compute_dtype", "float32"],
    ["-cfg", "configs/quality.yaml", "--camera"],
    ["-cfg", "configs/rtl.yaml", "--camera", "--", "recon.ray_taps", "4"],
])
def test_parse_args_matches_jax(argv):
    """The same arguments and the same config tree as the JAX app's (the
    literal '--' convention, the demo profile, config files)."""
    from monoport_tpu.apps.rtl_main import parse_args as jparse
    from monoport_tpu_torch.apps.rtl_main import parse_args as tparse

    root = os.path.join(os.path.dirname(__file__), os.pardir)
    argv = [os.path.join(root, a) if a.startswith("configs/") else a
            for a in argv]
    ja, jc = jparse(argv)
    ta, tc = tparse(argv)
    assert _tree(tc) == _tree(jc)
    assert {**vars(ta), "device": None} == {**vars(ja), "device": None}
    assert ta.device is None


@pytest.fixture()
def frames_dir(tmp_path):
    rng = np.random.RandomState(0)
    for i in range(3):
        img = (rng.rand(64, 48, 3) * 255).astype(np.uint8)
        img[16:48, 12:36] = [200, 150, 120]          # a "person" blob
        cv2.imwrite(str(tmp_path / f"f{i}.jpg"), img)
    return str(tmp_path)


def test_run_camera_headless(frames_dir):
    from monoport_tpu_torch.apps.run_camera import main
    assert main(["--image_folder", frames_dir, "--max_frames", "2",
                 "--device", "cpu"]) == 2


@pytest.fixture(scope="module")
def small_g():
    """The JAX test's small netG, initialised by JAX, as both packages'
    networks: (JAX module, JAX params, port module)."""
    import jax
    import jax.numpy as jnp

    from monoport_tpu.apps.rtl_main import parse_args as jparse
    from monoport_tpu.models import MonoPortNet as JaxNet
    from monoport_tpu_torch import weights

    _, cfg = jparse(["--camera", "--"] + SMALL_G)
    net = JaxNet(cfg.netG)
    params = net.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                      jnp.zeros((1, 64, 3)), jnp.eye(4)[None])
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        params["params"])
    # a crisp field: the last layer x 1000 saturates the occupancy away
    # from its zero crossing (a random net's is ~0.5 everywhere)
    head = tree["surface_classifier"]
    last = head[f"filters_{len(head) - 1}"]
    last["kernel"], last["bias"] = last["kernel"] * 1e3, last["bias"] * 1e3
    params = {"params": jax.tree.map(jnp.asarray, tree)}
    from monoport_tpu_torch.apps.rtl_main import parse_args as tparse
    _, tcfg = tparse(["--camera", "--"] + SMALL_G)
    return net, params, weights.build_net(tcfg.netG, tree, device="cpu")


def _patch_networks(monkeypatch, small_g):
    from monoport_tpu.apps import rtl_main as J
    from monoport_tpu_torch.apps import rtl_main as P

    jnet, params, tnet = small_g
    monkeypatch.setattr(J, "load_networks",
                        lambda cfg: (jnet, params, None, None))
    monkeypatch.setattr(P, "load_networks",
                        lambda cfg, device=None: (tnet, None))
    return J, P


def test_rtl_main_headless_matches_jax(frames_dir, small_g, monkeypatch):
    """Two frames through both apps: the first frame's segm, calib and
    packed display agree; the port serves a JPEG of the composite."""
    J, P = _patch_networks(monkeypatch, small_g)
    argv = ["--image_folder", frames_dir, "--max_frames", "2", "--",
            *SMALL_RECON, "recon.fine_res", "65", "recon.ray_taps", "4",
            *SMALL_G]
    want = []
    build = J.build_pipeline

    def capture(*a, **k):
        pipeline = build(*a, **k)
        last = pipeline.processors[-1]
        pipeline.processors[-1] = lambda d: want.append(last(d)) or want[-1]
        return pipeline
    monkeypatch.setattr(J, "build_pipeline", capture)
    args, cfg = J.parse_args(argv)
    assert J.main_loop(args, cfg, J.FrameState()) == 2
    got = []
    args, cfg = P.parse_args(["--device", "cpu"] + argv)
    state = P.FrameState()
    assert P.main_loop(args, cfg, state, on_frame=got.append) == 2
    assert state.pipeline.stats[-1].frames == 2
    w, g = want[0], got[0]
    segm, segm_w = g["segm"].numpy(), np.asarray(w["segm"])
    np.testing.assert_allclose(segm[..., :3], segm_w[..., :3], atol=1e-6)
    np.testing.assert_allclose(segm[..., 3], segm_w[..., 3], atol=1e-3)
    np.testing.assert_array_equal(g["calib"], w["calib"])
    packed_w = np.asarray(w["display_packed"]).astype(int)
    diff = np.abs(g["display_host"].astype(int) - packed_w)
    assert g["display_host"].shape == (256, 256, 8)
    assert (diff.max(axis=-1) > 1).mean() < DISPLAY_FLIPS, diff.max()
    assert packed_w[..., 6].mean() > 10              # the random net hits
    jpg = cv2.imdecode(np.frombuffer(state.latest_jpeg, np.uint8),
                       cv2.IMREAD_COLOR)
    assert jpg.shape == (256, 256, 3)
    served_w = (w["window_server"] * 255).astype(int)
    served = g["window_server"].astype(int)
    assert (np.abs(served - served_w).max(axis=-1) > 1).mean() \
        < DISPLAY_FLIPS


def test_infer_mesh_matches_jax(frames_dir, small_g, monkeypatch, tmp_path):
    """Single image -> mesh through both apps on the small net, the box
    segmenter in both (the mattes' f32 difference, up to 1e-3 at 512^2,
    moves the random net's surface): the same face count, from the
    hierarchy and from the dense 33^3 grid."""
    import glob

    from monoport_tpu.apps import infer as jinfer
    from monoport_tpu.pipeline.segmentation import Segmentation as JSeg
    from monoport_tpu_torch.apps import infer as tinfer
    from monoport_tpu_torch.pipeline.segmentation import Segmentation as TSeg
    from monoport_tpu_torch.utils import mesh as tmesh

    _patch_networks(monkeypatch, small_g)
    monkeypatch.setattr(jinfer.Segmentation, "load_default",
                        classmethod(lambda cls: JSeg()))
    monkeypatch.setattr(tinfer.Segmentation, "load_default",
                        classmethod(lambda cls, device=None: TSeg(
                            device=device)))
    img = sorted(glob.glob(frames_dir + "/*.jpg"))[0]
    out = str(tmp_path / "mesh.obj")
    for extra in ([], ["--dense", "--resolution", "33"]):
        opts = ["--image", img, "--max_cells", "8192", *extra, "--",
                *SMALL_RECON, *SMALL_G]
        jf = jinfer.reconstruct(*jinfer.parse_args(opts))[1]
        # the exported OBJ's faces (main: reconstruct, then save)
        n_verts = tinfer.main(["--device", "cpu", "--out", out] + opts)
        verts, faces = tmesh.load_obj_mesh(out)
        assert len(jf) > 100 and len(verts) == n_verts
        assert len(faces) == len(jf), extra


def test_load_networks_rules(monkeypatch, tmp_path, caplog):
    """A checkpoint on disk loads (a legacy PIFu state dict, converted);
    a missing one warns; the default architecture loads the committed
    nets; another gets seeded random init and no netC."""
    from monoport_tpu_torch.apps.rtl_main import load_networks, parse_args
    from monoport_tpu_torch.convert import load_legacy_pifu

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_reference_state import reference_state

    _, cfg = parse_args(["--camera", "--"] + SMALL_G)
    g1, c1 = load_networks(cfg, device="cpu")
    ckpt = tmp_path / "net_G"
    torch.save(reference_state(g1.state_dict(), "PIFuHGFilters"), ckpt)
    _, cfg = parse_args(["--camera", "--", "netG.ckpt_path", str(ckpt)]
                        + SMALL_G)
    gk, ck = load_networks(cfg, device="cpu")
    assert ck is None
    assert gk.state_dict().keys() == g1.state_dict().keys()
    for k, v in load_legacy_pifu(str(ckpt), "PIFuHGFilters").items():
        assert torch.equal(gk.state_dict()[k], v), k
    _, cfg = parse_args(["--camera", "--", "netG.ckpt_path",
                         str(tmp_path / "missing")])
    with caplog.at_level("WARNING"):
        g0, c0 = load_networks(cfg, device="cpu")
    assert "not found on disk" in caplog.text
    assert "committed capsule netG" in caplog.text and c0 is not None
    _, cfg = parse_args(["--camera", "--"] + SMALL_G)
    g2, _ = load_networks(cfg, device="cpu")
    assert c1 is None
    for a, b in zip(g1.parameters(), g2.parameters()):
        assert torch.equal(a, b)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_networks(cfg)


def test_mjpeg_server_answers():
    """The handler on 127.0.0.1:0: '/' is the landing page, '/video_feed'
    a multipart stream whose part is the state's JPEG."""
    import http.client
    import threading

    from monoport_tpu_torch.apps.rtl_main import FrameState, make_server
    from monoport_tpu_torch.pipeline.jpeg import encode_jpeg

    state = FrameState()
    state.latest_jpeg = encode_jpeg(np.full((16, 24, 3), 200, np.uint8))
    server = make_server(state, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.server_address[1]
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        conn.request("GET", "/")
        res = conn.getresponse()
        assert res.status == 200 and b"/video_feed" in res.read()
        conn.close()
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        conn.request("GET", "/video_feed")
        res = conn.getresponse()
        assert res.status == 200
        assert "boundary=frame" in res.getheader("Content-Type")
        parts = [read_part(res) for _ in range(2)]
        conn.close()
        assert parts == [state.latest_jpeg] * 2
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        conn.request("GET", "/nothing")
        assert conn.getresponse().status == 404
        conn.close()
    finally:
        server.shutdown()
        server.server_close()
    thread.join(timeout=5)
    assert not thread.is_alive()


def read_part(res) -> bytes:
    """One JPEG of a multipart MJPEG response (after the CRLF that ends the
    part before it)."""
    line = res.readline()
    assert (res.readline() if line == b"\r\n" else line) == b"--frame\r\n"
    assert res.readline().lower().startswith(b"content-type: image/jpeg")
    assert res.readline() == b"\r\n"
    data = b""
    while not data.endswith(b"\xff\xd9"):
        data += res.read(1)
    return data


@pytest.mark.slow
def test_cpu_served_frame_matches_serve_golden():
    """The port's f32 stages on the golden's raw frame (full width, the
    demo profile, CPU): the matte, the boxes, the calib and the packed
    display agree with the JAX app's."""
    from monoport_tpu_torch.apps import rtl_main as P

    golden = frame_check.load_golden(frame_check.GOLDEN_SERVE)
    frame = golden["frame"].astype(np.float32) / 255.0
    args, cfg = P.parse_args(["--camera", "--device", "cpu", "--",
                              "tpu.compute_dtype", "float32"])
    threads = torch.get_num_threads()
    torch.set_num_threads(8)
    got = []
    try:
        assert P.main_loop(args, cfg, P.FrameState(), stream=[frame],
                           on_frame=got.append) == 1
    finally:
        torch.set_num_threads(threads)
    d = got[0]
    np.testing.assert_allclose(d["segm"][0, ..., 3].numpy(),
                               golden["segm_alpha"], atol=1e-3)
    np.testing.assert_array_equal(d["bboxes"][0].numpy(), golden["bbox"])
    np.testing.assert_array_equal(d["calib"], golden["calib"])
    res = frame_check.compare_display(d, golden,
                                      frame_check.F32_SERVE_LIMITS)
    assert res["ok"], res
    np.testing.assert_array_equal(d["compact_dropped"].numpy(),
                                  golden["compact_dropped"])


if __name__ == "__main__":
    if sys.argv[1:2] != ["--write"]:
        sys.exit("usage: python tests/test_torch_app.py --write")
    got = write_serve_golden()
    print({k: v.shape for k, v in got.items()})

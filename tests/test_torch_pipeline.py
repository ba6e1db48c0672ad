"""PyTorch port, host pipeline: the threaded runtime (order, overlap, error
names, early close), the streamers on a PNG folder against the JAX
package's, the OBJ readers and vertex normals against the JAX package's
(quads and negative indices included), and the numpy JPEG encoder: cv2
decodes it, its tables are the ones cv2 writes at the same quality, and on
the scene's render its PSNR is no more than 0.5 dB below cv2's at quality
95."""

import os
import sys
import time

import cv2
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

from monoport_tpu.pipeline import streamer as jstream  # noqa: E402
from monoport_tpu.utils import mesh as jmesh  # noqa: E402
from monoport_tpu_torch.pipeline import jpeg  # noqa: E402
from monoport_tpu_torch.pipeline import streamer as tstream  # noqa: E402
from monoport_tpu_torch.pipeline.runtime import Pipeline  # noqa: E402
from monoport_tpu_torch.utils import mesh as tmesh  # noqa: E402

torch.set_num_threads(2)


def test_pipeline_order_and_stats():
    src = list(range(20))
    p = Pipeline(src, [lambda x: x * 2, lambda x: x + 1], max_queue=2)
    assert list(p) == [x * 2 + 1 for x in src]
    assert all(st.frames == 20 for st in p.stats)
    assert all(len(st.recent_ms) == 20 and st.median_ms >= 0
               for st in p.stats)
    assert "latency" in p.report()


def test_pipeline_overlap():
    """Stages run concurrently: total time ~ the slowest stage's, not the
    sum."""
    def slow(x):
        time.sleep(0.02)
        return x

    n = 20
    t0 = time.perf_counter()
    out = list(Pipeline(range(n), [slow, slow], max_queue=2))
    assert out == list(range(n))
    assert time.perf_counter() - t0 < n * 0.04 * 0.8


def test_pipeline_error_propagates_with_stage_name():
    def boom(x):
        if x == 3:
            raise ValueError("bad frame")
        return x

    boom.__name__ = "boom_stage"
    with pytest.raises(RuntimeError, match="boom_stage") as info:
        list(Pipeline(range(10), [boom]))
    assert isinstance(info.value.__cause__, ValueError)


def test_pipeline_early_close():
    p = Pipeline(range(1000000), [lambda x: x], max_queue=2)
    it = iter(p)
    assert next(it) == 0
    p.close()                                         # must not hang
    assert not any(t.is_alive() for t in p._threads)


def test_streamers_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    for i, shape in enumerate([(64, 48, 3), (40, 90, 3), (32, 32, 3)]):
        img = (rng.rand(*shape) * 255).astype(np.uint8)
        cv2.imwrite(str(tmp_path / f"f{i}.png"), img)
    for kw in ({"image_folder": str(tmp_path)},
               {"image_folder": str(tmp_path), "size": 96, "loop": True},
               {"images": [str(tmp_path / "f1.png")]}):
        want = list(jstream.open_stream(**kw))
        got = list(tstream.open_stream(**kw))
        assert len(got) == len(want) >= 1
        for a, b in zip(got, want):
            assert a.dtype == np.float32 and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="no input source"):
        tstream.open_stream()


def _obj(path, text):
    with open(path, "w") as f:
        f.write(text)
    return str(path)


def test_obj_readers_match_jax(tmp_path):
    quads = _obj(tmp_path / "q.obj",
                 "# quads, negative indices, uvs and normals\n"
                 "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0.5 0.5 1\n"
                 "vt 0 0\nvt 1 0 0\nvt 1 1\nvt 0 1\n"
                 "vn 0 0 1\nvn 0 1 0\n"
                 "f 1/1/1 2/2/1 3/3/1 4/4/1\nf -4/-3/-2 -3/-2/-2 -1/-1/-1\n"
                 "f 5 1 2\n")
    for kw in ({}, {"with_texture": True}, {"with_normal": True},
               {"with_normal": True, "with_texture": True}):
        path = quads if "with_texture" not in kw else _obj(
            tmp_path / "t.obj", "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
            "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
            "f 1/1 2/2 3/3 4/4\nf -4/-4 -2/-2 -1/-1\n")
        got, want = tmesh.load_obj_mesh(path, **kw), jmesh.load_obj_mesh(
            path, **kw)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tmesh.load_obj_mesh(quads)[1][:3],
                                  [[0, 1, 2], [0, 2, 3], [1, 2, 4]])
    colored = _obj(tmp_path / "c.obj", "v 0 0 0 1 0 0\nv 1 0 0\n"
                   "v 1 1 0 0 0.5 1\nv 0 1 0 0 1 0\nf 1 2 3 4\nf -1 -2 -3\n")
    for a, b in zip(tmesh.load_obj_mesh_with_color(colored),
                    jmesh.load_obj_mesh_with_color(colored)):
        np.testing.assert_array_equal(a, b)


def test_obj_roundtrip_and_normals_match_jax(tmp_path):
    rng = np.random.RandomState(2)
    verts = rng.randn(40, 3).astype(np.float32)
    faces = rng.randint(0, 40, (60, 3)).astype(np.int64)
    colors = rng.rand(40, 3).astype(np.float32)
    np.testing.assert_array_equal(tmesh.compute_normal(verts, faces),
                                  jmesh.compute_normal(verts, faces))
    tmesh.save_obj_mesh_with_color(str(tmp_path / "a.obj"), verts, faces,
                                   colors)
    v, c, f = tmesh.load_obj_mesh_with_color(str(tmp_path / "a.obj"))
    np.testing.assert_allclose(v, verts, atol=1e-6)
    np.testing.assert_allclose(c, colors, atol=1e-6)
    np.testing.assert_array_equal(f, faces)


def _psnr(a, b):
    err = ((a.astype(np.float64) - b.astype(np.float64)) ** 2).mean()
    return 10 * np.log10(255.0 ** 2 / max(err, 1e-12))


def _segments(data: bytes) -> dict:
    """Marker -> payloads of a JPEG's header segments (up to SOS)."""
    segs, i = {}, 2
    while i < len(data):
        marker = data[i + 1]
        n = int.from_bytes(data[i + 2:i + 4], "big")
        segs.setdefault(marker, []).append(data[i + 4:i + 2 + n])
        i += 2 + n
        if marker == 0xDA:
            break
    return segs


def _scene_image() -> np.ndarray:
    """The floor scene's render at the served size, with a smooth subject
    over it: what the demo serves."""
    from monoport_tpu_torch.pipeline.scene import MonoPortScene

    scene = MonoPortScene(size=(256, 256), device="cpu")
    ext, intr = scene.update_camera()
    img = scene.render(ext, intr).numpy()
    yy, xx = np.mgrid[0:256, 0:256] / 255.0
    blob = ((xx - 0.5) ** 2 / 0.04 + (yy - 0.45) ** 2 / 0.12) < 1
    img[blob] = np.stack([0.8 * xx, 0.5 + 0.3 * yy, 0.4 + 0 * xx],
                         -1)[blob]
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def test_jpeg_decodes_and_keeps_cv2_quality():
    img = _scene_image()
    enc = jpeg.encode_jpeg(img)
    assert enc[:2] == b"\xff\xd8" and enc[-2:] == b"\xff\xd9"
    sof = _segments(enc)[0xC0][0]
    assert (int.from_bytes(sof[1:3], "big"), int.from_bytes(sof[3:5], "big"),
            sof[5]) == (256, 256, 3)
    dec = cv2.imdecode(np.frombuffer(enc, np.uint8), cv2.IMREAD_COLOR)
    assert dec.shape == (256, 256, 3)
    ok, ref = cv2.imencode(".jpg", img[..., ::-1])
    assert ok
    ref_dec = cv2.imdecode(ref, cv2.IMREAD_COLOR)
    ours, theirs = _psnr(dec[..., ::-1], img), _psnr(ref_dec[..., ::-1], img)
    assert ours >= theirs - 0.5, (ours, theirs)


@pytest.mark.parametrize("quality", [95, 75, 30])
def test_jpeg_tables_are_cv2s(quality):
    """The quantization tables at a quality and the four Huffman tables are
    byte for byte those of cv2's JPEG at that quality."""
    img = _scene_image()[:64, :48]
    ok, ref = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality])
    theirs = _segments(ref.tobytes())
    ours = _segments(jpeg.encode_jpeg(img, quality))
    assert b"".join(ours[0xDB]) == b"".join(theirs[0xDB])

    def tables(payloads):
        out, data, i = {}, b"".join(payloads), 0
        while i < len(data):
            n = 17 + sum(data[i + 1:i + 17])
            out[data[i]] = data[i:i + n]
            i += n
        return out
    assert tables(ours[0xC4]) == tables(theirs[0xC4])
    dec = cv2.imdecode(np.frombuffer(jpeg.encode_jpeg(img, quality),
                                     np.uint8), cv2.IMREAD_COLOR)
    assert dec.shape == (64, 48, 3)


def test_jpeg_odd_sizes_and_extremes():
    """Sizes off the 8-pixel grid, flat and saturated images, noise (0xFF
    bytes stuffed), and a pure (7, 7) cosine: 62 zeros before the 64th
    coefficient (three ZRLs, no EOB). cv2 decodes each close to the
    source."""
    rng = np.random.RandomState(3)
    basis = np.outer(jpeg._DCT[7], jpeg._DCT[7])
    cosine = np.tile(128 + 60 * 8 * basis, (2, 2))[..., None].repeat(3, -1)
    cosine = np.round(cosine).astype(np.uint8)
    zz = jpeg.quantized_blocks(cosine)
    assert (zz[:, 0, 63] != 0).all() and not zz[:, 0, 1:63].any()
    for img in (np.zeros((13, 21, 3), np.uint8),
                np.full((16, 8, 3), 255, np.uint8),
                (rng.rand(37, 29, 3) * 255).astype(np.uint8), cosine):
        dec = cv2.imdecode(np.frombuffer(jpeg.encode_jpeg(img), np.uint8),
                           cv2.IMREAD_COLOR)
        assert dec.shape == img.shape
        assert _psnr(dec[..., ::-1], img) > 30
    with pytest.raises(ValueError):
        jpeg.encode_jpeg(np.zeros((8, 8, 3), np.float32))

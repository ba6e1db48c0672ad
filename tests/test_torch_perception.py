"""PyTorch port, perception: MatteNet, DetectNet, ``decode``,
``gaussian_heatmap``, ``person_box``, ``alpha_to_bbox`` and the
``Segmentation`` callable against the JAX package on the CPU, on the
committed weights carried across by the weights bridge.

Tolerances. Logits within 1e-4 of the JAX nets evaluated in f64 (the
JAX functions' exact values). The f32 error of both packages on the CPU is
GroupNorm's moments over 128^2-256^2 pixels a group, summed in f32: JAX's
is up to 2.7e-4 on the capsule render; torch's depends on its thread
count (MatteNet 8.9e-4 at 1 thread, 4.0e-4 at 2, 7.7e-5 at 8), so the net
tests pin 8 threads, as the slow golden frames do. Against JAX's f32:
logits within 5e-4 at 256^2, the 512^2 matte within 1e-3 (that error grows
with the pixels a group), decoded boxes within 5e-3 px (an edge is the
exponential of a size logit times 8 px), segmenter boxes
(integer pixels) equal."""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

from monoport_tpu.pipeline import detection as jdet  # noqa: E402
from monoport_tpu.pipeline import segmentation as jseg  # noqa: E402
from monoport_tpu_torch.pipeline import detection as tdet  # noqa: E402
from monoport_tpu_torch.pipeline import segmentation as tseg  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture()
def threads8():
    kept = torch.get_num_threads()
    torch.set_num_threads(8)
    yield
    torch.set_num_threads(kept)


def _frame(size: int) -> np.ndarray:
    """The held-out capsule render as a raw frame in [0, 1]."""
    from monoport_tpu.training.datasets.capsule import (render_front,
                                                        skeleton3d)
    image, _ = render_front(skeleton3d(jax.random.PRNGKey(4242)), size)
    return (np.asarray(image, np.float32) * 0.5 + 0.5)[None]


@pytest.fixture(scope="module")
def segs():
    return jseg.Segmentation.load_default(), tseg.Segmentation.load_default(
        device="cpu")


@pytest.fixture(scope="module")
def frame256():
    return _frame(256)


def _f64(variables):
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64),
                        variables)


def test_mattenet_matches_jax(segs, frame256, threads8):
    js, ts = segs
    assert ts.net is not None and ts.detector is not None
    got = ts.logits(torch.from_numpy(frame256)).numpy()
    assert got.shape == (1, 256, 256, 1)
    with jax.enable_x64(True):
        exact = np.asarray(js.net.apply(
            _f64(js.variables), jnp.asarray(frame256, jnp.float64) * 2 - 1))
    np.testing.assert_allclose(got, exact, atol=1e-4)
    want = np.asarray(js.net.apply(js.variables,
                                   jnp.asarray(frame256) * 2 - 1))
    np.testing.assert_allclose(got, want, atol=5e-4)


def test_detectnet_matches_jax(segs, frame256, threads8):
    jd, td = segs[0].detector, segs[1].detector
    got = [t.numpy() for t in td.heads(torch.from_numpy(frame256))]
    with jax.enable_x64(True):
        exact = jd.net.apply(_f64(jd.variables),
                             jnp.asarray(frame256, jnp.float64) * 2 - 1)
    want = jd.net.apply(jd.variables, jnp.asarray(frame256) * 2 - 1)
    for g, e, w in zip(got, exact, want):
        assert g.shape == np.shape(w)
        np.testing.assert_allclose(g, np.asarray(e), atol=1e-4)
        np.testing.assert_allclose(g, np.asarray(w), atol=5e-4)
    boxes, probs = td(torch.from_numpy(frame256))
    jb, jp = jd(jnp.asarray(frame256))
    # a box edge is exp(size logit) x stride / 2 (up to ~80 px a logit)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(jb), atol=5e-3)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jp), atol=1e-4)
    assert probs.numpy()[0, 0] > 0.3                  # the subject is found


def _heads(g: int, peaks: dict, seed: int = 0):
    rng = np.random.RandomState(seed)
    heat = np.full((1, g, g, 1), -30.0, np.float32)  # sigmoid -> ~0 exactly
    for (y, x), v in peaks.items():
        heat[0, y, x, 0] = v
    size = rng.uniform(-1, 2, (1, g, g, 2)).astype(np.float32)
    off = rng.uniform(-0.5, 0.5, (1, g, g, 2)).astype(np.float32)
    return heat, size, off


@pytest.mark.parametrize("peaks", [{(3, 5): 4.0}, {},
                                   {(4, 4): 4.0, (4, 5): 3.0, (1, 1): 2.0}])
def test_decode_matches_jax_slot_for_slot(peaks):
    """A planted peak; all-zero scores (every slot a tie: the lowest cell
    indices first, as lax.top_k); adjacent peaks (max-pool suppression)."""
    heat, size, off = _heads(8, peaks)
    want = jdet.decode(*map(jnp.asarray, (heat, size, off)), stride=16,
                       k=4)
    got = tdet.decode(*map(torch.from_numpy, (heat, size, off)), stride=16,
                      k=4)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=1e-6)


def test_gaussian_heatmap_matches_jax():
    args = (np.array([[4.0, 10.3, 2.0]], np.float32),
            np.array([[4.0, 12.6, 0.2]], np.float32),
            np.array([[4.0, 6.0, 1.0]], np.float32),
            np.array([[8.0, 6.0, 3.0]], np.float32),
            np.array([[True, True, False]]))
    want = jdet.gaussian_heatmap(*map(jnp.asarray, args), 16)
    got = tdet.gaussian_heatmap(*map(torch.from_numpy, args), 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_person_box_matches_jax(segs, frame256):
    jd, td = segs[0].detector, segs[1].detector
    both = np.concatenate([frame256, np.full_like(frame256, 0.5)])
    want = jd.person_box(jnp.asarray(both))
    got = td.person_box(torch.from_numpy(both))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-3)
    fb = np.array([10.0, 20.0, 200.0, 220.0], np.float32)
    np.testing.assert_allclose(
        td.person_box(torch.from_numpy(both[1:]), fallback=fb).numpy()[0],
        np.asarray(jd.person_box(jnp.asarray(both[1:]),
                                 fallback=jnp.asarray(fb)))[0], atol=1e-6)


def test_alpha_to_bbox_and_box_prior_match_jax():
    rng = np.random.RandomState(1)
    alpha = rng.rand(3, 20, 24).astype(np.float32) * 0.45
    alpha[0, 5:9, 3:17] = 0.9
    alpha[1, 19, 23] = 0.7
    for a, b in zip(tseg.alpha_to_bbox(torch.from_numpy(alpha)),
                    jseg.alpha_to_bbox(jnp.asarray(alpha))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    box = np.array([[2.0, 3.5, 10.0, 18.0], [0, 0, 23, 19]], np.float32)
    np.testing.assert_array_equal(
        tseg._box_mask(torch.from_numpy(box), 20, 24).numpy(),
        np.asarray(jseg._box_mask(None, jnp.asarray(box), 20, 24)))
    segm, bboxes, probs = tseg.Segmentation(
        scaled_boxes=[10, 5, 50, 60], device="cpu")(torch.full((2, 64, 64, 3),
                                                                0.5))
    assert segm.shape == (2, 64, 64, 4)
    np.testing.assert_allclose(bboxes[0].numpy(), [10, 5, 50, 60])
    assert float(probs[0]) == 1.0


def test_segmentation_end_to_end_matches_jax(segs):
    """One 512^2 capsule render through both segmenters: the detector's
    region, the matte, and the matte's box."""
    js, ts = segs
    frame = _frame(512)
    want = js(jnp.asarray(frame))
    got = ts(torch.from_numpy(frame))
    assert got[0].shape == (1, 512, 512, 4)
    np.testing.assert_allclose(got[0].numpy()[..., :3],
                               np.asarray(want[0])[..., :3], atol=1e-6)
    alpha, alpha_j = got[0].numpy()[..., 3], np.asarray(want[0])[..., 3]
    np.testing.assert_allclose(alpha, alpha_j, atol=1e-3)
    assert (alpha > 0.5).mean() > 0.03                # the subject is matted
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               atol=1e-4)


def test_perception_needs_cuda_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tseg.Segmentation.load_default()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdet.Detection.load_default()

"""PyTorch port, the perception nets' trained-net gates on the CPU: the
committed ``mattenet.npz`` / ``detectnet.npz`` through the port's
``Segmentation`` and ``Detection`` pass the gates of
tests/test_segmentation.py and tests/test_detection.py on the JAX
package's own held-out draws (built by the port's builders), and the
detection app's ``evaluate`` equals the JAX app's on the same batch.
2 torch threads."""

import os
import sys

import numpy as np
import pytest
import torch

import jax

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from monoport_tpu_torch.pipeline import detection as pdet  # noqa: E402
from monoport_tpu_torch.pipeline import segmentation as pseg  # noqa: E402
from monoport_tpu_torch.training import detection as ptd  # noqa: E402
from monoport_tpu_torch.training import matting as ptm  # noqa: E402
from torch_perception_draws import (port_background,  # noqa: E402
                                    port_composites, port_scenes, synth_fn)

torch.set_num_threads(2)
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                    "monoport_tpu", "data")


@pytest.fixture(scope="module")
def seg():
    return pseg.Segmentation(*_committed_matte(), device="cpu")


def _committed_matte():
    params, width = ptm.load_params(os.path.join(DATA, "mattenet.npz"))
    return params, width


@pytest.fixture(scope="module")
def det():
    return pdet.Detection.load_default(device="cpu")


def _iou(a, b):
    if b.sum() == 0:  # person-free frame: correct rejection scores 1
        return 1.0 if a.mean() < 0.01 else 0.0
    return (a & b).sum() / max((a | b).sum(), 1)


FULL = [0.0, 0.0, 511.0, 511.0]


def test_mattenet_iou_at_512(seg):
    """test_segmentation.py: min IOU > 0.8, mean > 0.9 on JAX's held-out
    composites (``PRNGKey(777)``, 4 at 512^2)."""
    images, alpha_gt = port_composites(jax.random.PRNGKey(777), 4, 512)
    segm, _, _ = seg(images, scaled_boxes=FULL)
    alpha = segm[..., 3].numpy()
    gt = alpha_gt.numpy()
    ious = [_iou(alpha[i] > 0.5, gt[i] > 0.5) for i in range(len(gt))]
    assert min(ious) > 0.8, ious
    assert float(np.mean(ious)) > 0.9, ious


def test_mattenet_rejects_background(seg):
    segm, _, _ = seg(port_background(jax.random.PRNGKey(3), 512),
                     scaled_boxes=FULL)
    assert float(segm[..., 3].mean()) < 0.05


def test_bbox_tracks_subject(seg):
    images, alpha_gt = port_composites(jax.random.PRNGKey(9), 2, 512)
    _, bboxes, _ = seg(images, scaled_boxes=FULL)
    want, _ = pseg.alpha_to_bbox(alpha_gt)
    assert float((bboxes - want).abs().max()) < 16.0, (bboxes, want)


def _matched_ious(det, images, gt_boxes, gt_valid):
    boxes, probs = det(images)
    ious = []
    for i in range(images.shape[0]):
        conf = torch.nonzero(probs[i] > 0.3)[:, 0].tolist()
        for j in torch.nonzero(gt_valid[i])[:, 0].tolist():
            cand = [float(ptd.box_iou(boxes[i, m], gt_boxes[i, j]))
                    for m in conf]
            ious.append(max(cand) if cand else 0.0)
    return ious


@pytest.mark.parametrize("size,batch", [(256, 8), (512, 4)])
def test_trained_detector_localizes(det, size, batch):
    """test_detection.py: mean matched IOU > 0.8, min > 0.5 on JAX's
    held-out scenes (``PRNGKey(4242)``) at 256 and at 512."""
    ious = _matched_ious(det, *port_scenes(jax.random.PRNGKey(4242), batch,
                                           size))
    assert ious, "no valid people in the held-out batch"
    assert float(np.mean(ious)) > 0.8, ious
    assert float(np.min(ious)) > 0.5, ious


def test_trained_detector_rejects_background(det):
    bg = torch.cat([port_background(jax.random.PRNGKey(s), 256)
                    for s in (5, 6)])
    _, probs = det(bg)
    assert float(probs.max()) < 0.3, probs


def test_person_box_focuses_subject(det):
    images, gt_boxes, gt_valid = port_scenes(jax.random.PRNGKey(77), 4, 256)
    region = det.person_box(images)
    boxes, probs = det(images)
    for i in range(4):
        conf = torch.nonzero(probs[i] > 0.3)[:, 0].tolist()
        seen = [j for j in torch.nonzero(gt_valid[i])[:, 0].tolist()
                if any(float(ptd.box_iou(boxes[i, m], gt_boxes[i, j])) >= 0.5
                       for m in conf)]
        if not seen:
            continue
        want = gt_boxes[i, seen]
        r = region[i]
        assert r[0] <= want[:, 0].min() + 28 and r[1] <= want[:, 1].min() + 28
        assert r[2] >= want[:, 2].max() - 28 and r[3] >= want[:, 3].max() - 28
    fb = torch.tensor([10.0, 20.0, 200.0, 220.0])
    r = det.person_box(port_background(jax.random.PRNGKey(8), 256),
                       fallback=fb)[0]
    torch.testing.assert_close(r, fb)


def test_evaluate_matches_jax(det, monkeypatch):
    """The detection app's held-out matching (greedy, IOU >= 0.5 at
    confidence 0.3) on JAX's batch against the JAX app's ``evaluate``
    (its batch drawn under jit)."""
    from monoport_tpu.apps import train_detection as japp
    from monoport_tpu.apps.train_detection import evaluate as jevaluate
    from monoport_tpu.utils.params_io import load_params as jload
    from monoport_tpu_torch.apps.train_detection import evaluate

    monkeypatch.setattr(japp, "synth_det_batch",
                        lambda key, b, size: synth_fn("scene", b, size)(key))
    key = jax.random.PRNGKey(10_000)
    params, meta = jload(os.path.join(DATA, "detectnet.npz"))
    want = jevaluate({"params": params}, meta["width"], 256, key,
                     stride=meta["stride"])
    got = evaluate(det.net, *port_scenes(key, 8, 256), stride=det.stride)
    assert set(got) == set(want)
    assert got["iou"] == pytest.approx(want["iou"], abs=1e-4)
    for k in ("precision", "recall", "fp_rate"):
        assert got[k] == want[k], k

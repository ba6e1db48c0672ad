"""PyTorch port, end to end with the committed trained weights (netG +
netC + MatteNet) against the ground truth: the port of
``tests/test_trained_pipeline.py`` at its reduced 129 profile
(``evaluate.reduced_engine``, f32, the CPU), on the JAX package's bodies
committed in ``data/eval_golden.npz``.

Each reading passes the JAX test's quality gate and is also held to the
JAX package's f32 reading of the same frame in the golden: within 0.005
IOU and 0.2 dB, the silhouette within ``frame_check.F32_LIMITS``'s
disagreement (the f32 frame summed in another order)."""

import numpy as np
import pytest
import torch

from monoport_tpu_torch import evaluate, frame_check
from monoport_tpu_torch.training.datasets import superquadric as sq
from monoport_tpu_torch.training.datasets.capsule import render_front

torch.set_num_threads(2)
IOU_TOL = 0.005            # against the JAX golden's reading
PSNR_TOL_DB = 0.2
# the JAX test's cross-family gates (tests/test_trained_pipeline.py:27-29)
FLAT_GATE_DB = 32.2
SHADED_GATE_DB = 29.9
CROSSFAM_GATES = {"sq_flat": (0.90, FLAT_GATE_DB),
                  "sq": (0.89, SHADED_GATE_DB), "ellipsoid": (0.87, None)}


@pytest.fixture(scope="module")
def golden():
    return evaluate.load_golden()


@pytest.fixture(scope="module")
def engine():
    from monoport_tpu_torch.weights import load_default_networks

    netG, netC = load_default_networks(device="cpu")
    return evaluate.reduced_engine(netG, netC, torch.float32, "cpu")


def _check_against_golden(readings, out, valid, iou, psnr):
    got = out["valid"].numpy()
    disagree = (got != valid).sum() / max((got | valid).sum(), 1)
    assert disagree < frame_check.F32_LIMITS.valid_disagree_max, disagree
    assert readings["iou"] == pytest.approx(iou, abs=IOU_TOL)
    if psnr is not None:
        assert readings["psnr"] == pytest.approx(psnr, abs=PSNR_TOL_DB)


def test_trained_engine_reconstructs(golden, engine):
    """Held-out body 4242: silhouette IOU > 0.88 against the analytic
    ground truth (48 z-slices at 129) and texture PSNR > 23 dB (the JAX
    test's gates; JAX measured 0.920 and 23.47 dB)."""
    caps = evaluate.capsule_body(4242, "cpu", golden)
    readings, out = evaluate.frame_readings(
        engine, render_front(caps, 512)[0], evaluate.capsule_occ(caps),
        n_z=48)
    assert out["mask"].sum() > 200
    assert readings["iou"] > 0.88, readings
    assert readings["psnr"] > 23.0, readings
    _check_against_golden(readings, out, golden["trained/valid"],
                          golden["trained/iou"], golden["trained/psnr"])


def test_trained_matting_plus_engine(engine):
    """Segmentation -> engine with trained weights: the matte from
    MatteNet masks the image the engine consumes (RTL/main.py:353-358).
    The masked output keeps the person and zeroes the background, and the
    engine reconstructs a subject from it."""
    from monoport_tpu_torch.pipeline.segmentation import Segmentation
    from monoport_tpu_torch.training.matting import synth_batch

    seg = Segmentation.load_default(device="cpu")
    if seg.net is None:
        pytest.skip("no mattenet checkpoint")
    images, alpha_gt = synth_batch(torch.Generator().manual_seed(6), 1, 512)
    segm, _, _ = seg(images, scaled_boxes=[0., 0., 511., 511.])
    rgb, alpha = segm[..., :3], segm[..., 3:4]
    masked = rgb * (alpha > 0.5)
    gt = alpha_gt[0] > 0.5
    bg_energy = masked[0][~gt].abs().mean()
    fg_energy = masked[0][gt].abs().mean()
    assert fg_energy > 5 * bg_energy, (fg_energy, bg_energy)
    # the engine's input contract: rgb * 2 - 1, background zeroed
    image = (masked * 2.0 - 1.0) * (alpha > 0.5)
    out = engine.frame(image, image)
    assert out["valid"].sum() > 200
    assert torch.isfinite(out["depth"][out["valid"]]).all()
    assert torch.isfinite(out["render_tex"]).all()


@pytest.mark.parametrize("family", list(CROSSFAM_GATES))
def test_trained_crossfam_generalization(golden, engine, family):
    """The committed netG and netC generalize outside their training
    family (seed 31337, the JAX test's gates): a superquadric-limb body,
    flat and shaded (IOU > 0.90 / 0.89, PSNR > 32.2 / 29.9 dB), and the
    PPL fixture's ellipsoid (IOU > 0.87, geometry only). JAX measured
    0.9249 / 0.9100 / 0.8947 and 33.73 / 31.43 dB."""
    iou_gate, psnr_gate = CROSSFAM_GATES[family]
    if family == "ellipsoid":
        image = evaluate.fixture_image("cpu", golden)
        occ, flat = evaluate.ellipsoid_occupancy, False
    else:
        body = evaluate.sq_body(evaluate.BENCH_SEED, "cpu", golden)
        flat = family == "sq_flat"
        image = sq.render_front(body, 512, flat=flat)[0]
        occ = evaluate.sq_occ(body)
    readings, out = evaluate.frame_readings(
        engine, image, occ, n_z=48, flat=flat, texture=psnr_gate is not None)
    print(f"crossfam {family}: {readings}")
    assert readings["iou"] > iou_gate, readings
    if psnr_gate is not None:
        assert readings["psnr"] > psnr_gate, readings
    key = f"crossfam/{family}"
    _check_against_golden(readings, out, golden[f"{key}/valid"],
                          golden[f"{key}/iou_z48"],
                          golden.get(f"{key}/psnr"))

"""Evaluation metrics for occupancy reconstruction (port of
``monoport_tpu/training/metrics.py``): IOU and accuracy of binarised
occupancy on tensors, host-side chamfer / point-to-surface distances, the
eval-mode occupancy metrics of a net on a training-style batch, and the
masked texture PSNR.
"""

from __future__ import annotations

import numpy as np
import torch


def occupancy_iou(pred: torch.Tensor, target: torch.Tensor,
                  threshold: float = 0.5) -> torch.Tensor:
    """IOU of binarized occupancy (any matching shapes)."""
    p = pred > threshold
    t = target > threshold
    inter = (p & t).sum()
    union = (p | t).sum()
    return inter / torch.clamp(union, min=1)


def occupancy_accuracy(pred: torch.Tensor, target: torch.Tensor,
                       threshold: float = 0.5) -> torch.Tensor:
    return ((pred > threshold) == (target > threshold)).float().mean()


def chamfer_distance(points_a: np.ndarray, points_b: np.ndarray,
                     sample: int = 2048, seed: int = 0) -> float:
    """Symmetric chamfer between two point sets (host-side, subsampled)."""
    rng = np.random.RandomState(seed)

    def sub(p):
        if len(p) > sample:
            p = p[rng.choice(len(p), sample, replace=False)]
        return np.asarray(p, np.float32)

    a, b = sub(points_a), sub(points_b)
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    return float(np.sqrt(d2.min(1)).mean() + np.sqrt(d2.min(0)).mean())


def point_to_surface(points: np.ndarray, verts: np.ndarray,
                     sample: int = 2048, seed: int = 0) -> float:
    """Mean distance from sampled points to the nearest mesh vertex."""
    rng = np.random.RandomState(seed)
    if len(points) > sample:
        points = points[rng.choice(len(points), sample, replace=False)]
    d2 = ((points[:, None, :].astype(np.float32)
           - verts[None, :, :].astype(np.float32)) ** 2).sum(-1)
    return float(np.sqrt(d2.min(1)).mean())


@torch.no_grad()
def evaluate_occupancy(net, batch: dict, threshold: float = 0.5) -> dict:
    """Eval-mode metrics of ``net`` (already in eval mode: ``eval_net``)
    on a training-style batch of tensors -> dict of floats."""
    preds = net(batch["images"], batch["points"], batch["calibs"],
                train=False)
    labels = batch["labels"]
    return {
        "iou": float(occupancy_iou(preds, labels, threshold)),
        "accuracy": float(occupancy_accuracy(preds, labels, threshold)),
        "mse": float(torch.mean((preds - labels) ** 2)),
    }


def masked_psnr(pred: np.ndarray, target: np.ndarray,
                mask: np.ndarray) -> tuple[float, float]:
    """(PSNR dB, mean |err|) of two [H, W, C] images in [0, 1] over a
    [H, W] bool mask: the texture-quality metric."""
    err = (np.asarray(pred, np.float64) - np.asarray(target, np.float64))
    err = err[np.asarray(mask)]
    mse = float((err ** 2).mean()) if err.size else 1.0
    return 10.0 * float(np.log10(1.0 / max(mse, 1e-12))), float(
        np.abs(err).mean() if err.size else 1.0)

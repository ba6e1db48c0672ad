"""Camera calibration for the PIFu query space (port copy of
``monoport_tpu/recon/calib.py``; numpy only).

Builds the [4, 4] calib that maps PIFu world coords to the image plane
from the renderer's extrinsic and intrinsic, orthographic-ized (z row
copied from x, translations zeroed), through a Y-flip. Host-side: it runs
once per frame and reaches the device as a small array.
"""

from __future__ import annotations

import numpy as np

_PIFU_MATRIX = np.array([
    [1.0, 0.0, 0.0, 0.0],
    [0.0, -1.0, 0.0, 0.0],
    [0.0, 0.0, 1.0, 0.0],
    [0.0, 0.0, 0.0, 1.0],
])


def pifu_calib(extrinsic: np.ndarray, intrinsic: np.ndarray) -> np.ndarray:
    """-> [1, 4, 4] float32 calibration tensor (batched)."""
    intrinsic = np.array(intrinsic, dtype=np.float64, copy=True)
    intrinsic[2, 2] = intrinsic[0, 0]
    intrinsic[2, 3] = 0.0
    extrinsic = np.array(extrinsic, dtype=np.float64, copy=True)
    extrinsic[2, 3] = 0.0
    calib = np.linalg.inv(intrinsic @ extrinsic @ _PIFU_MATRIX)
    return calib[None].astype(np.float32)

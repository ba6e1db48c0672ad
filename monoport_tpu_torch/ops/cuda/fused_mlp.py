"""Per-point fused MLP: the hand-written Hopper kernel and its plain
version.

``apply_mlp`` replaces ``monoport_tpu/ops/pallas/fused_mlp.py::
_mlp_kernel``, the skip-concat surface-classifier head over any point
batch: ``f(cat[h, x]) = W_h h + W_x x + b`` per layer, leaky-ReLU 0.01
between layers, sigmoid / tanh after the last. It carries the per-point
occupancy query: the dense march of a rotated (free-viewpoint) frame and
every refine level that runs exact per-point.

As in the TPU kernel the whole input row, its z channel included, is
rounded to the compute dtype and multiplied by weights in the compute
dtype; sums and the bias are f32, ``h`` is rounded after each activation,
the output is f32.

The kernel (``csrc/fused_mlp.cu`` over ``csrc/mlp_tiles.cuh``; design and
bound in their headers) is CUDA C++ for sm_90a, built with ``nvcc`` at
first use and bound through ctypes (``build.py``). ``apply_mlp`` launches
it for CUDA tensors and runs ``apply_mlp_plain`` for CPU tensors; any
other device raises, and a failed build or launch raises.
"""

from __future__ import annotations

import torch

from .fused_ray_mlp import (RayMlpPacked, launch_packed, pack_head, pad_feat,
                            run_layers)

LIBRARY = "fused_mlp"


def pack_mlp_params(head, dtype: torch.dtype = torch.bfloat16,
                    device=None) -> RayMlpPacked:
    """The per-point kernel's operands of a ``SurfaceClassifier``: ``wf``
    holds every layer's W_x^T over the whole input (C_in padded to a
    multiple of 32, z its last real column), ``wz`` is zero."""
    return pack_head(head, dtype, device, split_z=False)


def apply_mlp_plain(p: RayMlpPacked, x: torch.Tensor) -> torch.Tensor:
    """Plain-PyTorch version of the kernel, with its rounding points: x
    and the weights rounded to the compute dtype (upcast, so products are
    exact), f32 sums, h rounded after each activation.
    x [B, N, C_in] -> [B, N, out_dim] f32."""
    xp = torch.matmul(pad_feat(p, x).float(), p.wf.float().t())
    return run_layers(p, lambda lo, hi: xp[..., lo:hi] + p.b[lo:hi])


def _launch(p: RayMlpPacked, x: torch.Tensor) -> torch.Tensor:
    b_, n, _ = x.shape
    xr = pad_feat(p, x).reshape(b_ * n, p.widths[0]).contiguous()
    out = launch_packed(LIBRARY, "fused_mlp_forward", p, xr, b_ * n, 1)
    apply_mlp.launches += 1
    return out.reshape(b_, n, p.out_dim)


def apply_mlp(p: RayMlpPacked, x: torch.Tensor) -> torch.Tensor:
    """x [B, N, C_in] -> [B, N, out_dim] f32: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if x.device.type == "cuda":
        return _launch(p, x)
    if x.device.type == "cpu":
        return apply_mlp_plain(p, x)
    raise ValueError(f"the fused MLP kernels have no path for device "
                     f"{x.device}")


apply_mlp.launches = 0

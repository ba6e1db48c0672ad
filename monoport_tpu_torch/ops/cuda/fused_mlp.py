"""Per-point fused MLP: the hand-written Hopper kernel and its plain
version.

``apply_mlp`` replaces ``monoport_tpu/ops/pallas/fused_mlp.py::
_mlp_kernel``, the skip-concat surface-classifier head over any point
batch: ``f(cat[h, x]) = W_h h + W_x x + b`` per layer, leaky-ReLU 0.01
between layers, sigmoid / tanh after the last. It carries the per-point
occupancy query: the dense march of a rotated (free-viewpoint) frame and
every hierarchy level and refine level that runs exact per-point.

As in the TPU kernel the whole input row, its z channel included, is
rounded to the compute dtype and multiplied by weights in the compute
dtype; sums and the bias are f32, ``h`` is rounded after each activation,
the output is f32.

The kernels (``csrc/fused_mlp.cu``; the bf16 one's device code, design,
bound and shared-memory budget in ``csrc/wgmma_mlp.cuh``, which the ray MLP
shares) are CUDA C++ for sm_90a, built with ``nvcc`` at first use and bound
through ctypes (``build.py``). Two dtypes, two routes:

* bf16: one launch a call, one pass over every layer on wgmma, fed by an
  mbarrier ring (weights by bulk copy, x tiles by a TMA tensor map); no
  scratch. Each 64-point block streams all the packed weights from L2, so
  L2 bandwidth is this tiling's floor (``stream_wgmma`` measures it). The
  weights are pre-tiled once, at pack time (``wgmma.tile_stream``), into
  the order and layout the ring loads.
* f32: the parity route on plain FMA (``csrc/mlp_tiles.cuh``: a projection
  pass into a bounded f32 scratch, then the layer kernel), which wgmma
  cannot serve (no f32 operands; TF32 would break the 2e-5 parity).

``apply_mlp`` launches the kernel of the tensor's dtype for CUDA tensors
and runs ``apply_mlp_plain`` for CPU tensors; any other device raises, and
a failed check, build or launch raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import wgmma
from .fused_ray_mlp import (RayMlpPacked, launch_packed, pack_head, pad_feat,
                            run_layers)

LIBRARY = "fused_mlp"


@dataclass(frozen=True)
class PointMlpPacked(RayMlpPacked):
    """``RayMlpPacked`` plus, for bf16, the wgmma kernel's operands:
    ``tiles`` the weight stream (every layer's ``[W_h; W_x]`` at kernel
    widths, in ring-stage order, ``wgmma.tile_stream``), ``tile_bias`` the
    biases at kernel widths (f32), ``tile_widths`` the kernel widths of the
    layers."""
    tiles: torch.Tensor | None = None
    tile_bias: torch.Tensor | None = None
    tile_widths: tuple = ()


def pack_mlp_params(head, dtype: torch.dtype = torch.bfloat16,
                    device=None) -> PointMlpPacked:
    """The per-point kernel's operands of a ``SurfaceClassifier``: ``wf``
    holds every layer's W_x^T over the whole input (C_in padded to a
    multiple of 32, z its last real column), ``wz`` is zero; for bf16 also
    the wgmma kernel's pre-tiled stream."""
    p = pack_head(head, dtype, device, split_z=False)
    fields = {f: getattr(p, f) for f in RayMlpPacked.__dataclass_fields__}
    if dtype != torch.bfloat16:
        return PointMlpPacked(**fields)
    tiles, bias, _, widths = wgmma.tile_stream(p)
    return PointMlpPacked(**fields, tiles=tiles, tile_bias=bias,
                          tile_widths=widths)


def apply_mlp_plain(p: RayMlpPacked, x: torch.Tensor) -> torch.Tensor:
    """Plain-PyTorch version of the kernel, with its rounding points: x
    and the weights rounded to the compute dtype (upcast, so products are
    exact), f32 sums, h rounded after each activation.
    x [B, N, C_in] -> [B, N, out_dim] f32."""
    xp = torch.matmul(pad_feat(p, x).float(), p.wf.float().t())
    return run_layers(p, lambda lo, hi: xp[..., lo:hi] + p.b[lo:hi])


def _run_wgmma(p: PointMlpPacked, xr: torch.Tensor, function: str):
    if p.dtype != torch.bfloat16 or getattr(p, "tile_bias", None) is None:
        raise ValueError("the wgmma kernel takes bf16 operands packed by "
                         "pack_mlp_params")
    return wgmma.launch(LIBRARY, function, p, p.tile_bias, xr)


def launch_wgmma(p: PointMlpPacked, xr: torch.Tensor) -> torch.Tensor:
    """One launch of the bf16 kernel: xr [N, widths[0]] bf16 -> [N,
    out_dim] f32."""
    return _run_wgmma(p, xr, "fused_mlp_wgmma_forward")


def stream_wgmma(p: PointMlpPacked, xr: torch.Tensor) -> None:
    """The bf16 kernel's ring with the math off: every weight and x tile
    loaded, nothing computed. Its time is the tiling's L2 floor
    (``wgmma.streamed_bytes`` over it is the L2 read rate). Not a launch
    of the MLP."""
    _run_wgmma(p, xr, "fused_mlp_wgmma_stream")


def _launch(p: RayMlpPacked, x: torch.Tensor) -> torch.Tensor:
    b_, n, _ = x.shape
    xr = pad_feat(p, x).reshape(b_ * n, p.widths[0]).contiguous()
    if p.dtype == torch.bfloat16:
        out = launch_wgmma(p, xr)
    else:
        out = launch_packed(LIBRARY, "fused_mlp_forward", p, xr, b_ * n, 1)
    apply_mlp.launches += 1
    return out.reshape(b_, n, p.out_dim)


def apply_mlp(p: RayMlpPacked, x: torch.Tensor) -> torch.Tensor:
    """x [B, N, C_in] -> [B, N, out_dim] f32: the CUDA kernel of the
    packed dtype for CUDA tensors, the plain version for CPU tensors."""
    if x.device.type == "cuda":
        return _launch(p, x)
    if x.device.type == "cpu":
        return apply_mlp_plain(p, x)
    raise ValueError(f"the fused MLP kernels have no path for device "
                     f"{x.device}")


apply_mlp.launches = 0

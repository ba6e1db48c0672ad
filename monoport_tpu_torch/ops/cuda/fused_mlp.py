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

The kernels (``csrc/fused_mlp.cu``; design, bound and shared-memory budget
in its header) are CUDA C++ for sm_90a, built with ``nvcc`` at first use
and bound through ctypes (``build.py``). Two dtypes, two routes:

* bf16: one launch a call, one pass over every layer on wgmma, fed by an
  mbarrier ring (weights by bulk copy, x tiles by a TMA tensor map); no
  scratch. Each 64-point block streams all the packed weights from L2, so
  L2 bandwidth is this tiling's floor (``stream_wgmma`` measures it). The
  weights are pre-tiled once, at pack time (``tile_layout``), into the
  order and layout the ring loads.
* f32: the parity route on plain FMA (``csrc/mlp_tiles.cuh``: a projection
  pass into a bounded f32 scratch, then the layer kernel), which wgmma
  cannot serve (no f32 operands; TF32 would break the 2e-5 parity).

``apply_mlp`` launches the kernel of the tensor's dtype for CUDA tensors
and runs ``apply_mlp_plain`` for CPU tensors; any other device raises, and
a failed check, build or launch raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import build
from .fused_ray_mlp import (LAST_OPS, RayMlpPacked, launch_packed, pack_head,
                            pad_feat, run_layers)

LIBRARY = "fused_mlp"
# the bf16 kernel's tiling (csrc/fused_mlp.cu)
BM, BK, PASS_N, MAX_HIDDEN = 64, 32, 512, 1024
ONE_PASS = (32, 64, 128, 256, PASS_N)


@dataclass(frozen=True)
class PointMlpPacked(RayMlpPacked):
    """``RayMlpPacked`` plus, for bf16, the wgmma kernel's operands:
    ``tiles`` the weight stream (every layer's ``[W_h; W_x]`` at kernel
    widths, in ring-stage order, ``tile_layout``), ``tile_bias`` the biases
    at kernel widths (f32), ``tile_widths`` the kernel widths of the
    layers."""
    tiles: torch.Tensor | None = None
    tile_bias: torch.Tensor | None = None
    tile_widths: tuple = ()


def kernel_width(n: int) -> int:
    """A layer's width in the bf16 kernel: one wgmma width for each of its
    two warpgroups (32, 64, 128, 256, 512), or passes of 512."""
    for w in ONE_PASS:
        if n <= w:
            return w
    return -(-n // PASS_N) * PASS_N


def tile_layout(w: torch.Tensor) -> torch.Tensor:
    """``w`` [N, K] (a layer at kernel width N; K a multiple of 32) as the
    flat stream the ring loads: passes of up to 512 rows, each a run of
    [N_pass, 32] K-tiles, each tile 8 x 8 core matrices with K blocks
    outermost: element (n, k) of a tile at ((k // 8) * N_pass + n) * 8 +
    k % 8."""
    n, k = w.shape
    pn = min(n, PASS_N)
    t = w.reshape(n // pn, pn // 8, 8, k // BK, BK // 8, 8)
    return t.permute(0, 3, 4, 1, 2, 5).reshape(-1)


def untile_layout(flat: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """The inverse of ``tile_layout``: the stream of one [n, k] layer back
    as the matrix."""
    pn = min(n, PASS_N)
    t = flat.reshape(n // pn, k // BK, BK // 8, pn // 8, 8, 8)
    return t.permute(0, 3, 4, 1, 2, 5).reshape(n, k)


def _layer_matrices(p: RayMlpPacked) -> list[tuple[torch.Tensor,
                                                  torch.Tensor]]:
    """Layer i as the bf16 kernel sees it: ``[W_h[i] | W_x[i]]`` [N_i,
    K_h + C] (``W_h`` over the previous layer's kernel width, none for
    layer 0) and its bias [N_i] f32, N_i the kernel width, zero-padded."""
    kw = [kernel_width(w) for w in p.widths[1:]]
    c = p.widths[0]
    out = []
    for i, off in enumerate(p.xoff):
        n = p.widths[i + 1]
        kh = kw[i - 1] if i else 0
        m = torch.zeros(kw[i], kh + c, dtype=p.dtype, device=p.wf.device)
        if i:
            m[:n, :p.widths[i]] = p.wh_layer(i)
        m[:n, kh:] = p.wf[off:off + n]
        b = torch.zeros(kw[i], dtype=torch.float32, device=p.b.device)
        b[:n] = p.b[off:off + n]
        out.append((m, b))
    return out


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
    mats = _layer_matrices(p)
    return PointMlpPacked(
        **fields, tiles=torch.cat([tile_layout(m) for m, _ in mats]),
        tile_bias=torch.cat([b for _, b in mats]),
        tile_widths=tuple(m.shape[0] for m, _ in mats))


def apply_mlp_plain(p: RayMlpPacked, x: torch.Tensor) -> torch.Tensor:
    """Plain-PyTorch version of the kernel, with its rounding points: x
    and the weights rounded to the compute dtype (upcast, so products are
    exact), f32 sums, h rounded after each activation.
    x [B, N, C_in] -> [B, N, out_dim] f32."""
    xp = torch.matmul(pad_feat(p, x).float(), p.wf.float().t())
    return run_layers(p, lambda lo, hi: xp[..., lo:hi] + p.b[lo:hi])


def wgmma_shape_error(widths: tuple) -> str | None:
    """Why the bf16 kernel cannot take layers of these kernel widths, or
    None. Hidden outputs live in one [64, 1024] shared buffer, and a hidden
    layer past the first overwrites the h it reads, so it must be one pass
    (<= 512 wide)."""
    last = len(widths) - 1
    for i, w in enumerate(widths):
        if i < last and w > MAX_HIDDEN:
            return f"layer {i} is {w} wide; hidden layers take <= {MAX_HIDDEN}"
        if 0 < i < last and w not in ONE_PASS:
            return (f"hidden layer {i} is {w} wide; past the first, hidden "
                    f"layers take <= {PASS_N}")
    return None


def _run_wgmma(p: PointMlpPacked, xr: torch.Tensor, function: str):
    """Check the bf16 kernel's operands, raising before any build or
    launch, then launch ``function`` on ``xr``'s device and stream."""
    if p.dtype != torch.bfloat16 or getattr(p, "tiles", None) is None:
        raise ValueError("the wgmma kernel takes bf16 operands packed by "
                         "pack_mlp_params")
    reason = wgmma_shape_error(p.tile_widths)
    if reason:
        raise ValueError(f"the wgmma kernel cannot take this head: {reason}")
    if (xr.dtype != torch.bfloat16 or xr.dim() != 2
            or xr.shape[1] != p.widths[0] or not xr.is_contiguous()):
        raise ValueError(f"x must be contiguous bf16 [N, {p.widths[0]}], got "
                         f"{xr.dtype} {tuple(xr.shape)}")
    if xr.device.type != "cuda":
        raise ValueError(f"the wgmma kernel runs on CUDA tensors, not "
                         f"{xr.device}")
    for name, t in (("tiles", p.tiles), ("tile_bias", p.tile_bias)):
        if t.device != xr.device:
            raise ValueError(f"{name} is on {t.device}, the input on "
                             f"{xr.device}")
    out = torch.empty(xr.shape[0], p.out_dim, device=xr.device,
                      dtype=torch.float32)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    args = [(ptr, xr.data_ptr()), (ptr, out.data_ptr()),
            (ptr, p.tiles.data_ptr()), (ptr, p.tile_bias.data_ptr()),
            (ctypes.POINTER(i32), (i32 * len(p.tile_widths))(*p.tile_widths)),
            (i32, len(p.tile_widths)), (i32, p.widths[0]), (i32, p.out_dim),
            (i32, LAST_OPS[p.last_op]), (i32, xr.shape[0])]
    with torch.cuda.device(xr.device):
        args.append((ptr, torch.cuda.current_stream(xr.device).cuda_stream))
        fn = build.bind(LIBRARY, function, [a[0] for a in args])
        err = fn(*(a[1] for a in args))
    if err != 0:
        raise RuntimeError(f"{function} launch failed: error {err}")
    return out


def launch_wgmma(p: PointMlpPacked, xr: torch.Tensor) -> torch.Tensor:
    """One launch of the bf16 kernel: xr [N, widths[0]] bf16 -> [N,
    out_dim] f32."""
    return _run_wgmma(p, xr, "fused_mlp_wgmma_forward")


def stream_wgmma(p: PointMlpPacked, xr: torch.Tensor) -> None:
    """The bf16 kernel's ring with the math off: every weight and x tile
    loaded, nothing computed. Its time is the tiling's L2 floor
    (``streamed_bytes`` over it is the L2 read rate). Not a launch of the
    MLP."""
    _run_wgmma(p, xr, "fused_mlp_wgmma_stream")


def streamed_bytes(p: PointMlpPacked, n_points: int) -> int:
    """Bytes the bf16 kernel loads into shared memory for n_points: each
    64-point block the whole weight stream, and its x tile once for each
    pass of each layer."""
    x_passes = sum(max(1, w // PASS_N) for w in p.tile_widths)
    per_block = p.tiles.numel() * 2 + x_passes * BM * p.widths[0] * 2
    return -(-n_points // BM) * per_block


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

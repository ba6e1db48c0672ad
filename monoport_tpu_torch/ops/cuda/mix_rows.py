"""The weighted-row pass of the bf16 routes of kernels 3 and 4: the
hand-written Hopper kernel's launcher and its plain version.

``s[m] = sum_j w[m, j] * table[row(m, j)]``, products and sums in f32 in
the order j = 0..J-1, and ``out[m] = bf16(s[m])``; with ``split`` the row
is ``[hi | lo]``, hi = bf16(s), lo = bf16(s - hi), each half ``c_pad``
wide (the anchored route: one bf16 rounding of the mixed row moves the
committed netG's outputs past the bf16 tolerance; hi + lo keeps ~16 bits).
``row(m, j)`` is ``idx[m, j]`` (the bilinear gather of ``fused_gather_mlp``:
J = 4 taps) or, with no index, ``(m // taps) * J + j`` (the K anchor rows
of ray ``m // taps`` of ``fused_ray_mlp``'s anchored route: J = K).
Columns from the table's width up to ``c_pad`` are 0.

The kernel (``csrc/mix_rows.cuh``; design, bound and why it is a pass of its
own there) is included by ``csrc/fused_ray_mlp.cu`` (``mix_anchor_rows``)
and ``csrc/fused_gather_mlp.cu`` (``mix_gather_rows``); ``launch_mix_rows``
launches the entry point of the caller's library on CUDA tensors and
counts it. The callers' wrappers run ``mix_rows_plain`` (inside their own
plain versions) for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

MAX_TERMS = 8


def _rows(w: torch.Tensor, idx, taps) -> torch.Tensor:
    """The table row of every term, [M, J] int64."""
    m, j = w.shape
    if idx is not None:
        return idx.long()
    first = torch.arange(m, device=w.device) // taps * j
    return first[:, None] + torch.arange(j, device=w.device)


def mix_rows_plain(table: torch.Tensor, w: torch.Tensor,
                   idx: torch.Tensor | None = None, taps: int | None = None,
                   c_pad: int | None = None,
                   split: bool = False) -> torch.Tensor:
    """Plain-PyTorch version of the pass, with its rounding points: table
    [N, C], w [M, J] f32, idx [M, J] or (taps: N = M / taps * J) -> [M,
    c_pad or C] in the table's dtype, [M, 2 (c_pad or C)] (hi | lo) with
    ``split``."""
    j = w.shape[1]
    rows = table[_rows(w, idx, taps)].float()  # [M, J, C]
    wf = w.float()
    acc = rows[:, 0] * wf[:, 0, None]
    for k in range(1, j):
        acc = acc + rows[:, k] * wf[:, k, None]
    pad = (0, 0 if c_pad is None else c_pad - acc.shape[1])
    hi = acc.to(table.dtype)
    if not split:
        return torch.nn.functional.pad(hi, pad)
    lo = (acc - hi.float()).to(table.dtype)
    return torch.cat([torch.nn.functional.pad(hi, pad),
                      torch.nn.functional.pad(lo, pad)], dim=1)


def _check(table: torch.Tensor, w: torch.Tensor, idx: torch.Tensor | None,
           taps: int | None, c_pad: int) -> None:
    """Raise ValueError on operands the kernel does not take."""
    if table.dtype != torch.bfloat16 or table.dim() != 2 or \
            table.stride(1) != 1:
        raise ValueError(f"the table must be bf16 [N, C] with unit column "
                         f"stride, got {table.dtype} {tuple(table.shape)}")
    if w.dtype != torch.float32 or w.dim() != 2 or not w.is_contiguous():
        raise ValueError(f"w must be contiguous f32 [M, J], got {w.dtype} "
                         f"{tuple(w.shape)}")
    m, j = w.shape
    if not 1 <= j <= MAX_TERMS or m < 1:
        raise ValueError(f"{j} terms a row over {m} rows: the kernel takes "
                         f"1..{MAX_TERMS} terms")
    if idx is None:
        if taps is None or taps < 1 or m % taps or \
                table.shape[0] != m // taps * j:
            raise ValueError(f"{table.shape[0]} table rows for {m} rows of "
                             f"{j} anchors at {taps} taps")
    elif idx.dtype != torch.int32 or idx.shape != w.shape or \
            not idx.is_contiguous():
        raise ValueError(f"idx must be contiguous int32 {tuple(w.shape)}, "
                         f"got {idx.dtype} {tuple(idx.shape)}")
    if c_pad % 8 or c_pad < table.shape[1]:
        raise ValueError(f"c_pad {c_pad}: a multiple of 8 >= the table's "
                         f"{table.shape[1]} columns")
    if table.device.type != "cuda":
        raise ValueError(f"the mix kernel runs on CUDA tensors, not "
                         f"{table.device}")
    for name, t in (("w", w), ("idx", idx)):
        if t is not None and t.device != table.device:
            raise ValueError(f"{name} is on {t.device}, the table on "
                             f"{table.device}")


def launch_mix_rows(library: str, function: str, table: torch.Tensor,
                    w: torch.Tensor, c_pad: int,
                    idx: torch.Tensor | None = None, taps: int | None = None,
                    split: bool = False) -> torch.Tensor:
    """Check the operands, raising before any build or launch, then launch
    ``function`` of ``library`` on the table's device and stream -> [M,
    c_pad] bf16, [M, 2 c_pad] with ``split``."""
    _check(table, w, idx, taps, c_pad)
    c_f = table.shape[1]
    if table.stride(0) % 8 or table.data_ptr() % 16:
        # 16-byte rows: a width that is no multiple of 8 is padded
        ld = -(-c_f // 8) * 8
        table = torch.nn.functional.pad(table, (0, ld - c_f)).contiguous()
    m, j = w.shape
    out = torch.empty(m, 2 * c_pad if split else c_pad, device=table.device,
                      dtype=torch.bfloat16)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    args = [(ptr, table.data_ptr()), (i32, table.stride(0)), (i32, c_f),
            (ptr, w.data_ptr()),
            (ptr, None if idx is None else idx.data_ptr()), (i32, j),
            (i32, taps or 1), (ptr, out.data_ptr()), (i32, m), (i32, c_pad),
            (i32, int(split))]
    with torch.cuda.device(table.device):
        args.append((ptr, torch.cuda.current_stream(
            table.device).cuda_stream))
        fn = build.bind(library, function, [a[0] for a in args])
        err = fn(*(a[1] for a in args))
    if err != 0:
        raise RuntimeError(f"{function} launch failed: error {err}")
    launch_mix_rows.launches += 1
    return out


launch_mix_rows.launches = 0

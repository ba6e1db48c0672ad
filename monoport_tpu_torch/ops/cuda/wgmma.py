"""Host side of the bf16 wgmma MLP kernels (``csrc/wgmma_mlp.cuh``), shared
by the per-point MLP (``fused_mlp``, kernel 2) and the ray MLP
(``fused_ray_mlp``, kernel 1): layer widths at the kernel's instruction
widths, the weight stream pre-tiled in the order and layout the kernel's
ring loads, the heads the kernel takes, the bytes it streams, and the
checked launch.

Both kernels walk the same stream: layer i is ``[W_h[i] | W_x[i]]`` over
``[h_{i-1} | x]``, where x is the whole input row for the per-point pack and
the ray's feature row for the ray pack (z is then an epilogue term, not a
column). They differ in the epilogue's f32 terms (``tile_stream``'s b and
w_z) and in what a row is.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

# the kernel's tiling (csrc/wgmma_mlp.cuh)
BM, BK, PASS_N, MAX_HIDDEN = 64, 32, 512, 1024
ONE_PASS = (32, 64, 128, 256, PASS_N)
LAST_OPS = {None: 0, "sigmoid": 1, "tanh": 2}


def kernel_width(n: int) -> int:
    """A layer's width in the kernel: one wgmma width for each of its two
    warpgroups (32, 64, 128, 256, 512), or passes of 512."""
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


def tile_stream(p) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, tuple]:
    """The kernel's operands of a packed head (``RayMlpPacked``, either
    packing) -> (tiles, b, w_z, widths): every layer's ``[W_h[i] | W_x[i]]``
    [N_i, K_h + C] (``W_h`` over the previous layer's kernel width, none for
    layer 0; C = ``p.widths[0]``) at its kernel width N_i, zero-padded and
    ``tile_layout``-ed, one after the other; b and w_z [sum N_i] f32 at
    kernel widths; the kernel widths N_i."""
    widths = tuple(kernel_width(w) for w in p.widths[1:])
    c = p.widths[0]
    tiles, b, wz = [], [], []
    for i, off in enumerate(p.xoff):
        n = p.widths[i + 1]
        kh = widths[i - 1] if i else 0
        m = torch.zeros(widths[i], kh + c, dtype=p.dtype, device=p.wf.device)
        if i:
            m[:n, :p.widths[i]] = p.wh_layer(i)
        m[:n, kh:] = p.wf[off:off + n]
        tiles.append(tile_layout(m))
        for dst, src in ((b, p.b), (wz, p.wz)):
            v = torch.zeros(widths[i], dtype=torch.float32, device=src.device)
            v[:n] = src[off:off + n]
            dst.append(v)
    return torch.cat(tiles), torch.cat(b), torch.cat(wz), widths


def wgmma_shape_error(widths: tuple) -> str | None:
    """Why the kernel cannot take layers of these kernel widths, or None.
    Hidden outputs live in one [64, 1024] shared buffer, and a hidden layer
    past the first overwrites the h it reads, so it must be one pass (<= 512
    wide)."""
    last = len(widths) - 1
    for i, w in enumerate(widths):
        if i < last and w > MAX_HIDDEN:
            return f"layer {i} is {w} wide; hidden layers take <= {MAX_HIDDEN}"
        if 0 < i < last and w not in ONE_PASS:
            return (f"hidden layer {i} is {w} wide; past the first, hidden "
                    f"layers take <= {PASS_N}")
    return None


def streamed_bytes(p, n_rows: int, taps: int = 1) -> int:
    """Bytes the kernel loads into shared memory for n_rows input rows (x
    tiles) of ``taps`` rows of output each: each 64-row block the whole
    weight stream, and its x tile once for each pass of each layer."""
    x_passes = sum(max(1, w // PASS_N) for w in p.tile_widths)
    per_block = p.tiles.numel() * 2 + x_passes * BM * p.widths[0] * 2
    return -(-n_rows // BM) * taps * per_block


def launch(library: str, function: str, p, terms: torch.Tensor,
           xr: torch.Tensor, z: torch.Tensor | None = None) -> torch.Tensor:
    """Check the operands, raising before any build or launch, then launch
    ``function`` of ``library`` on ``xr``'s device and stream: xr [N,
    widths[0]] bf16 -> [N, out_dim] f32; with ``z`` [N, T] f32 (the ray
    kernel) -> [N, T, out_dim] f32. ``terms`` are the epilogue's f32 terms
    at kernel widths."""
    reason = wgmma_shape_error(p.tile_widths)
    if reason:
        raise ValueError(f"the wgmma kernel cannot take this head: {reason}")
    if (xr.dtype != torch.bfloat16 or xr.dim() != 2
            or xr.shape[1] != p.widths[0] or not xr.is_contiguous()):
        raise ValueError(f"x must be contiguous bf16 [N, {p.widths[0]}], got "
                         f"{xr.dtype} {tuple(xr.shape)}")
    if z is not None and (z.dtype != torch.float32 or z.dim() != 2
                          or z.shape[0] != xr.shape[0] or z.shape[1] < 1
                          or not z.is_contiguous()):
        raise ValueError(f"z must be contiguous f32 [{xr.shape[0]}, T], got "
                         f"{z.dtype} {tuple(z.shape)}")
    if xr.device.type != "cuda":
        raise ValueError(f"the wgmma kernel runs on CUDA tensors, not "
                         f"{xr.device}")
    for name, t in (("tiles", p.tiles), ("terms", terms), ("z", z)):
        if t is not None and t.device != xr.device:
            raise ValueError(f"{name} is on {t.device}, the input on "
                             f"{xr.device}")
    n = xr.shape[0]
    shape = (n, p.out_dim) if z is None else (n, z.shape[1], p.out_dim)
    out = torch.empty(shape, device=xr.device, dtype=torch.float32)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    args = [(ptr, xr.data_ptr()), (ptr, out.data_ptr()),
            (ptr, p.tiles.data_ptr()), (ptr, terms.data_ptr()),
            (ctypes.POINTER(i32), (i32 * len(p.tile_widths))(*p.tile_widths)),
            (i32, len(p.tile_widths)), (i32, p.widths[0]), (i32, p.out_dim),
            (i32, LAST_OPS[p.last_op]), (i32, n)]
    if z is not None:
        args += [(ptr, z.data_ptr()), (i32, z.shape[1])]
    with torch.cuda.device(xr.device):
        args.append((ptr, torch.cuda.current_stream(xr.device).cuda_stream))
        fn = build.bind(library, function, [a[0] for a in args])
        err = fn(*(a[1] for a in args))
    if err != 0:
        raise RuntimeError(f"{function} launch failed: error {err}")
    return out

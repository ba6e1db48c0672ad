"""Host side of the bf16 wgmma MLP kernels (``csrc/wgmma_mlp.cuh``), shared
by the per-point MLP (``fused_mlp``, kernel 2) and the ray MLP
(``fused_ray_mlp``, kernel 1): layer widths at the kernel's instruction
widths, the weight stream pre-tiled in the order and layout the kernel's
ring loads, the heads the kernel takes and in which mode, the bytes it
streams, and the checked launch.

Two modes of the one kernel, chosen from the kernel widths alone
(``needs_scratch``): in place, the hidden activations in one [64, 1024]
shared buffer (every published head); the scratch mode, for a head that
buffer cannot hold (a hidden layer wider than 1024, or one past the first
wider than 512), the activations in a device-memory ping-pong scratch of
[blocks, 2, 64, widest hidden layer] bf16 over a persistent grid of at most
one block an SM, streamed back through the ring as TMA tiles.

Both kernels walk the same stream: layer i is ``[W_h[i] | W_x[i]]`` over
``[h_{i-1} | x]``, where x is the whole input row for the per-point pack and
the ray's feature row for the ray pack (z is then an epilogue term, not a
column). They differ in the epilogue's f32 terms (``tile_stream``'s b and
w_z) and in what a row is.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

# the kernel's tiling (csrc/wgmma_mlp.cuh); MAX_LAYERS: kMaxLayers
# (csrc/mlp_tiles.cuh), the layers a head may have on either route
BM, BK, PASS_N, MAX_HIDDEN, MAX_LAYERS = 64, 32, 512, 1024, 8
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
    In one mode or the other it takes any widths (``kernel_width``'s:
    32, 64, 128, 256 or a multiple of 512) up to ``MAX_LAYERS`` layers."""
    if not 1 <= len(widths) <= MAX_LAYERS:
        return (f"{len(widths)} layers; the kernel takes 1 to {MAX_LAYERS} "
                f"layers of any width")
    for i, w in enumerate(widths):
        if w != kernel_width(w):
            return f"layer {i} is {w} wide, not a kernel width"
    return None


def inplace_error(widths: tuple) -> str | None:
    """Why the in-place mode cannot take these kernel widths, or None.
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


def needs_scratch(widths: tuple) -> bool:
    """Whether a head of these kernel widths runs in the scratch mode: only
    where the in-place mode refuses it."""
    return inplace_error(widths) is not None


def scratch_width(widths: tuple) -> int:
    """The scratch mode's row width: the widest hidden layer (0: in
    place)."""
    return max(widths[:-1], default=0) if needs_scratch(widths) else 0


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of card ``index``: the scratch mode's
    resident blocks (one an SM)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def streamed_bytes(p, n_rows: int, taps: int = 1) -> int:
    """Bytes the kernel loads into shared memory for n_rows input rows (x
    tiles) of ``taps`` rows of output each: each 64-row block the whole
    weight stream, and its x tile once for each pass of each layer; in the
    scratch mode also the h tiles of every layer past the first, once a
    pass (the epilogue's h stores, 64 x width x 2 bytes a hidden layer,
    are not loads)."""
    w = p.tile_widths
    passes = [max(1, n // PASS_N) for n in w]
    per_block = p.tiles.numel() * 2 + sum(passes) * BM * p.widths[0] * 2
    if needs_scratch(w):
        per_block += sum(passes[i] * w[i - 1] for i in range(1, len(w))) \
            * BM * 2
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
    # the scratch mode's [slots * 2 * 64, h_width] bf16 ping-pong scratch, a
    # slot a resident block
    h_width = scratch_width(p.tile_widths)
    hs, slots = None, 0
    if h_width:
        blocks = -(-n // BM) * (1 if z is None else z.shape[1])
        slots = min(blocks, sm_count(xr.device.index))
        hs = torch.empty(slots * 2 * BM, h_width, device=xr.device,
                         dtype=torch.bfloat16)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    args = [(ptr, xr.data_ptr()), (ptr, out.data_ptr()),
            (ptr, p.tiles.data_ptr()), (ptr, terms.data_ptr()),
            (ctypes.POINTER(i32), (i32 * len(p.tile_widths))(*p.tile_widths)),
            (i32, len(p.tile_widths)), (i32, p.widths[0]), (i32, p.out_dim),
            (i32, LAST_OPS[p.last_op]), (i32, n)]
    if z is not None:
        args += [(ptr, z.data_ptr()), (i32, z.shape[1])]
    args += [(ptr, None if hs is None else hs.data_ptr()), (i32, slots),
             (i32, h_width)]
    with torch.cuda.device(xr.device):
        args.append((ptr, torch.cuda.current_stream(xr.device).cuda_stream))
        fn = build.bind(library, function, [a[0] for a in args])
        err = fn(*(a[1] for a in args))
    if err != 0:
        raise RuntimeError(f"{function} launch failed: error {err}")
    return out

"""Ray-structured fused MLPs: the hand-written Hopper kernels and their
plain versions.

``apply_ray`` replaces ``monoport_tpu/ops/pallas/fused_ray_mlp.py::
_ray_kernel``, which carries every occupancy and colour query of the
frontal real-time frame (the march, both refines and the colour query: 4
launches a frame), the colour query of a dense frame and the refines of an
in-plane-rotated frame. Per ray the T z-taps share the pixel-aligned
feature, so every layer's skip/input projection splits as ``W_x x = W_f
feat + z * w_z``: ``z * w_z`` is a rank-1 term per tap, added in f32.

``apply_anchor`` replaces ``_anchor_kernel`` of the same file, which
carries the refine levels of a rotated (free-viewpoint) frame and the
hierarchy frame's refine: a ray has K anchor features, and each tap mixes
their projections with its K hat weights before adding ``z * w_z + b``.

The kernels (``csrc/fused_ray_mlp.cu``; design and bound in its header and
in the device code it includes) are CUDA C++ for sm_90a, built with
``nvcc`` at first use into ``_build/`` and bound through ctypes
(``build.py``). Each wrapper has two routes, by the packed dtype:

* bf16, ``apply_ray``: one launch a call of the wgmma kernel that the
  per-point MLP shares (``csrc/wgmma_mlp.cuh``, ``RayEpilogue``): a row is
  a (ray, tap), ``W_f feat`` is recomputed for each tap, ``z * w_z + b`` is
  the layer epilogue's f32 term; no scratch, except for a head the
  kernel's shared h buffer cannot hold, which runs its scratch mode
  (``wgmma.needs_scratch``). The weights are pre-tiled once, at pack time
  (``wgmma.tile_stream``); a head of more than ``wgmma.MAX_LAYERS`` layers
  raises.
* bf16, ``apply_anchor``: W_f is linear, so the mix moves ahead of it. The
  weighted-row pass (``csrc/mix_rows.cuh``, ``mix_rows.launch_mix_rows``;
  bound by bytes) writes each tap's mixed anchor row as a row of its own,
  its f32 sum split into bf16 hi + lo halves ([R * T, 2 C_f] bf16: 14.2 MB
  at 2,304 rays x 6 taps, 113 MB at 18,432 x 6, 226 MB at 36,864 x 6 for
  netG's 256 columns, a transient tensor); then one launch of the same
  wgmma kernel (``AnchorEpilogue``: ``RayEpilogue`` at one tap) over the R
  * T rows, with ``[W_f; W_f]`` against ``[hi | lo]`` (``p.anchor``). The
  TPU kernel mixes f32 projections; one bf16 rounding of the mixed row
  (2^-9 relative) took the committed netG's outputs 3.1e-2 from them, past
  the 2e-2 tolerance; hi + lo (~16 bits) brings them to 4.7e-3-1.4e-2,
  p99.9 1.7e-3-2.0e-3, at the frames' shapes (PERF.md). No scratch. Bound:
  operations (the MLP's); the pass alone by bytes.
* f32: the parity routes on plain FMA (``csrc/mlp_tiles.cuh``: ``W_f
  feat`` once a ray and anchor into a bounded f32 scratch, then the layer
  kernel, which mixes the anchors' projections in its epilogue), which
  wgmma cannot serve (no f32 operands; TF32 would break the 2e-5 parity).
  A head whose two activation buffers do not fit a block's shared memory
  (``f32_scratch``, decided from the widths) keeps them in a device-memory
  scratch of ``F32_SLOTS_PER_SM`` blocks an SM instead.

Either route takes any head of up to ``wgmma.MAX_LAYERS`` layers: the bf16
kernel's in-place or scratch mode, the f32 kernel's shared or device-memory
activations; nothing falls back to the plain version on the card.

Each wrapper launches its kernels for CUDA tensors and runs its plain
version (the TPU kernel's rounding points) for CPU tensors; any other
device raises, and a failed check, build or launch raises.

Packing happens once per parameter set (``pack_ray_mlp_params``): widths
are padded to multiples of 32, the weights are stored transposed
([out, in], the operand layout the kernel reads), and the 1- and 3-wide
last layers are zero-padded.
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass

import torch

from . import build, mix_rows, wgmma
from .wgmma import LAST_OPS

PAD = 32
MAX_ANCHORS = 8
LIBRARY = "fused_ray_mlp"
# the f32 scratch of the shared projections is bounded: the launcher walks
# the rays in chunks that fit it
XP_SCRATCH_BYTES = 64 << 20
# the f32 layer kernel (csrc/mlp_tiles.cuh: F32Cfg, mlp_kernel): rows a
# block, the activation rows' padding, the weight tile's floats
F32_BM, F32_LD_PAD, F32_SB_FLOATS = 32, 4, 16 * (128 + 4)
# the shared memory a block may opt into on Hopper (sm_90): the limit of a
# pack on the CPU; a pack on a card reads its card's
SMEM_OPTIN = 232_448
# blocks an SM of the f32 layer kernel when its activations live in the
# device-memory scratch (its shared memory then holds ~10 KB)
F32_SLOTS_PER_SM = 2


def f32_activation_lds(widths) -> tuple[int, int]:
    """The f32 layer kernel's two activation row strides (floats): the
    widest even-index and odd-index layer outputs, padded."""
    outs = widths[1:]
    return (max(outs[0::2]) + F32_LD_PAD,
            max(outs[1::2], default=0) + F32_LD_PAD)


def f32_layer_smem(widths, n_anchors: int = MAX_ANCHORS) -> int:
    """Bytes of shared memory the f32 layer kernel asks for with its
    activations in shared memory (``launch``'s ``smem_m``)."""
    ld_a, ld_b = f32_activation_lds(widths)
    return (4 * (F32_BM * (ld_a + ld_b) + F32_SB_FLOATS) + F32_BM * 8
            + F32_BM * n_anchors * 4)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclass(frozen=True)
class RayMlpPacked:
    """Kernel operands of one head. ``widths`` = padded
    [C_f, out_0, ..., out_(L-1)]; ``wf`` [sum(out), C_f] and ``wh`` (W_h^T
    of layers 1.. flattened, [out_i, out_(i-1)] each) in the compute dtype;
    ``wz`` and ``b`` [sum(out)] f32. ``c_f`` is the unpadded input width of
    ``wf``: the feature width, or the whole input width (z included, ``wz``
    zero) when packed for the per-point kernel."""
    wf: torch.Tensor
    wh: torch.Tensor
    wz: torch.Tensor
    b: torch.Tensor
    widths: tuple
    c_f: int
    out_dim: int
    last_op: str | None
    dtype: torch.dtype

    @property
    def f32_scratch(self) -> bool:
        """Whether the f32 layer kernel keeps this head's activations in
        device memory: where its two buffers (at any anchor count) pass
        the shared memory a block may opt into on the pack's card."""
        dev = self.wf.device
        optin = (torch.cuda.get_device_properties(dev).
                 shared_memory_per_block_optin if dev.type == "cuda"
                 else SMEM_OPTIN)
        return f32_layer_smem(self.widths) > optin

    @property
    def xoff(self) -> list[int]:
        offs, acc = [], 0
        for w in self.widths[1:]:
            offs.append(acc)
            acc += w
        return offs

    def wh_layer(self, i: int) -> torch.Tensor:
        """W_h^T of layer i >= 1 as [out_i, out_(i-1)]."""
        start = sum(self.widths[j + 1] * self.widths[j]
                    for j in range(1, i))
        n, k = self.widths[i + 1], self.widths[i]
        return self.wh[start:start + n * k].view(n, k)


@dataclass(frozen=True)
class RayWgmmaPacked(RayMlpPacked):
    """``RayMlpPacked`` plus the bf16 wgmma kernel's operands: ``tiles``
    the weight stream (every layer's ``[W_h; W_f]`` at kernel widths, in
    ring-stage order, ``wgmma.tile_stream``), ``tile_bwz`` the epilogue's
    f32 terms at kernel widths, ``{b[c], b[c + 1], w_z[c], w_z[c + 1]}`` a
    column pair c (one 16-byte load), ``tile_widths`` the kernel widths of
    the layers. ``anchor``: the same head as the anchored route runs it,
    over mixed rows ``[hi | lo]`` (``widths[0]`` twice as wide), every
    layer reading ``[W_h; W_f; W_f]``."""
    tiles: torch.Tensor | None = None
    tile_bwz: torch.Tensor | None = None
    tile_widths: tuple = ()
    anchor: "RayWgmmaPacked | None" = None


def pack_head(head, dtype: torch.dtype, device, split_z: bool) -> RayMlpPacked:
    """Split a ``SurfaceClassifier`` (skip-concat, z as the last input
    channel) into the kernel operands. ``split_z``: keep the z row of every
    layer's input weights apart in f32 (``wz``), as the ray kernels read
    it; else it stays a column of ``wf`` in the compute dtype."""
    layers = head.layers()
    device = device or layers[0].weight.device
    c_in = layers[0].weight.shape[1]
    c_f = c_in - 1 if split_z else c_in
    widths = [_round_up(c_f, PAD)] + [
        _round_up(lin.weight.shape[0], PAD) for lin in layers]
    ntot = sum(widths[1:])
    wf = torch.zeros(ntot, widths[0], dtype=torch.float32)
    wz = torch.zeros(ntot, dtype=torch.float32)
    b = torch.zeros(ntot, dtype=torch.float32)
    wh = []
    off = 0
    with torch.no_grad():
        for i, lin in enumerate(layers):
            w = lin.weight.detach().float().cpu()        # [out, in]
            out_dim = w.shape[0]
            h_dim = layers[i - 1].weight.shape[0] if i > 0 else 0
            if w.shape[1] != h_dim + c_in:
                raise ValueError(f"layer {i}: {tuple(w.shape)} is not a "
                                 f"skip-concat layer over {c_in} inputs")
            wf[off:off + out_dim, :c_f] = w[:, h_dim:h_dim + c_f]
            if split_z:
                wz[off:off + out_dim] = w[:, h_dim + c_f]
            b[off:off + out_dim] = lin.bias.detach().float().cpu()
            if i > 0:
                blk = torch.zeros(widths[i + 1], widths[i])
                blk[:out_dim, :h_dim] = w[:, :h_dim]
                wh.append(blk.reshape(-1))
            off += widths[i + 1]
    wh_flat = torch.cat(wh) if wh else torch.zeros(0)
    # the operand dtype rounds W_f / W_h; w_z and b stay f32 as in the
    # TPU packers
    return RayMlpPacked(
        wf=wf.to(device=device, dtype=dtype).contiguous(),
        wh=wh_flat.to(device=device, dtype=dtype).contiguous(),
        wz=wz.to(device), b=b.to(device), widths=tuple(widths), c_f=c_f,
        out_dim=layers[-1].weight.shape[0], last_op=head.last_op,
        dtype=dtype)


def pack_ray_mlp_params(head, dtype: torch.dtype = torch.bfloat16,
                        device=None) -> RayMlpPacked:
    """The operands of the ray and anchored kernels. Widths come from the
    layers; for bf16 also the ray kernel's pre-tiled stream."""
    p = pack_head(head, dtype, device, split_z=True)
    if dtype != torch.bfloat16:
        return p
    tiles, b, wz, widths = wgmma.tile_stream(p)
    bwz = torch.cat([b.view(-1, 2), wz.view(-1, 2)], dim=1).reshape(-1)
    hilo = dataclasses.replace(
        p, wf=torch.cat([p.wf, p.wf], dim=1).contiguous(),
        widths=(2 * p.widths[0], *p.widths[1:]), c_f=2 * p.widths[0])
    fields = lambda q: {f: getattr(q, f)
                        for f in RayMlpPacked.__dataclass_fields__}
    anchor = RayWgmmaPacked(**fields(hilo), tiles=wgmma.tile_stream(hilo)[0],
                            tile_bwz=bwz, tile_widths=widths)
    return RayWgmmaPacked(**fields(p), tiles=tiles, tile_bwz=bwz,
                          tile_widths=widths, anchor=anchor)


def _activate(acc: torch.Tensor, last: bool, last_op) -> torch.Tensor:
    if not last:
        return torch.where(acc > 0, acc, acc * 0.01)
    if last_op == "sigmoid":
        return torch.sigmoid(acc)
    if last_op == "tanh":
        return torch.tanh(acc)
    return acc


def pad_feat(p: RayMlpPacked, feat: torch.Tensor) -> torch.Tensor:
    """``feat`` [..., c_f] in the compute dtype, zero-padded to the packed
    width."""
    if feat.shape[-1] != p.c_f:
        raise ValueError(f"feature width {feat.shape[-1]} != head's {p.c_f}")
    f = feat.to(p.dtype)
    if p.widths[0] > p.c_f:
        f = torch.nn.functional.pad(f, (0, p.widths[0] - p.c_f))
    return f


def run_layers(p: RayMlpPacked, skip) -> torch.Tensor:
    """The layer loop of the plain versions, with the kernels' rounding
    points: ``skip(lo, hi)`` is the f32 input term of the layer whose
    packed columns are [lo, hi) (shared projection + z term + bias);
    h . W_h is an f32 product of operands rounded to the compute dtype
    (bf16 operands are upcast, so products are exact), and h is rounded
    after each activation."""
    n_layers = len(p.widths) - 1
    h = None
    for i, off in enumerate(p.xoff):
        acc = skip(off, off + p.widths[i + 1])
        if i > 0:
            acc = acc + torch.matmul(h.float(), p.wh_layer(i).float().t())
        acc = _activate(acc, i == n_layers - 1, p.last_op)
        h = acc.to(p.dtype)
    return acc[..., :p.out_dim]


def apply_ray_plain(p: RayMlpPacked, feat: torch.Tensor,
                    z: torch.Tensor) -> torch.Tensor:
    """Plain-PyTorch version of the ray kernel, with its rounding points:
    operands rounded to the compute dtype, products and sums in f32, xp
    and h . W_h kept f32, h rounded after each activation.
    feat [B, R, C_f], z [B, R, T] -> [B, R, T, out_dim] f32."""
    xp = torch.matmul(pad_feat(p, feat).float(), p.wf.float().t())
    zt = z.float()[..., None]                             # [B, R, T, 1]
    return run_layers(p, lambda lo, hi: (
        xp[:, :, None, lo:hi] + zt * p.wz[lo:hi] + p.b[lo:hi]))


def apply_anchor_plain(p: RayMlpPacked, feat_anchors: torch.Tensor,
                       w_taps: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Plain-PyTorch version of the anchored kernel, with its rounding
    points: anchor features rounded to the compute dtype, their projections
    f32, mixed per tap by the f32 hat weights; z and w_z f32.
    feat_anchors [B, R, K, C_f], w_taps [B, R, T, K], z [B, R, T] ->
    [B, R, T, out_dim] f32."""
    xp = torch.matmul(pad_feat(p, feat_anchors).float(), p.wf.float().t())
    w = w_taps.float()                                    # [B, R, T, K]
    zt = z.float()[..., None]
    return run_layers(p, lambda lo, hi: (
        torch.matmul(w, xp[..., lo:hi]) + zt * p.wz[lo:hi] + p.b[lo:hi]))


def launch_packed(library: str, function: str, p: RayMlpPacked,
                  feat: torch.Tensor, n_rays: int, taps: int,
                  z: torch.Tensor | None = None,
                  wk: torch.Tensor | None = None,
                  n_anchors: int | None = None,
                  gather: tuple | None = None) -> torch.Tensor:
    """Launch one of the f32 routes' C entry points (``csrc/mlp_tiles.cuh``)
    on ``feat``'s device and stream: ``feat`` [n_rays * K, widths[0]] f32,
    ``z`` [n_rays, taps] f32, ``wk`` [n_rays, taps, K] f32 -> [n_rays,
    taps, out_dim] f32. ``gather`` = (idx [n_rays, 4] i32, wgt [n_rays, 4]
    f32): ``feat`` is then the [H*W, widths[0]] table those index. Raises
    when the launch is refused."""
    dev = feat.device
    gidx, gwgt = gather or (None, None)
    for name, t in (("z", z), ("w_taps", wk), ("idx", gidx), ("wgt", gwgt),
                    ("wf", p.wf), ("wh", p.wh), ("wz", p.wz), ("b", p.b)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the input on {dev}")
    if p.dtype != torch.float32:
        raise ValueError(f"the FMA route takes f32 packs, not {p.dtype}")
    k = n_anchors or 1
    if not 1 <= k <= MAX_ANCHORS:
        raise ValueError(f"{k} anchors: the kernel takes 1..{MAX_ANCHORS}")
    if not 1 <= len(p.widths) - 1 <= wgmma.MAX_LAYERS:
        raise ValueError(f"{len(p.widths) - 1} layers: the kernel takes 1 "
                         f"to {wgmma.MAX_LAYERS} layers of any width")
    ntot = sum(p.widths[1:])
    xp_rows = max(k, min(n_rays * k, XP_SCRATCH_BYTES // (4 * ntot)))
    xp = torch.empty(xp_rows, ntot, device=dev, dtype=torch.float32)
    hs, slots = None, 0
    if p.f32_scratch:
        slots = min(-(-n_rays * taps // F32_BM),
                    F32_SLOTS_PER_SM * wgmma.sm_count(dev.index))
        hs = torch.empty(slots, F32_BM, sum(f32_activation_lds(p.widths)),
                         device=dev, dtype=torch.float32)
    out = torch.empty(n_rays, taps, p.out_dim, device=dev,
                      dtype=torch.float32)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    args = [(ptr, feat.data_ptr())]
    if wk is not None:
        args.append((ptr, wk.data_ptr()))
    if gather is not None:
        args += [(ptr, gidx.data_ptr()), (ptr, gwgt.data_ptr())]
    if z is not None:
        args.append((ptr, z.data_ptr()))
    args += [(ptr, out.data_ptr()), (ptr, xp.data_ptr()), (i32, xp_rows),
             (ptr, None if hs is None else hs.data_ptr()), (i32, slots),
             (ptr, p.wf.data_ptr()), (ptr, p.wh.data_ptr()),
             (ptr, p.wz.data_ptr()), (ptr, p.b.data_ptr()),
             (ctypes.POINTER(i32), (i32 * len(p.widths))(*p.widths)),
             (i32, len(p.widths) - 1), (i32, p.out_dim),
             (i32, LAST_OPS[p.last_op]), (i32, n_rays)]
    if z is not None:
        args.append((i32, taps))
    if n_anchors is not None:
        args.append((i32, n_anchors))
    with torch.cuda.device(dev):
        args.append((ptr, torch.cuda.current_stream(dev).cuda_stream))
        fn = build.bind(library, function, [a[0] for a in args])
        err = fn(*(a[1] for a in args))
    if err != 0:
        raise RuntimeError(f"{function} launch failed: error {err}")
    return out


def _check_taps(b_: int, r: int, z: torch.Tensor) -> int:
    taps = z.shape[-1]
    if z.shape != (b_, r, taps):
        raise ValueError(f"z shape {tuple(z.shape)} != [B, R, T]")
    return taps


def check_wgmma_pack(p: RayMlpPacked) -> None:
    """Raise ValueError unless the wgmma kernel takes this pack: bf16
    operands pre-tiled by ``pack_ray_mlp_params``, layers it can run."""
    if p.dtype != torch.bfloat16 or getattr(p, "tile_bwz", None) is None:
        raise ValueError("the wgmma ray kernel takes bf16 operands packed by "
                         "pack_ray_mlp_params")
    reason = wgmma.wgmma_shape_error(p.tile_widths)
    if reason:
        raise ValueError(f"the wgmma kernel cannot take this head: {reason}")


def _run_wgmma(p: RayMlpPacked, feat: torch.Tensor, z: torch.Tensor,
               function: str):
    check_wgmma_pack(p)
    return wgmma.launch(LIBRARY, function, p, p.tile_bwz, feat, z)


def launch_ray_wgmma(p: RayWgmmaPacked, feat: torch.Tensor,
                     z: torch.Tensor) -> torch.Tensor:
    """One launch of the bf16 kernel: feat [R, widths[0]] bf16 + z [R, T]
    f32 -> [R, T, out_dim] f32."""
    return _run_wgmma(p, feat, z, "fused_ray_mlp_wgmma_forward")


def stream_ray_wgmma(p: RayWgmmaPacked, feat: torch.Tensor,
                     z: torch.Tensor) -> None:
    """The bf16 kernel's ring with the math off: every weight and feature
    tile loaded, nothing computed. Its time is the tiling's L2 floor
    (``wgmma.streamed_bytes(p, R, T)`` over it is the L2 read rate). Not a
    launch of the MLP."""
    _run_wgmma(p, feat, z, "fused_ray_mlp_wgmma_stream")


def anchor_table(p: RayMlpPacked, feat_anchors: torch.Tensor) -> torch.Tensor:
    """feat_anchors [B, R, K, c_f] as the pass's [B * R * K, c_f] bf16 row
    table: a view where it is bf16 and contiguous already."""
    if feat_anchors.shape[-1] != p.c_f:
        raise ValueError(f"feature width {feat_anchors.shape[-1]} != head's "
                         f"{p.c_f}")
    return feat_anchors.to(torch.bfloat16).reshape(-1, p.c_f)


def mix_anchor_rows(p: RayMlpPacked, table: torch.Tensor, wk: torch.Tensor,
                    taps: int) -> torch.Tensor:
    """The bf16 route's pass: table [R * K, c_f] bf16 (``anchor_table``) +
    wk [R * taps, K] f32 -> the mixed rows [R * taps, 2 widths[0]] bf16,
    hi | lo."""
    return mix_rows.launch_mix_rows(LIBRARY, "mix_anchor_rows", table, wk,
                                    p.widths[0], taps=taps, split=True)


def launch_anchor_wgmma(p: RayWgmmaPacked, x: torch.Tensor,
                        z: torch.Tensor) -> torch.Tensor:
    """The bf16 route's MLP: one launch over the mixed rows, x [M, 2
    widths[0]] bf16 (hi | lo) + z [M, 1] f32 -> [M, 1, out_dim] f32."""
    check_wgmma_pack(p)
    return _run_wgmma(p.anchor, x, z, "fused_anchor_mlp_wgmma_forward")


def stream_anchor_wgmma(p: RayWgmmaPacked, x: torch.Tensor,
                        z: torch.Tensor) -> None:
    """``launch_anchor_wgmma``'s ring with the math off, as
    ``stream_ray_wgmma``. Not a launch of the MLP."""
    check_wgmma_pack(p)
    _run_wgmma(p.anchor, x, z, "fused_anchor_mlp_wgmma_stream")


def _launch_ray(p: RayMlpPacked, feat: torch.Tensor, z: torch.Tensor):
    b_, r, _ = feat.shape
    taps = _check_taps(b_, r, z)
    f = pad_feat(p, feat).reshape(b_ * r, p.widths[0]).contiguous()
    zz = z.to(torch.float32).reshape(b_ * r, taps).contiguous()
    if p.dtype == torch.bfloat16:
        out = launch_ray_wgmma(p, f, zz)
    else:
        out = launch_packed(LIBRARY, "fused_ray_mlp_forward", p, f, b_ * r,
                            taps, z=zz)
    apply_ray.launches += 1
    return out.reshape(b_, r, taps, p.out_dim)


def _launch_anchor(p: RayMlpPacked, feat_anchors: torch.Tensor,
                   w_taps: torch.Tensor, z: torch.Tensor):
    b_, r, k, _ = feat_anchors.shape
    taps = _check_taps(b_, r, z)
    if w_taps.shape != (b_, r, taps, k):
        raise ValueError(f"w_taps shape {tuple(w_taps.shape)} != "
                         f"[B, R, T, K] = {(b_, r, taps, k)}")
    if not 1 <= k <= MAX_ANCHORS:
        raise ValueError(f"{k} anchors: the kernel takes 1..{MAX_ANCHORS}")
    zz = z.to(torch.float32).reshape(b_ * r * taps, 1).contiguous()
    wk = w_taps.to(torch.float32).reshape(b_ * r * taps, k).contiguous()
    if p.dtype == torch.bfloat16:
        check_wgmma_pack(p)
        x = mix_anchor_rows(p, anchor_table(p, feat_anchors), wk, taps)
        out = launch_anchor_wgmma(p, x, zz)
    else:
        f = pad_feat(p, feat_anchors).reshape(b_ * r * k,
                                              p.widths[0]).contiguous()
        out = launch_packed(LIBRARY, "fused_anchor_mlp_forward", p, f,
                            b_ * r, taps, z=zz.reshape(b_ * r, taps),
                            wk=wk.reshape(b_ * r, taps, k), n_anchors=k)
    apply_anchor.launches += 1
    return out.reshape(b_, r, taps, p.out_dim)


def _no_path(device):
    return ValueError(f"the fused MLP kernels have no path for device "
                      f"{device}")


def apply_ray(p: RayMlpPacked, feat: torch.Tensor,
              z: torch.Tensor) -> torch.Tensor:
    """feat [B, R, C_f] + z [B, R, T] -> [B, R, T, out_dim] f32: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if feat.device.type == "cuda":
        return _launch_ray(p, feat, z)
    if feat.device.type == "cpu":
        return apply_ray_plain(p, feat, z)
    raise _no_path(feat.device)


def apply_anchor(p: RayMlpPacked, feat_anchors: torch.Tensor,
                 w_taps: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """feat_anchors [B, R, K, C_f] + w_taps [B, R, T, K] + z [B, R, T] ->
    [B, R, T, out_dim] f32: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if feat_anchors.device.type == "cuda":
        return _launch_anchor(p, feat_anchors, w_taps, z)
    if feat_anchors.device.type == "cpu":
        return apply_anchor_plain(p, feat_anchors, w_taps, z)
    raise _no_path(feat_anchors.device)


apply_ray.launches = 0
apply_anchor.launches = 0

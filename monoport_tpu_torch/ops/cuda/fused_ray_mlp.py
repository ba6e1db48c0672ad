"""Ray-structured fused MLP: the hand-written Hopper kernel and its twin.

Replaces ``monoport_tpu/ops/pallas/fused_ray_mlp.py::_ray_kernel``, which
carries every occupancy and colour query of the frontal real-time frame
(the march, both refines and the colour query: 4 launches a frame).

Per ray the T z-taps share the pixel-aligned feature, so every layer's
skip/input projection splits as ``W_x x = W_f feat + z * w_z``: ``W_f feat``
is computed once per ray and ``z * w_z`` is a rank-1 term per tap. The
kernel (``csrc/fused_ray_mlp.cu``; design and bound in its header) is CUDA
C++ for sm_90a, built with ``nvcc`` at first use into ``_build/`` and bound
through ctypes. ``apply_ray`` launches it for CUDA tensors and runs
``apply_ray_plain`` (same rounding points) for CPU tensors; any other
device raises.

Packing happens once per parameter set (``pack_ray_mlp_params``): widths
are padded to multiples of 32, the weights are stored transposed
([out, in], the operand layout the kernel reads), and the 1- and 3-wide
last layers are zero-padded.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from dataclasses import dataclass

import torch

PAD = 32
LAST_OPS = {None: 0, "sigmoid": 1, "tanh": 2}
SOURCE = os.path.join(os.path.dirname(__file__), os.pardir, os.pardir,
                      "csrc", "fused_ray_mlp.cu")
BUILD_DIR = os.path.join(os.path.dirname(__file__), os.pardir, os.pardir,
                         "_build")


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclass(frozen=True)
class RayMlpPacked:
    """Kernel operands of one head. ``widths`` = padded
    [C_f, out_0, ..., out_(L-1)]; ``wf`` [sum(out), C_f] and ``wh`` (W_h^T
    of layers 1.. flattened, [out_i, out_(i-1)] each) in the compute dtype;
    ``wz`` and ``b`` [sum(out)] f32."""
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


def pack_ray_mlp_params(head, dtype: torch.dtype = torch.bfloat16,
                        device=None) -> RayMlpPacked:
    """Split a ``SurfaceClassifier`` (skip-concat, z as the last input
    channel) into the kernel operands. Widths come from the layers."""
    layers = head.layers()
    device = device or layers[0].weight.device
    c_in = layers[0].weight.shape[1]
    c_f = c_in - 1
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
            wz[off:off + out_dim] = w[:, h_dim + c_f]
            b[off:off + out_dim] = lin.bias.detach().float().cpu()
            if i > 0:
                blk = torch.zeros(widths[i + 1], widths[i])
                blk[:out_dim, :h_dim] = w[:, :h_dim]
                wh.append(blk.reshape(-1))
            off += widths[i + 1]
    wh_flat = torch.cat(wh) if wh else torch.zeros(0)
    # the operand dtype rounds W_f / W_h; w_z and b stay f32 as in the
    # TPU packer
    return RayMlpPacked(
        wf=wf.to(device=device, dtype=dtype).contiguous(),
        wh=wh_flat.to(device=device, dtype=dtype).contiguous(),
        wz=wz.to(device), b=b.to(device), widths=tuple(widths), c_f=c_f,
        out_dim=layers[-1].weight.shape[0], last_op=head.last_op,
        dtype=dtype)


def _activate(acc: torch.Tensor, last: bool, last_op) -> torch.Tensor:
    if not last:
        return torch.where(acc > 0, acc, acc * 0.01)
    if last_op == "sigmoid":
        return torch.sigmoid(acc)
    if last_op == "tanh":
        return torch.tanh(acc)
    return acc


def _pad_feat(p: RayMlpPacked, feat: torch.Tensor) -> torch.Tensor:
    if feat.shape[-1] != p.c_f:
        raise ValueError(f"feature width {feat.shape[-1]} != head's {p.c_f}")
    f = feat.to(p.dtype)
    if p.widths[0] > p.c_f:
        f = torch.nn.functional.pad(f, (0, p.widths[0] - p.c_f))
    return f


def apply_ray_plain(p: RayMlpPacked, feat: torch.Tensor,
                    z: torch.Tensor) -> torch.Tensor:
    """Plain-PyTorch twin of the kernel, with the kernel's rounding points:
    operands rounded to the compute dtype, products and sums in f32 (the
    bf16 operands are upcast, so products are exact), xp and h . W_h kept
    f32, h rounded after each activation.
    feat [B, R, C_f], z [B, R, T] -> [B, R, T, out_dim] f32."""
    f = _pad_feat(p, feat).float()
    xp = torch.matmul(f, p.wf.float().t())               # [B, R, N_tot]
    zt = z.float()[..., None]                             # [B, R, T, 1]
    h = None
    n_layers = len(p.widths) - 1
    for i, off in enumerate(p.xoff):
        w = p.widths[i + 1]
        acc = (xp[:, :, None, off:off + w] + zt * p.wz[off:off + w]
               + p.b[off:off + w])                        # [B, R, T, O]
        if i > 0:
            acc = acc + torch.matmul(h.float(), p.wh_layer(i).float().t())
        acc = _activate(acc, i == n_layers - 1, p.last_op)
        h = acc.to(p.dtype)
    return acc[..., :p.out_dim]


def _library_path() -> str:
    """The build of the current source (named by its hash, so an edited
    source never loads a stale library)."""
    with open(SOURCE, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libfused_ray_mlp_{digest}.so")


def build() -> str:
    """Compile ``csrc/fused_ray_mlp.cu`` for sm_90a into ``_build/``
    (register and shared-memory use go to stderr)."""
    path = _library_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                        "-Xptxas", "-v", "-o", tmp, SOURCE], check=True)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    """Load the kernel library, building it first if needed."""
    path = _library_path()
    if not os.path.exists(path):
        build()
    lib = ctypes.CDLL(path)
    fn = lib.fused_ray_mlp_forward
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                   + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _launch(p: RayMlpPacked, feat: torch.Tensor, z: torch.Tensor):
    dev = feat.device
    for name, t in (("z", z), ("wf", p.wf), ("wh", p.wh), ("wz", p.wz),
                    ("b", p.b)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, feat on {dev}")
    if p.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"unsupported compute dtype {p.dtype}")
    b_, r, _ = feat.shape
    taps = z.shape[-1]
    if z.shape != (b_, r, taps):
        raise ValueError(f"z shape {tuple(z.shape)} != [B, R, T]")
    f = _pad_feat(p, feat).reshape(b_ * r, p.widths[0]).contiguous()
    zz = z.to(torch.float32).reshape(b_ * r, taps).contiguous()
    n_rays = b_ * r
    xp = torch.empty(n_rays, sum(p.widths[1:]), device=dev,
                     dtype=torch.float32)
    out = torch.empty(n_rays, taps, p.out_dim, device=dev,
                      dtype=torch.float32)
    widths = (ctypes.c_int * len(p.widths))(*p.widths)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library().fused_ray_mlp_forward(
            1 if p.dtype == torch.bfloat16 else 0, f.data_ptr(),
            zz.data_ptr(), out.data_ptr(), xp.data_ptr(), p.wf.data_ptr(),
            p.wh.data_ptr(), p.wz.data_ptr(), p.b.data_ptr(), widths,
            len(p.widths) - 1, p.out_dim, LAST_OPS[p.last_op], n_rays, taps,
            stream)
    if err != 0:
        raise RuntimeError(f"fused_ray_mlp launch failed: error {err}")
    apply_ray.launches += 1
    return out.reshape(b_, r, taps, p.out_dim)


def apply_ray(p: RayMlpPacked, feat: torch.Tensor,
              z: torch.Tensor) -> torch.Tensor:
    """feat [B, R, C_f] + z [B, R, T] -> [B, R, T, out_dim] f32: the CUDA
    kernel for CUDA tensors, the plain twin for CPU tensors."""
    if feat.device.type == "cuda":
        return _launch(p, feat, z)
    if feat.device.type == "cpu":
        return apply_ray_plain(p, feat, z)
    raise ValueError(f"fused_ray_mlp has no path for device {feat.device}")


apply_ray.launches = 0

"""Shared helpers of the tests of the bf16 routes
(tests/test_torch_ray_wgmma.py, tests/test_torch_anchor_wgmma.py,
tests/test_torch_wide_heads.py, tests/test_torch_cuda.py): seeded
skip-concat heads at the published, a narrow and two wide widths (the
wide ones run the kernel's scratch mode), ``walk``, the wgmma kernel's
schedule over its pre-tiled weight stream in plain PyTorch, and
``bf16_ulps``. Imports no JAX."""

import numpy as np
import torch

from monoport_tpu_torch.models.heads import SurfaceClassifier
from monoport_tpu_torch.ops.cuda import fused_ray_mlp as tray
from monoport_tpu_torch.ops.cuda import wgmma
from monoport_tpu_torch.ops.cuda.fused_ray_mlp import _activate

# the wide heads: a hidden layer over 1024 (the in-place h buffer's
# width), a hidden layer past the first with two passes of 512, a width
# that is no power of two (768 and 640 run at 1024); "wide" is
# WIDE_NETG_HEAD, chip_smoke's wide netG head
WIDE_NETG_HEAD = (257, 2048, 1024, 768, 128, 1)
HEADS = {"netG": ((257, 1024, 512, 256, 128, 1), "sigmoid"),
         "netC": ((513, 1024, 512, 256, 128, 3), "tanh"),
         "narrow": ((65, 96, 64, 48, 1), "sigmoid"),
         "wide": (WIDE_NETG_HEAD, "sigmoid"),
         "wide_c": ((97, 1536, 640, 64, 3), "tanh")}


def head_params(chans, seed=11):
    """Seeded skip-concat head params in the JAX layout: kernel [fan_in,
    out], the input (z last) after the previous layer's output."""
    rng = np.random.RandomState(seed)
    params = {}
    for i in range(len(chans) - 1):
        fan_in = chans[i] + (chans[0] if i else 0)
        params[f"filters_{i}"] = {
            "kernel": (rng.randn(fan_in, chans[i + 1])
                       / np.sqrt(fan_in)).astype(np.float32),
            "bias": (rng.randn(chans[i + 1]) * 0.1).astype(np.float32)}
    return params


def make_head(name):
    """(the port's ``SurfaceClassifier``, its JAX params) of a head of
    ``HEADS``."""
    chans, last_op = HEADS[name]
    params = head_params(chans)
    head = SurfaceClassifier(chans, last_op=last_op)
    with torch.no_grad():
        for i, lin in enumerate(head.layers()):
            lin.weight.copy_(torch.from_numpy(
                params[f"filters_{i}"]["kernel"].T))
            lin.bias.copy_(torch.from_numpy(params[f"filters_{i}"]["bias"]))
    return head, params


def bf16_ulps(a, b):
    """Distance of two bf16 tensors in units in the last place (+0 and -0
    equal)."""
    def key(t):
        bits = t.contiguous().view(torch.int16).int()
        mag = bits & 0x7FFF
        return torch.where(bits < 0, -mag, mag)
    return (key(a) - key(b)).abs()


def split_bwz(bwz):
    """{b, b, w_z, w_z} a column pair -> (b, w_z)."""
    q = bwz.view(-1, 4)
    return q[:, :2].reshape(-1), q[:, 2:].reshape(-1)


def walk(p, tiles, b, wz, widths, feat, z):
    """The kernel's schedule in plain PyTorch, one tap at a time as a block
    runs: the producer's stage order over the stream, A from h or from the
    feature tile, sums in f32, the epilogue ``acc + (z * w_z + b)`` in f32,
    the activation, h rounded to the operand dtype at its kernel width and
    written after each pass. In place (``wgmma.needs_scratch`` false) h is
    one buffer that a layer reads and overwrites; in the scratch mode it is
    two, layer i reading half (i - 1) % 2 and writing half i % 2."""
    xr = tray.pad_feat(p, feat).reshape(-1, p.widths[0])
    zr = z.reshape(xr.shape[0], -1).float()
    c, last, bk = p.widths[0], len(widths) - 1, wgmma.BK
    halves = 2 if wgmma.needs_scratch(tuple(widths)) else 1
    outs = []
    for t in range(zr.shape[1]):
        h = [torch.zeros(xr.shape[0], max(widths), dtype=p.dtype)
             for _ in range(halves)]
        pos = boff = 0
        for i, n in enumerate(widths):
            pn = min(n, wgmma.PASS_N)
            nh = widths[i - 1] // bk if i else 0
            src, dst = h[(i - 1) % halves], h[i % halves]
            v = torch.zeros(xr.shape[0], n)
            for pass_ in range(n // pn):
                cols = slice(pass_ * pn, (pass_ + 1) * pn)
                acc = torch.zeros(xr.shape[0], pn)
                for kt in range(nh + c // bk):
                    w = wgmma.untile_layout(tiles[pos:pos + pn * bk], pn, bk)
                    pos += pn * bk
                    a = (src[:, kt * bk:(kt + 1) * bk] if kt < nh else
                         xr[:, (kt - nh) * bk:(kt - nh + 1) * bk])
                    acc += a.float() @ w.float().t()
                term = (zr[:, t:t + 1] * wz[boff + cols.start:boff + cols.stop]
                        + b[boff + cols.start:boff + cols.stop])
                v[:, cols] = _activate(acc + term, i == last, p.last_op)
                if i < last:
                    dst[:, cols] = v[:, cols].to(p.dtype)
            boff += n
        outs.append(v[:, :p.out_dim])
    return torch.stack(outs, 1).reshape(*z.shape, p.out_dim)

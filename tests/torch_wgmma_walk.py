"""Shared helpers of the tests of the bf16 routes
(tests/test_torch_ray_wgmma.py, tests/test_torch_anchor_wgmma.py,
tests/test_torch_cuda.py): seeded
skip-concat heads at the published and a narrow width, ``walk``, the wgmma
kernel's schedule over its pre-tiled weight stream in plain PyTorch, and
``bf16_ulps``. Imports no JAX."""

import numpy as np
import torch

from monoport_tpu_torch.models.heads import SurfaceClassifier
from monoport_tpu_torch.ops.cuda import fused_ray_mlp as tray
from monoport_tpu_torch.ops.cuda import wgmma
from monoport_tpu_torch.ops.cuda.fused_ray_mlp import _activate

HEADS = {"netG": ((257, 1024, 512, 256, 128, 1), "sigmoid"),
         "netC": ((513, 1024, 512, 256, 128, 3), "tanh"),
         "narrow": ((65, 96, 64, 48, 1), "sigmoid")}


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
    the activation, h rounded to the operand dtype at its kernel width."""
    xr = tray.pad_feat(p, feat).reshape(-1, p.widths[0])
    zr = z.reshape(xr.shape[0], -1).float()
    c, last, bk = p.widths[0], len(widths) - 1, wgmma.BK
    outs = []
    for t in range(zr.shape[1]):
        h = torch.zeros(xr.shape[0], max(widths), dtype=p.dtype)
        pos = boff = 0
        for i, n in enumerate(widths):
            pn = min(n, wgmma.PASS_N)
            nh = widths[i - 1] // bk if i else 0
            acc = torch.zeros(xr.shape[0], n)
            for pass_ in range(n // pn):
                for kt in range(nh + c // bk):
                    w = wgmma.untile_layout(tiles[pos:pos + pn * bk], pn, bk)
                    pos += pn * bk
                    a = (h[:, kt * bk:(kt + 1) * bk] if kt < nh else
                         xr[:, (kt - nh) * bk:(kt - nh + 1) * bk])
                    cols = slice(pass_ * pn, (pass_ + 1) * pn)
                    acc[:, cols] += a.float() @ w.float().t()
            term = zr[:, t:t + 1] * wz[boff:boff + n] + b[boff:boff + n]
            v = _activate(acc + term, i == last, p.last_op)
            boff += n
            if i < last:
                h[:, :n] = v.to(p.dtype)
        outs.append(v[:, :p.out_dim])
    return torch.stack(outs, 1).reshape(*z.shape, p.out_dim)

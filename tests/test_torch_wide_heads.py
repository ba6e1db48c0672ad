"""PyTorch port, heads of any width on every kernel route: their host side
on the CPU.

The wide heads of ``tests/torch_wgmma_walk.py`` (``WIDE_NETG_HEAD`` =
257-2048-1024-768-128-1 and 97-1536-640-64-3) hold one of each case the
in-place bf16 kernel refuses: a hidden layer over 1024, a hidden layer past
the first with two passes of 512, widths that are no power of two. The
bf16 routes run them in the wgmma kernel's scratch mode (the activations
in a device-memory ping-pong scratch, streamed back through the ring), the
f32 routes with their activations in a device-memory scratch. The kernels
run only on the card (tests/test_torch_cuda.py, chip_smoke.py); here: the
modes each route picks from the widths, the packed streams inverted to
W / b / w_z, the bytes the scratch mode streams, and the walk of the
scratch mode's schedule (``walk``) and the plain versions against the JAX
kernels run with ``interpret=True`` for kernels 1-4, bf16 at atol 2e-2 and
f32 at atol 2e-5 / rtol 1e-4."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from monoport_tpu.ops.pallas import fused_gather_mlp as jgather
from monoport_tpu.ops.pallas import fused_mlp as jmlp
from monoport_tpu.ops.pallas import fused_ray_mlp as jray
from monoport_tpu_torch.ops.cuda import fused_gather_mlp as tgather
from monoport_tpu_torch.ops.cuda import fused_mlp as tmlp
from monoport_tpu_torch.ops.cuda import fused_ray_mlp as tray
from monoport_tpu_torch.ops.cuda import mix_rows, wgmma
from torch_wgmma_walk import HEADS, WIDE_NETG_HEAD, make_head, split_bwz, walk

torch.set_num_threads(2)
WIDE = ("wide", "wide_c")
PUBLISHED = ("netG", "netC", "narrow")
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": dict(atol=2e-5, rtol=1e-4), "bf16": dict(atol=2e-2, rtol=0)}
RAYS, TAPS, K = 70, 6, 3                 # 70 rays: no multiple of 64


def _f(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def _hat_weights(rng, rays, taps, k):
    alpha = np.sort(rng.rand(1, rays, taps).astype(np.float32), axis=-1)
    pos = alpha[..., None] * (k - 1) - np.arange(k, dtype=np.float32)
    return np.maximum(0.0, 1.0 - np.abs(pos)).astype(np.float32)


def test_wide_head_is_the_chip_smoke_head():
    assert HEADS["wide"] == (WIDE_NETG_HEAD, "sigmoid")
    p = tray.pack_ray_mlp_params(make_head("wide")[0])
    assert p.tile_widths == (2048, 1024, 1024, 128, 32)


@pytest.mark.parametrize("name", WIDE + PUBLISHED)
def test_each_route_picks_its_mode_from_the_widths(name):
    """The bf16 kernel takes every head (``wgmma_shape_error`` None), the
    scratch mode only for the wide ones; the f32 packer keeps the wide
    heads' activations in device memory and the published heads' in
    shared memory."""
    head = make_head(name)[0]
    wide = name in WIDE
    for p in (tray.pack_ray_mlp_params(head), tmlp.pack_mlp_params(head),
              tray.pack_ray_mlp_params(head).anchor):
        assert wgmma.wgmma_shape_error(p.tile_widths) is None
        assert wgmma.needs_scratch(p.tile_widths) == wide
        assert (wgmma.inplace_error(p.tile_widths) is None) != wide
        assert wgmma.scratch_width(p.tile_widths) == (
            max(p.tile_widths[:-1]) if wide else 0)
    for pack in (tray.pack_ray_mlp_params, tmlp.pack_mlp_params):
        p = pack(head, dtype=torch.float32)
        assert p.f32_scratch == wide
        assert (tray.f32_layer_smem(p.widths) > tray.SMEM_OPTIN) == wide
    if name == "wide":
        p = tray.pack_ray_mlp_params(head, dtype=torch.float32)
        assert tray.f32_activation_lds(p.widths) == (2052, 1028)
        assert tray.f32_layer_smem(p.widths) > 390_000


def test_the_published_f32_heads_keep_shared_memory():
    """netG / netC at 1024-512 (and the 271- and 320-wide inputs, which
    change no hidden width) stay under a block's shared memory."""
    for chans in ((257, 1024, 512, 256, 128, 1), (513, 1024, 512, 256, 128, 3),
                  (271, 1024, 512, 256, 128, 1)):
        widths = (288, *[-(-c // 32) * 32 for c in chans[1:]])
        assert tray.f32_layer_smem(widths) < tray.SMEM_OPTIN


@pytest.mark.parametrize("name", WIDE)
def test_wide_point_stream_inverts_to_wf_wh_and_b(name):
    """The per-point pack's stream of a wide head, layer by layer at its
    kernel widths (multi-pass hidden layers included), gives back ``wf`` /
    ``wh`` and ``tile_bias`` gives back ``b``; nothing else is in it."""
    p = tmlp.pack_mlp_params(make_head(name)[0])
    c = p.widths[0]
    pos = boff = 0
    for i, off in enumerate(p.xoff):
        n_k, n = p.tile_widths[i], p.widths[i + 1]
        kh = p.tile_widths[i - 1] if i else 0
        m = wgmma.untile_layout(p.tiles[pos:pos + n_k * (kh + c)], n_k,
                                kh + c)
        pos += n_k * (kh + c)
        assert torch.equal(m[:n, kh:], p.wf[off:off + n])
        if i:
            assert torch.equal(m[:n, :p.widths[i]], p.wh_layer(i))
            assert m[:n, p.widths[i]:kh].abs().sum() == 0
        assert m[n:].abs().sum() == 0
        assert torch.equal(p.tile_bias[boff:boff + n], p.b[off:off + n])
        assert p.tile_bias[boff + n:boff + n_k].abs().sum() == 0
        boff += n_k
    assert pos == p.tiles.numel() and boff == p.tile_bias.numel()


def test_streamed_bytes_count_the_h_tiles():
    """In the scratch mode a 64-row block also loads, once a pass of each
    layer past the first, the h tiles of the layer before: 64 x K_h x 2
    bytes; in place it loads none."""
    p = tray.pack_ray_mlp_params(make_head("wide")[0])
    w = p.tile_widths                          # 2048, 1024, 1024, 128, 32
    passes = [4, 2, 2, 1, 1]
    x = sum(passes) * 64 * p.widths[0] * 2
    h = (2 * 2048 + 2 * 1024 + 1024 + 128) * 64 * 2
    assert [max(1, n // 512) for n in w] == passes
    assert wgmma.streamed_bytes(p, 65, 6) == 2 * 6 * (
        p.tiles.numel() * 2 + x + h)
    g = tray.pack_ray_mlp_params(make_head("netG")[0])
    assert wgmma.streamed_bytes(g, 64, 1) == g.tiles.numel() * 2 + (
        2 + 4) * 64 * 256 * 2


def test_the_walk_of_one_buffer_is_wrong_for_the_wide_head(monkeypatch):
    """The hazard the scratch mode removes: walked with one h buffer (the
    in-place schedule), the two-pass hidden layer overwrites the h its
    second pass still reads, and the output leaves the plain version."""
    p = tray.pack_ray_mlp_params(make_head("wide")[0])
    rng = np.random.RandomState(3)
    feat = _f(rng.randn(1, 20, p.c_f))
    z = _f(rng.uniform(-1.3, 1.3, (1, 20, 1)))
    b, wz = split_bwz(p.tile_bwz)
    want = tray.apply_ray_plain(p, feat, z)
    torch.testing.assert_close(
        walk(p, p.tiles, b, wz, p.tile_widths, feat, z), want, **TOL["bf16"])
    monkeypatch.setattr(wgmma, "needs_scratch", lambda widths: False)
    one = walk(p, p.tiles, b, wz, p.tile_widths, feat, z)
    assert (one - want).abs().max() > 2e-2


# -- kernels 1-4 against the JAX kernels (interpret mode) ---------------------
def _jax_pack(name, dtype, point=False):
    chans, _ = HEADS[name]
    params = make_head(name)[1]
    if point:
        return jmlp.pack_mlp_params(params, chans, DTYPES[dtype][0])
    return jray.pack_ray_mlp_params(params, chans, DTYPES[dtype][0])


def _kernel_case(kernel, name, dtype):
    """(JAX kernel output, {route name: port output}) on numpy-seeded
    inputs: bf16 the walk of the kernel's stream (kernels 3 and 4 after
    their weighted-row pass) and the plain version; f32 the plain version
    and, for kernels 1 and 2, the walk of the f32 pack's stream."""
    head, _ = make_head(name)
    jdt, tdt = DTYPES[dtype]
    last_op = HEADS[name][1]
    rng = np.random.RandomState(11)
    got = {}
    if kernel == "point":
        p = tmlp.pack_mlp_params(head, dtype=tdt)
        x = rng.randn(1, 77, p.c_f).astype(np.float32)
        want = jmlp.apply_packed(_jax_pack(name, dtype, point=True),
                                 jnp.asarray(x), last_op, tile_n=64,
                                 compute_dtype=jdt, interpret=True)
        xt = _f(x)
        got["plain"] = tmlp.apply_mlp_plain(p, xt)
        tiles, b, _, widths = ((p.tiles, p.tile_bias, None, p.tile_widths)
                               if dtype == "bf16"
                               else wgmma.tile_stream(p))
        zero = torch.zeros(1, 77, 1)
        got["walk"] = walk(p, tiles, b, torch.zeros_like(b), widths, xt,
                           zero)[:, :, 0]
        return np.asarray(want), got
    p = tray.pack_ray_mlp_params(head, dtype=tdt)
    jp = _jax_pack(name, dtype)
    if kernel == "ray":
        feat = rng.randn(1, RAYS, p.c_f).astype(np.float32)
        z = rng.uniform(-1.3, 1.3, (1, RAYS, TAPS)).astype(np.float32)
        want = jray.apply_ray_packed(jp, jnp.asarray(feat), jnp.asarray(z),
                                     last_op, tile_r=64, compute_dtype=jdt,
                                     interpret=True)
        got["plain"] = tray.apply_ray_plain(p, _f(feat), _f(z))
        args = ((p.tiles, *split_bwz(p.tile_bwz), p.tile_widths)
                if dtype == "bf16" else wgmma.tile_stream(p))
        got["walk"] = walk(p, *args, _f(feat), _f(z))
    elif kernel == "anchor":
        feat = rng.randn(1, RAYS, K, p.c_f).astype(np.float32)
        w = _hat_weights(rng, RAYS, TAPS, K)
        z = rng.uniform(-1.3, 1.3, (1, RAYS, TAPS)).astype(np.float32)
        want = jray.apply_anchor_packed(
            jp, jnp.asarray(feat), jnp.asarray(w), jnp.asarray(z), last_op,
            tile_r=128, compute_dtype=jdt, interpret=True)
        got["plain"] = tray.apply_anchor_plain(p, _f(feat), _f(w), _f(z))
        if dtype == "bf16":
            x = mix_rows.mix_rows_plain(
                tray.anchor_table(p, _f(feat)), _f(w).reshape(-1, K),
                taps=TAPS, c_pad=p.widths[0], split=True)
            a = p.anchor
            got["walk"] = walk(a, a.tiles, *split_bwz(a.tile_bwz),
                               a.tile_widths, x, _f(z).reshape(-1, 1)
                               ).reshape(1, RAYS, TAPS, p.out_dim)
    else:
        h, wd = 9, 11
        fmap = rng.randn(1, h, wd, p.c_f).astype(np.float32)
        uv = rng.uniform(-1.2, 1.2, (1, RAYS, 2)).astype(np.float32)
        z = rng.uniform(-1.3, 1.3, (1, RAYS, TAPS)).astype(np.float32)
        want = jgather.apply_gather_ray_packed(
            jp, jnp.asarray(fmap), jnp.asarray(uv), jnp.asarray(z), last_op,
            tile_r=64, compute_dtype=jdt, interpret=True)
        got["plain"] = tgather.apply_gather_plain(p, _f(fmap), _f(uv), _f(z))
        if dtype == "bf16":
            idx, wgt = tgather.bilinear_taps(_f(uv), h, wd)
            x = mix_rows.mix_rows_plain(
                _f(fmap).reshape(h * wd, -1).to(torch.bfloat16), wgt[0],
                idx=idx[0], c_pad=p.widths[0])
            got["walk"] = walk(p, p.tiles, *split_bwz(p.tile_bwz),
                               p.tile_widths, x[None, :, :p.c_f], _f(z))
    return np.asarray(want), got


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kernel", ["ray", "point", "anchor", "gather"])
def test_wide_head_matches_pallas_interpret(kernel, dtype):
    """Kernels 1-4 at ``WIDE_NETG_HEAD``: each port route's output against
    the JAX kernel in interpret mode."""
    want, got = _kernel_case(kernel, "wide", dtype)
    assert got
    for route, out in got.items():
        assert out.shape == want.shape, route
        np.testing.assert_allclose(out.numpy(), want, err_msg=route,
                                   **TOL[dtype])


@pytest.mark.parametrize("kernel", ["ray", "point"])
def test_wide_c_head_matches_pallas_interpret(kernel):
    """The 97-1536-640-64-3 tanh head (three passes in layer 0, two in a
    640-wide hidden layer) through kernels 1 and 2 in bf16."""
    want, got = _kernel_case(kernel, "wide_c", "bf16")
    for route, out in got.items():
        np.testing.assert_allclose(out.numpy(), want, err_msg=route,
                                   **TOL["bf16"])

"""PyTorch port, the ray MLP's bf16 wgmma kernel: its host side on the CPU.

The kernel (``csrc/wgmma_mlp.cuh`` with the ray epilogue) runs only on the
card (tests/test_torch_cuda.py). Here: the pre-tiled weight stream of the
bf16 ray pack inverts to ``wf`` / ``wh`` and its interleaved epilogue terms
to ``b`` / ``wz``; a plain-PyTorch walk of the stream as the kernel walks
it, one tap at a time with the f32 ``z * w_z + b`` epilogue, equals
``apply_ray_plain`` (f32 atol 2e-5 / rtol 1e-4, bf16 atol 2e-2) and, on the
narrow head, the JAX ``apply_ray_packed(..., interpret=True)`` at the same
tolerances; the launcher raises on what the kernel does not take before any
build or launch, and ``apply_ray`` sends bf16 to it and f32 to the FMA
route."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from monoport_tpu.ops.pallas import fused_ray_mlp as jray
from monoport_tpu_torch.models.heads import SurfaceClassifier
from monoport_tpu_torch.ops.cuda import build, wgmma
from monoport_tpu_torch.ops.cuda import fused_ray_mlp as tray
from torch_wgmma_walk import HEADS
from torch_wgmma_walk import make_head as _head
from torch_wgmma_walk import split_bwz as _split_bwz
from torch_wgmma_walk import walk as _walk

torch.set_num_threads(2)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": dict(atol=2e-5, rtol=1e-4), "bf16": dict(atol=2e-2, rtol=0)}


def _inputs(p, rays, taps, seed=3):
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.randn(1, rays, p.c_f).astype(np.float32)),
            torch.from_numpy(rng.uniform(-1.3, 1.3, (1, rays, taps)).astype(
                np.float32)))


@pytest.mark.parametrize("name", sorted(HEADS))
def test_ray_stream_inverts_to_wf_wh_b_and_wz(name):
    """Undoing the tile permutation layer by layer gives back ``wf`` (the
    feature columns only: z is no operand column) and ``wh`` exactly,
    zeros in the kernel-width padding; ``tile_bwz`` holds ``b`` and ``wz``
    at the layer's kernel columns; the stream holds nothing else."""
    p = tray.pack_ray_mlp_params(_head(name)[0])
    c = p.widths[0]
    assert c == -(-(HEADS[name][0][0] - 1) // 32) * 32
    assert p.tile_widths == tuple(wgmma.kernel_width(w)
                                  for w in p.widths[1:])
    b, wz = _split_bwz(p.tile_bwz)
    pos, boff = 0, 0
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
        assert torch.equal(b[boff:boff + n], p.b[off:off + n])
        assert torch.equal(wz[boff:boff + n], p.wz[off:off + n])
        assert b[boff + n:boff + n_k].abs().sum() == 0
        assert wz[boff + n:boff + n_k].abs().sum() == 0
        boff += n_k
    assert pos == p.tiles.numel() and 2 * boff == p.tile_bwz.numel()
    assert p.tile_bwz.dtype == torch.float32 and wz.abs().sum() > 0


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name,taps", [("narrow", 6), ("netC", 1),
                                       ("netG", 2)])
def test_stream_walk_matches_plain(name, taps, dtype):
    """Walking the tiled stream per tap gives the plain version's output:
    bf16 through the pack's own stream and interleaved terms, f32 through
    ``wgmma.tile_stream`` of the f32 pack (the layout and the epilogue at
    f32 precision; the sums differ only in order)."""
    tdt = DTYPES[dtype][1]
    p = tray.pack_ray_mlp_params(_head(name)[0], dtype=tdt)
    if dtype == "bf16":
        tiles, (b, wz), widths = p.tiles, _split_bwz(p.tile_bwz), \
            p.tile_widths
    else:
        tiles, b, wz, widths = wgmma.tile_stream(p)
    feat, z = _inputs(p, 70, taps)
    torch.testing.assert_close(_walk(p, tiles, b, wz, widths, feat, z),
                               tray.apply_ray_plain(p, feat, z),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_stream_walk_matches_pallas_interpret(dtype):
    """On the narrow head the walk equals the JAX ray kernel (interpret
    mode), 40 rays x 6 taps."""
    jdt, tdt = DTYPES[dtype]
    head, params = _head("narrow")
    p = tray.pack_ray_mlp_params(head, dtype=tdt)
    feat, z = _inputs(p, 40, 6, seed=4)
    packed = jray.pack_ray_mlp_params(params, HEADS["narrow"][0], jdt)
    want = jray.apply_ray_packed(packed, jnp.asarray(feat.numpy()),
                                 jnp.asarray(z.numpy()), "sigmoid",
                                 tile_r=64, compute_dtype=jdt, interpret=True)
    if dtype == "bf16":
        got = _walk(p, p.tiles, *_split_bwz(p.tile_bwz), p.tile_widths,
                    feat, z)
    else:
        got = _walk(p, *wgmma.tile_stream(p), feat, z)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL[dtype])


def test_ray_launcher_checks_raise_before_any_launch(monkeypatch):
    """Every refused operand raises ValueError before a build or a launch."""
    def no_launch(*args, **kwargs):
        raise AssertionError("reached the build / launch")

    monkeypatch.setattr(build, "bind", no_launch)
    head = _head("narrow")[0]
    p = tray.pack_ray_mlp_params(head)
    f = torch.zeros(5, p.widths[0], dtype=torch.bfloat16)
    z = torch.zeros(5, 6)
    # nine layers: past kMaxLayers, the one limit either route keeps
    wide = tray.pack_ray_mlp_params(
        SurfaceClassifier((65,) + (32,) * 8 + (1,)))
    cases = [
        (tray.pack_ray_mlp_params(head, torch.float32), f, z),  # f32 pack
        (tray.pack_head(head, torch.bfloat16, None, True), f, z),  # no tiles
        (wide, torch.zeros(5, wide.widths[0], dtype=torch.bfloat16), z),
        (p, f.float(), z),                                 # not bf16
        (p, f[:, :32], z),                                 # not [R, C_f]
        (p, f.reshape(1, 5, -1), z),
        (p, torch.zeros(p.widths[0], 5, dtype=torch.bfloat16).t(), z),
        (p, f, z.double()),                                # z not f32
        (p, f, z[:4]),                                     # z not [R, T]
        (p, f, torch.zeros(6, 5).t()),                     # z not contiguous
        (p, f, z),                                         # CPU tensors
        (p, f.to("meta"), z.to("meta")),                   # no CUDA tensor
    ]
    for packed, feat, zz in cases:
        with pytest.raises(ValueError):
            tray.launch_ray_wgmma(packed, feat, zz)
    with pytest.raises(ValueError):
        tray.stream_ray_wgmma(wide, f, z)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_apply_ray_routes_by_dtype(monkeypatch, dtype):
    """A CUDA-bound call goes to the wgmma launcher for bf16 (padded
    contiguous features, f32 [R, T] z) and to the FMA launcher for f32, one
    counted launch either way; the other launcher is never reached."""
    tdt = DTYPES[dtype][1]
    p = tray.pack_ray_mlp_params(_head("narrow")[0], dtype=tdt)
    feat, z = _inputs(p, 9, 6)
    seen = []

    def fake_wgmma(packed, f, zz):
        seen.append(("wgmma", f.dtype, tuple(f.shape), zz.dtype,
                     tuple(zz.shape), f.is_contiguous()))
        return torch.zeros(f.shape[0], zz.shape[1], packed.out_dim)

    def fake_packed(library, function, packed, f, n_rays, taps, z=None):
        seen.append(("fma", function, tuple(f.shape), n_rays, taps))
        return torch.zeros(n_rays, taps, packed.out_dim)

    monkeypatch.setattr(tray, "launch_ray_wgmma", fake_wgmma)
    monkeypatch.setattr(tray, "launch_packed", fake_packed)
    before = tray.apply_ray.launches
    out = tray._launch_ray(p, feat, z)
    assert tray.apply_ray.launches == before + 1
    assert out.shape == (1, 9, 6, p.out_dim)
    if dtype == "bf16":
        assert seen == [("wgmma", torch.bfloat16, (9, p.widths[0]),
                         torch.float32, (9, 6), True)]
    else:
        assert seen == [("fma", "fused_ray_mlp_forward", (9, p.widths[0]),
                         9, 6)]


def test_apply_ray_dispatch_bf16_on_cpu():
    """A bf16 ray pack on CPU tensors takes the plain version and is no
    launch; a device with no path raises."""
    p = tray.pack_ray_mlp_params(_head("narrow")[0])
    feat, z = _inputs(p, 9, 6)
    before = tray.apply_ray.launches
    torch.testing.assert_close(tray.apply_ray(p, feat, z),
                               tray.apply_ray_plain(p, feat, z), rtol=0,
                               atol=0)
    assert tray.apply_ray.launches == before
    with pytest.raises(ValueError):
        tray.apply_ray(p, feat.to("meta"), z.to("meta"))


def test_streamed_bytes_count_every_tap_block():
    """Each (64-ray block, tap) streams the whole weight stream and its
    feature tile once a pass of each layer."""
    p = tray.pack_ray_mlp_params(_head("netG")[0])
    per_block = p.tiles.numel() * 2 + (2 + 4) * 64 * 256 * 2
    assert wgmma.streamed_bytes(p, 65, 6) == 2 * 6 * per_block
    assert wgmma.streamed_bytes(p, 64, 1) == per_block

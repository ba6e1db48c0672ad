"""PyTorch port, on the card: the four CUDA MLP kernels (ray, anchored,
per-point, gathering ray) against their plain versions (f32 atol 2e-5 /
rtol 1e-4, bf16 atol 2e-2), at the published head widths, a narrow test
head and two wide heads (the bf16 kernel's scratch mode, the f32 route's
activation scratch; on netG either scratch equals its in-place run bit for
bit), T in {1, 6, 33}, K in {1, 2, 3, 5}, ragged ray and point counts, uv
beyond the image for the gather, and a scratch small enough that the f32
launcher walks the rays in several chunks; the bf16 per-point and ray
kernels are one launch each with no scratch, the bf16 anchored and
gathering routes one weighted-row pass and one wgmma launch each, and the
pass (``csrc/mix_rows.cuh``) equals ``mix_rows_plain`` within one bf16 ulp.

Imports no JAX, so it runs where only PyTorch is installed:
``python -m pytest tests/test_torch_cuda.py --noconftest -q`` on a machine
with a CUDA card. Without one every test skips."""

import numpy as np
import pytest
import torch

from monoport_tpu_torch.models.heads import SurfaceClassifier
from monoport_tpu_torch.ops.cuda import fused_gather_mlp as tgather
from monoport_tpu_torch.ops.cuda import fused_mlp as tmlp
from monoport_tpu_torch.ops.cuda import fused_ray_mlp as tray
from monoport_tpu_torch.ops.cuda import mix_rows
from torch_wgmma_walk import bf16_ulps

# "wide" (WIDE_NETG_HEAD) and "wide_c": heads the in-place bf16 kernel
# cannot hold, which run its scratch mode and the f32 route's activation
# scratch
HEADS = {"netG": ((257, 1024, 512, 256, 128, 1), "sigmoid"),
         "netC": ((513, 1024, 512, 256, 128, 3), "tanh"),
         "small": ((65, 1024, 512, 256, 128, 1), "sigmoid"),
         "wide": ((257, 2048, 1024, 768, 128, 1), "sigmoid"),
         "wide_c": ((97, 1536, 640, 64, 3), "tanh")}
TOL = {torch.float32: dict(atol=2e-5, rtol=1e-4),
       torch.bfloat16: dict(atol=2e-2, rtol=0.0)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _head(name: str) -> SurfaceClassifier:
    chans, last_op = HEADS[name]
    head = SurfaceClassifier(chans, last_op=last_op)
    rng = np.random.RandomState(7)
    with torch.no_grad():
        for lin in head.layers():
            fan_in = lin.weight.shape[1]
            lin.weight.copy_(torch.from_numpy(rng.randn(
                *lin.weight.shape).astype(np.float32) / np.sqrt(fan_in)))
            lin.bias.copy_(torch.from_numpy(
                rng.randn(*lin.bias.shape).astype(np.float32) * 0.1))
    return head


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(HEADS))
def test_kernel_matches_twin(card, name, dtype):
    p = tray.pack_ray_mlp_params(_head(name), dtype=dtype, device=card)
    rng = np.random.RandomState(3)
    rays = 301                                   # not a multiple of a tile
    feat = torch.from_numpy(rng.randn(1, rays, p.c_f).astype(
        np.float32)).to(card)
    for taps in (1, 6, 33):
        z = torch.from_numpy(rng.uniform(-1.3, 1.3, (1, rays, taps)).astype(
            np.float32)).to(card)
        before = tray.apply_ray.launches
        got = tray.apply_ray(p, feat, z)
        torch.cuda.synchronize()
        assert tray.apply_ray.launches == before + 1
        assert got.shape == (1, rays, taps, p.out_dim)
        torch.testing.assert_close(got, tray.apply_ray_plain(p, feat, z),
                                   **TOL[dtype])


@pytest.mark.cuda
def test_kernel_rejects_operands_on_another_device(card):
    p = tray.pack_ray_mlp_params(_head("small"), dtype=torch.float32)
    feat = torch.zeros(1, 4, p.c_f, device=card)
    with pytest.raises(ValueError):
        tray.apply_ray(p, feat, torch.zeros(1, 4, 6, device=card))


def _hat_weights(rng, rays: int, taps: int, k: int) -> np.ndarray:
    alpha = np.sort(rng.rand(1, rays, taps).astype(np.float32), axis=-1)
    pos = alpha[..., None] * (k - 1) - np.arange(k, dtype=np.float32)
    return np.maximum(0.0, 1.0 - np.abs(pos)).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(HEADS))
def test_anchor_kernel_matches_plain(card, name, dtype):
    p = tray.pack_ray_mlp_params(_head(name), dtype=dtype, device=card)
    rng = np.random.RandomState(4)
    rays = 301
    for k, taps in ((1, 6), (2, 5), (3, 6), (5, 6), (3, 1)):
        feat = torch.from_numpy(rng.randn(1, rays, k, p.c_f).astype(
            np.float32)).to(card)
        w = torch.from_numpy(_hat_weights(rng, rays, taps, k)).to(card)
        z = torch.from_numpy(rng.uniform(-1.3, 1.3, (1, rays, taps)).astype(
            np.float32)).to(card)
        before = tray.apply_anchor.launches
        got = tray.apply_anchor(p, feat, w, z)
        torch.cuda.synchronize()
        assert tray.apply_anchor.launches == before + 1
        assert got.shape == (1, rays, taps, p.out_dim)
        torch.testing.assert_close(
            got, tray.apply_anchor_plain(p, feat, w, z), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(HEADS))
def test_point_kernel_matches_plain(card, name, dtype):
    p = tmlp.pack_mlp_params(_head(name), dtype=dtype, device=card)
    rng = np.random.RandomState(5)
    # ragged around the 64-point block, and one past a full wave of blocks
    for points in (1, 63, 64, 65, 77, 4097, 262145):
        x = torch.from_numpy(rng.randn(1, points, p.c_f).astype(
            np.float32)).to(card)
        before = tmlp.apply_mlp.launches
        got = tmlp.apply_mlp(p, x)
        torch.cuda.synchronize()
        assert tmlp.apply_mlp.launches == before + 1
        assert got.shape == (1, points, p.out_dim)
        torch.testing.assert_close(got, tmlp.apply_mlp_plain(p, x),
                                   **TOL[dtype])


@pytest.mark.cuda
def test_chunked_launch_equals_one_chunk(card, monkeypatch):
    """A scratch of a few rows makes the launcher walk the rays in many
    chunks: the result is bit-identical to the single-chunk launch. Every
    kernel chunks in f32 only (the bf16 routes have no scratch)."""
    p = tray.pack_ray_mlp_params(_head("netG"), dtype=torch.float32,
                                 device=card)
    pm = tmlp.pack_mlp_params(_head("netG"), dtype=torch.float32,
                              device=card)
    rng = np.random.RandomState(6)
    rays, k, taps = 1500, 3, 6
    feat = torch.from_numpy(rng.randn(1, rays, k, p.c_f).astype(
        np.float32)).to(card)
    w = torch.from_numpy(_hat_weights(rng, rays, taps, k)).to(card)
    z = torch.from_numpy(rng.uniform(-1.3, 1.3, (1, rays, taps)).astype(
        np.float32)).to(card)
    x = torch.from_numpy(rng.randn(1, 9000, pm.c_f).astype(
        np.float32)).to(card)
    whole = (tray.apply_anchor(p, feat, w, z), tray.apply_ray(
        p, feat[:, :, 0], z), tmlp.apply_mlp(pm, x))
    ntot = sum(p.widths[1:])
    monkeypatch.setattr(tray, "XP_SCRATCH_BYTES", 4 * ntot * 700)
    parts = (tray.apply_anchor(p, feat, w, z), tray.apply_ray(
        p, feat[:, :, 0], z), tmlp.apply_mlp(pm, x))
    torch.cuda.synchronize()
    for a, b in zip(whole, parts):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.cuda
def test_bf16_point_kernel_is_one_launch_without_scratch(card, monkeypatch):
    """bf16 apply_mlp never reaches the scratch launcher, allocates only its
    input copy and output, and runs as one device kernel (no xproj)."""
    p = tmlp.pack_mlp_params(_head("netG"), dtype=torch.bfloat16, device=card)
    x = torch.from_numpy(np.random.RandomState(9).randn(1, 9000, p.c_f).astype(
        np.float32)).to(card)
    tmlp.apply_mlp(p, x)                         # build and warm up
    torch.cuda.synchronize()

    def refuse(*args, **kwargs):
        raise AssertionError("bf16 apply_mlp reached the scratch launcher")

    monkeypatch.setattr(tmlp, "launch_packed", refuse)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        tmlp.apply_mlp(p, x)
        torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    # x as f32 -> bf16 -> padded, and the f32 output, with allocator slack;
    # the f32 projection scratch alone would be 64 MiB
    assert extra < 9000 * (p.c_f * 2 + p.widths[0] * 2 + 4) + (2 << 20)
    mlp = [(e.key, e.count) for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and "mlp" in e.key]
    assert len(mlp) == 1 and "wgmma_mlp_kernel" in mlp[0][0], mlp
    assert mlp[0][1] == 1, mlp
    assert not any("xproj" in e.key for e in prof.key_averages())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["netC", "netG"])
def test_bf16_ray_kernel_matches_plain_at_ragged_shapes(card, name):
    """The bf16 ray kernel (wgmma) against the plain version: ray counts
    around the 64-ray block (1, 63, 65) and the march's 1,089, each at 1, 6
    and 33 taps."""
    p = tray.pack_ray_mlp_params(_head(name), dtype=torch.bfloat16,
                                 device=card)
    rng = np.random.RandomState(10)
    for rays in (1, 63, 65, 1089):
        feat = torch.from_numpy(rng.randn(1, rays, p.c_f).astype(
            np.float32)).to(card)
        for taps in (1, 6, 33):
            z = torch.from_numpy(rng.uniform(-1.3, 1.3, (1, rays, taps))
                                 .astype(np.float32)).to(card)
            before = tray.apply_ray.launches
            got = tray.apply_ray(p, feat, z)
            torch.cuda.synchronize()
            assert tray.apply_ray.launches == before + 1
            assert got.shape == (1, rays, taps, p.out_dim)
            torch.testing.assert_close(got, tray.apply_ray_plain(p, feat, z),
                                       **TOL[torch.bfloat16])


@pytest.mark.cuda
def test_bf16_ray_kernel_is_one_launch_without_scratch(card, monkeypatch):
    """bf16 apply_ray never reaches the scratch launcher, allocates only its
    input copies and output, and runs as one device kernel (no xproj)."""
    p = tray.pack_ray_mlp_params(_head("netG"), dtype=torch.bfloat16,
                                 device=card)
    rng = np.random.RandomState(9)
    rays, taps = 9000, 6
    feat = torch.from_numpy(rng.randn(1, rays, p.c_f).astype(
        np.float32)).to(card)
    z = torch.from_numpy(rng.uniform(-1.3, 1.3, (1, rays, taps)).astype(
        np.float32)).to(card)
    tray.apply_ray(p, feat, z)                   # build and warm up
    torch.cuda.synchronize()

    def refuse(*args, **kwargs):
        raise AssertionError("bf16 apply_ray reached the scratch launcher")

    monkeypatch.setattr(tray, "launch_packed", refuse)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        tray.apply_ray(p, feat, z)
        torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    # feat as bf16 (padded), z, and the f32 output, with allocator slack;
    # the f32 projection scratch alone would be 64 MiB
    assert extra < rays * (p.c_f * 2 + p.widths[0] * 2 + taps * 8) + (2 << 20)
    mlp = [(e.key, e.count) for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and "mlp" in e.key]
    assert len(mlp) == 1 and "wgmma_mlp_kernel" in mlp[0][0], mlp
    assert "RayEpilogue" in mlp[0][0] and mlp[0][1] == 1, mlp
    assert not any("xproj" in e.key for e in prof.key_averages())


@pytest.mark.cuda
def test_anchor_kernel_rejects_bad_shapes(card):
    p = tray.pack_ray_mlp_params(_head("small"), dtype=torch.float32,
                                 device=card)
    z = torch.zeros(1, 4, 6, device=card)
    with pytest.raises(ValueError):          # w_taps is not [B, R, T, K]
        tray.apply_anchor(p, torch.zeros(1, 4, 2, p.c_f, device=card),
                          torch.zeros(1, 4, 6, 3, device=card), z)
    with pytest.raises(ValueError):          # more anchors than the kernel takes
        tray.apply_anchor(p, torch.zeros(1, 4, 9, p.c_f, device=card),
                          torch.zeros(1, 4, 6, 9, device=card), z)


def _gather_inputs(card, p, rays: int, taps: int, hw=(24, 20), seed=8):
    rng = np.random.RandomState(seed)
    to = lambda a: torch.from_numpy(a.astype(np.float32)).to(card)
    return (to(rng.randn(1, *hw, p.c_f)),
            to(rng.uniform(-1.2, 1.2, (1, rays, 2))),    # some taps outside
            to(rng.uniform(-1.3, 1.3, (1, rays, taps))))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(HEADS))
def test_gather_kernel_matches_plain(card, name, dtype):
    p = tray.pack_ray_mlp_params(_head(name), dtype=dtype, device=card)
    for taps in (1, 6):
        fmap, uv, z = _gather_inputs(card, p, 301, taps)
        before = tgather.apply_gather_ray.launches
        got = tgather.apply_gather_ray(p, fmap, uv, z)
        torch.cuda.synchronize()
        assert tgather.apply_gather_ray.launches == before + 1
        assert got.shape == (1, 301, taps, p.out_dim)
        torch.testing.assert_close(
            got, tgather.apply_gather_plain(p, fmap, uv, z), **TOL[dtype])


@pytest.mark.cuda
def test_gather_kernel_chunked_equals_one_chunk(card, monkeypatch):
    """The f32 route chunks (bf16 has no scratch)."""
    p = tray.pack_ray_mlp_params(_head("netG"), dtype=torch.float32,
                                 device=card)
    fmap, uv, z = _gather_inputs(card, p, 1500, 6)
    whole = tgather.apply_gather_ray(p, fmap, uv, z)
    monkeypatch.setattr(tray, "XP_SCRATCH_BYTES",
                        4 * sum(p.widths[1:]) * 700)
    parts = tgather.apply_gather_ray(p, fmap, uv, z)
    torch.cuda.synchronize()
    torch.testing.assert_close(whole, parts, atol=0, rtol=0)


@pytest.mark.cuda
def test_gather_kernel_rejects_a_batch(card):
    p = tray.pack_ray_mlp_params(_head("small"), dtype=torch.float32,
                                 device=card)
    fmap, uv, z = _gather_inputs(card, p, 8, 2)
    with pytest.raises(ValueError, match="batch 1"):
        tgather.apply_gather_ray(p, fmap.repeat(2, 1, 1, 1),
                                 uv.repeat(2, 1, 1), z.repeat(2, 1, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [20, 64, 256, 512])
def test_mix_kernel_matches_plain(card, c):
    """The weighted-row pass against ``mix_rows_plain`` on the card, both
    forms (the anchors split hi | lo), within one bf16 ulp, zero past the
    table's width; a width that is no multiple of 8 is padded by the
    launcher."""
    rng = np.random.RandomState(11)
    c_pad = -(-c // 32) * 32
    k, rays, taps = 3, 301, 6
    to = lambda a: torch.from_numpy(a).to(card)
    table = to(rng.randn(rays * k, c).astype(np.float32)).to(torch.bfloat16)
    w = to(_hat_weights(rng, rays, taps, k)[0].reshape(-1, k))
    before = mix_rows.launch_mix_rows.launches
    got = mix_rows.launch_mix_rows("fused_ray_mlp", "mix_anchor_rows", table,
                                   w, taps=taps, c_pad=c_pad, split=True)
    want = mix_rows.mix_rows_plain(table, w, taps=taps, c_pad=c_pad,
                                   split=True)
    torch.cuda.synchronize()
    assert got.shape == (rays * taps, 2 * c_pad)
    assert int(bf16_ulps(got, want).max()) <= 1
    assert not got[:, c:c_pad].float().abs().any()
    assert not got[:, c_pad + c:].float().abs().any()
    gtable = to(rng.randn(500, c).astype(np.float32)).to(torch.bfloat16)
    idx = to(rng.randint(0, 500, (rays, 4)).astype(np.int32))
    wgt = to(rng.rand(rays, 4).astype(np.float32))
    wgt[::5, 2] = 0.0
    got = mix_rows.launch_mix_rows("fused_gather_mlp", "mix_gather_rows",
                                   gtable, wgt, idx=idx, c_pad=c_pad)
    want = mix_rows.mix_rows_plain(gtable, wgt, idx=idx, c_pad=c_pad)
    torch.cuda.synchronize()
    assert int(bf16_ulps(got, want).max()) <= 1
    assert mix_rows.launch_mix_rows.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["netC", "netG"])
def test_bf16_anchor_kernel_matches_plain_at_ragged_shapes(card, name):
    """The bf16 anchored route (pass + wgmma) against the plain version (the
    TPU kernel's math): ray counts around the 64-row block, K in {2, 3, 5},
    T in {1, 6}."""
    p = tray.pack_ray_mlp_params(_head(name), dtype=torch.bfloat16,
                                 device=card)
    rng = np.random.RandomState(12)
    to = lambda a: torch.from_numpy(a.astype(np.float32)).to(card)
    for rays in (1, 11, 63, 65, 301):
        for k, taps in ((2, 6), (3, 6), (5, 6), (3, 1)):
            feat = to(rng.randn(1, rays, k, p.c_f))
            w = to(_hat_weights(rng, rays, taps, k))
            z = to(rng.uniform(-1.3, 1.3, (1, rays, taps)))
            before = tray.apply_anchor.launches
            got = tray.apply_anchor(p, feat, w, z)
            torch.cuda.synchronize()
            assert tray.apply_anchor.launches == before + 1
            assert got.shape == (1, rays, taps, p.out_dim)
            torch.testing.assert_close(
                got, tray.apply_anchor_plain(p, feat, w, z),
                **TOL[torch.bfloat16])


def _device_kernels(fn):
    """(name, calls) of every device kernel ``fn`` launches."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.key, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


@pytest.mark.cuda
def test_bf16_anchor_route_is_one_pass_and_one_launch(card, monkeypatch):
    """bf16 apply_anchor never reaches the scratch launcher: one weighted-row
    pass and one wgmma launch (AnchorEpilogue), no xproj, no mma.sync layer
    kernel, and no memory beyond its inputs' copies, the mixed rows and the
    output (the f32 scratch alone would be 64 MiB)."""
    p = tray.pack_ray_mlp_params(_head("netG"), dtype=torch.bfloat16,
                                 device=card)
    rng = np.random.RandomState(13)
    rays, k, taps = 9000, 3, 6
    to = lambda a: torch.from_numpy(a.astype(np.float32)).to(card)
    feat = to(rng.randn(1, rays, k, p.c_f))
    w = to(_hat_weights(rng, rays, taps, k))
    z = to(rng.uniform(-1.3, 1.3, (1, rays, taps)))
    tray.apply_anchor(p, feat, w, z)             # build and warm up
    torch.cuda.synchronize()

    def refuse(*args, **kwargs):
        raise AssertionError("bf16 apply_anchor reached the scratch launcher")

    monkeypatch.setattr(tray, "launch_packed", refuse)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = mix_rows.launch_mix_rows.launches
    kernels = _device_kernels(lambda: tray.apply_anchor(p, feat, w, z))
    extra = torch.cuda.max_memory_allocated() - base
    assert mix_rows.launch_mix_rows.launches == before + 1
    rows = rays * taps
    assert extra < (rays * k * p.c_f * 2 + rows * (p.widths[0] * 4 + 4 * k
                                                   + 4 + 4 * p.out_dim)
                    + (2 << 20))
    ours = [(n, c) for n, c in kernels if "mlp" in n or "mix_rows" in n]
    assert len(ours) == 2 and all(c == 1 for _, c in ours), ours
    assert any("wgmma_mlp_kernel" in n and "AnchorEpilogue" in n
               for n, _ in ours), ours
    assert any("mix_rows_kernel" in n for n, _ in ours), ours
    assert not any("xproj" in n or "RayEpilogue" in n for n, _ in kernels)


@pytest.mark.cuda
def test_bf16_gather_route_is_one_pass_and_one_ray_launch(card):
    """bf16 apply_gather_ray: one weighted-row pass and one launch of the ray
    MLP's wgmma kernel (RayEpilogue), counted on apply_gather_ray only."""
    p = tray.pack_ray_mlp_params(_head("netG"), dtype=torch.bfloat16,
                                 device=card)
    fmap, uv, z = _gather_inputs(card, p, 4000, 6)
    tgather.apply_gather_ray(p, fmap, uv, z)     # build and warm up
    torch.cuda.synchronize()
    before = (tgather.apply_gather_ray.launches, tray.apply_ray.launches,
              mix_rows.launch_mix_rows.launches)
    kernels = _device_kernels(lambda: tgather.apply_gather_ray(p, fmap, uv,
                                                               z))
    assert (tgather.apply_gather_ray.launches, tray.apply_ray.launches,
            mix_rows.launch_mix_rows.launches) == (
                before[0] + 1, before[1], before[2] + 1)
    ours = [(n, c) for n, c in kernels if "mlp" in n or "mix_rows" in n]
    assert len(ours) == 2 and all(c == 1 for _, c in ours), ours
    assert any("wgmma_mlp_kernel" in n and "RayEpilogue" in n
               for n, _ in ours), ours
    assert any("mix_rows_kernel" in n for n, _ in ours), ours


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scratch_mode_equals_in_place_on_netg(card, dtype, monkeypatch):
    """The published netG head forced through the scratch modes (bf16: the
    activations in the device-memory ping-pong, streamed back by TMA; f32:
    the activation scratch, a persistent grid) gives the in-place run's
    output bit for bit: the same products in the same order."""
    from monoport_tpu_torch.ops.cuda import wgmma

    p = tray.pack_ray_mlp_params(_head("netG"), dtype=dtype, device=card)
    pm = tmlp.pack_mlp_params(_head("netG"), dtype=dtype, device=card)
    rng = np.random.RandomState(12)
    rays, taps = 5000, 6
    feat = torch.from_numpy(rng.randn(1, rays, p.c_f).astype(
        np.float32)).to(card)
    z = torch.from_numpy(rng.uniform(-1.3, 1.3, (1, rays, taps)).astype(
        np.float32)).to(card)
    x = torch.from_numpy(rng.randn(1, 40000, pm.c_f).astype(
        np.float32)).to(card)
    k = 3
    fk = torch.from_numpy(rng.randn(1, rays, k, p.c_f).astype(
        np.float32)).to(card)
    w = torch.from_numpy(_hat_weights(rng, rays, taps, k)).to(card)
    run = lambda: (tray.apply_ray(p, feat, z), tmlp.apply_mlp(pm, x),
                   tray.apply_anchor(p, fk, w, z))
    base = run()
    if dtype == torch.bfloat16:
        monkeypatch.setattr(wgmma, "needs_scratch", lambda widths: True)
    else:
        monkeypatch.setattr(tray.RayMlpPacked, "f32_scratch",
                            property(lambda self: True))
    forced = run()
    torch.cuda.synchronize()
    for a, b in zip(base, forced):
        torch.testing.assert_close(a, b, atol=0, rtol=0)

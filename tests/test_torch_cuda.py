"""PyTorch port, on the card: the four CUDA MLP kernels (ray, anchored,
per-point, gathering ray) against their plain versions (f32 atol 2e-5 /
rtol 1e-4, bf16 atol 2e-2), at the published head widths and a narrow test
head, T in {1, 6, 33}, K in {1, 2, 3, 5}, ragged ray and point counts, uv
beyond the image for the gather, and a scratch small enough that the
launcher walks the rays in several chunks.

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

HEADS = {"netG": ((257, 1024, 512, 256, 128, 1), "sigmoid"),
         "netC": ((513, 1024, 512, 256, 128, 3), "tanh"),
         "small": ((65, 1024, 512, 256, 128, 1), "sigmoid")}
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
    for points in (77, 4097):
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
    chunks: the result is bit-identical to the single-chunk launch."""
    p = tray.pack_ray_mlp_params(_head("netG"), dtype=torch.bfloat16,
                                 device=card)
    pm = tmlp.pack_mlp_params(_head("netG"), dtype=torch.bfloat16,
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
    p = tray.pack_ray_mlp_params(_head("netG"), dtype=torch.bfloat16,
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

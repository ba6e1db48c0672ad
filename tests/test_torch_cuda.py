"""PyTorch port, on the card: the CUDA ray-MLP kernel against its plain
twin (f32 atol 2e-5 / rtol 1e-4, bf16 atol 2e-2), at the published head
widths and a narrow test head, T in {1, 6, 33}, a ragged ray count.

Imports no JAX, so it runs where only PyTorch is installed:
``python -m pytest tests/test_torch_cuda.py --noconftest -q`` on a machine
with a CUDA card. Without one every test skips."""

import numpy as np
import pytest
import torch

from monoport_tpu_torch.models.heads import SurfaceClassifier
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

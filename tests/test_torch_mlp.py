"""PyTorch port, per-point MLP: ``apply_mlp_plain`` (the CUDA kernel's
plain version, with the kernel's rounding points) against the JAX kernel
``fused_mlp.apply_packed(interpret=True)`` and against the port's
``SurfaceClassifier``, for the G and C head shapes at narrow hidden widths,
N = 77 points (no multiple of any tile).

f32: atol 2e-5 / rtol 1e-4; bf16: atol 2e-2 (the JAX package's own kernel
tolerances). The kernel itself runs only on the card
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from monoport_tpu.ops.pallas import fused_mlp as jmlp
from monoport_tpu_torch.models.heads import SurfaceClassifier
from monoport_tpu_torch.ops.cuda import fused_mlp as tmlp

torch.set_num_threads(2)
N = 77
HEADS = {"G": ((257, 96, 64, 48, 1), "sigmoid"),
         "C": ((513, 96, 64, 48, 3), "tanh")}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module", params=sorted(HEADS))
def head(request):
    chans, last_op = HEADS[request.param]
    rng = np.random.RandomState(5)
    params = {}
    for i in range(len(chans) - 1):
        fan_in = chans[i] + (chans[0] if i else 0)
        params[f"filters_{i}"] = {
            "kernel": (rng.randn(fan_in, chans[i + 1])
                       / np.sqrt(fan_in)).astype(np.float32),
            "bias": (rng.randn(chans[i + 1]) * 0.1).astype(np.float32)}
    port = SurfaceClassifier(chans, last_op=last_op)
    with torch.no_grad():
        for i, lin in enumerate(port.layers()):
            lin.weight.copy_(torch.from_numpy(
                params[f"filters_{i}"]["kernel"].T))
            lin.bias.copy_(torch.from_numpy(params[f"filters_{i}"]["bias"]))
    x = rng.randn(1, N, chans[0]).astype(np.float32)
    return {"params": params, "chans": chans, "last_op": last_op,
            "port": port, "x": x}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_matches_pallas_interpret(head, dtype):
    jdt, tdt = DTYPES[dtype]
    packed = jmlp.pack_mlp_params(head["params"], head["chans"], jdt)
    want = jmlp.apply_packed(packed, jnp.asarray(head["x"]), head["last_op"],
                             tile_n=64, compute_dtype=jdt, interpret=True)
    p = tmlp.pack_mlp_params(head["port"], dtype=tdt)
    got = tmlp.apply_mlp_plain(p, torch.from_numpy(head["x"]))
    assert got.shape == (1, N, head["chans"][-1])
    assert got.dtype == torch.float32
    if dtype == "f32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                                   rtol=1e-4)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-2)


def test_plain_matches_surface_classifier(head):
    p = tmlp.pack_mlp_params(head["port"], dtype=torch.float32)
    x = torch.from_numpy(head["x"])
    with torch.no_grad():
        want = head["port"](x)
    torch.testing.assert_close(tmlp.apply_mlp_plain(p, x), want, atol=2e-5,
                               rtol=1e-4)


def test_packing_keeps_z_as_an_operand_column(head):
    """The whole input, z included, is a column block of ``wf`` in the
    compute dtype (the TPU kernel rounds z with the rest); ``wz`` is 0."""
    p = tmlp.pack_mlp_params(head["port"], dtype=torch.bfloat16)
    c_in = head["chans"][0]
    assert p.c_f == c_in and p.widths[0] == -(-c_in // 32) * 32
    assert p.wf.dtype == torch.bfloat16 and p.wz.abs().sum() == 0
    lin0 = head["port"].layers()[0]
    torch.testing.assert_close(
        p.wf[:lin0.weight.shape[0], :c_in].float(),
        lin0.weight.detach().to(torch.bfloat16).float(), atol=0, rtol=0)
    assert p.wf[:, c_in:].abs().sum() == 0


def test_apply_mlp_dispatch_on_cpu(head):
    """A CPU tensor takes the plain version and does not count as a
    launch; a device with no path raises."""
    p = tmlp.pack_mlp_params(head["port"], dtype=torch.float32)
    x = torch.from_numpy(head["x"])
    before = tmlp.apply_mlp.launches
    torch.testing.assert_close(tmlp.apply_mlp(p, x),
                               tmlp.apply_mlp_plain(p, x), rtol=0, atol=0)
    assert tmlp.apply_mlp.launches == before
    with pytest.raises(ValueError):
        tmlp.apply_mlp(p, x.to("meta"))

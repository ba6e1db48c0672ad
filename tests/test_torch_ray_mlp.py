"""PyTorch port, ray MLP: ``apply_ray_plain`` (the CUDA kernel's twin, with
the kernel's rounding points) against the JAX ray kernel at both published
head widths, R=40 rays.

T in {1, 6}: against ``apply_ray_packed(..., interpret=True)``, f32 at
atol 2e-5 / rtol 1e-4 and bf16 at atol 2e-2 (the JAX package's own
kernel tolerances). T=33: against ``apply_ray_xla`` in f32, which is the
kernel's own math there (keeps a 33-tap interpret compile out of Tier-1).
``apply_anchor_plain`` (the anchored kernel's plain version): against
``apply_anchor_packed(..., interpret=True)`` for K in {1, 2, 3, 5}, T in
{1, 5, 6} at the same tolerances, with real hat weights (two neighbouring
anchors summing to 1); K = 1 with weight 1 equals ``apply_ray_plain``.
The kernels themselves run only on the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from monoport_tpu.models.heads import PIFuNetCMLP, PIFuNetGMLP
from monoport_tpu.ops.pallas import fused_ray_mlp as jray
from monoport_tpu_torch import weights
from monoport_tpu_torch.models.heads import HEAD_SPECS, SurfaceClassifier
from monoport_tpu_torch.ops.cuda import fused_ray_mlp as tray

torch.set_num_threads(2)
R = 40
HEADS = {"G": (PIFuNetGMLP, "PIFuNetGMLP"), "C": (PIFuNetCMLP, "PIFuNetCMLP")}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module", params=["G", "C"])
def head(request):
    factory, name = HEADS[request.param]
    chans, last_op = HEAD_SPECS[name]
    net = factory()
    x = jnp.zeros((1, 8, chans[0]), jnp.float32)
    variables = net.init(jax.random.PRNGKey(0), x)
    params = jax.tree.map(lambda a: np.asarray(a, np.float32),
                          variables["params"])
    port = SurfaceClassifier(chans, last_op=last_op)
    port.load_state_dict(weights.torch_state_from_flax(params))
    rng = np.random.RandomState(1)
    feat = rng.randn(1, R, chans[0] - 1).astype(np.float32)
    z = rng.uniform(-1, 1, (1, R, 33)).astype(np.float32)
    return {"params": params, "chans": chans, "last_op": last_op,
            "port": port, "feat": feat, "z": z}


def _port(head, dtype, taps):
    packed = tray.pack_ray_mlp_params(head["port"], dtype=dtype)
    return tray.apply_ray_plain(packed, torch.from_numpy(head["feat"]),
                                torch.from_numpy(head["z"][..., :taps]))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("taps", [1, 6])
def test_plain_matches_pallas_interpret(head, dtype, taps):
    jdt, tdt = DTYPES[dtype]
    packed = jray.pack_ray_mlp_params(head["params"], head["chans"], jdt)
    want = jray.apply_ray_packed(packed, jnp.asarray(head["feat"]),
                                 jnp.asarray(head["z"][..., :taps]),
                                 head["last_op"], tile_r=64,
                                 compute_dtype=jdt, interpret=True)
    got = _port(head, tdt, taps)
    assert got.shape == (1, R, taps, head["chans"][-1])
    assert got.dtype == torch.float32
    if dtype == "f32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                                   rtol=1e-4)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-2)


def test_plain_matches_xla_33_taps(head):
    packed = jray.pack_ray_mlp_params(head["params"], head["chans"],
                                      jnp.float32)
    want = jray.apply_ray_xla(packed, jnp.asarray(head["feat"]),
                              jnp.asarray(head["z"]), head["last_op"],
                              compute_dtype=jnp.float32)
    got = _port(head, torch.float32, 33)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)


def test_packing_pads_to_kernel_tiles(head):
    p = tray.pack_ray_mlp_params(head["port"], dtype=torch.bfloat16)
    assert all(w % tray.PAD == 0 for w in p.widths)
    assert p.widths[1:] == (1024, 512, 256, 128, 32)
    assert p.wf.dtype == p.wh.dtype == torch.bfloat16
    assert p.wz.dtype == p.b.dtype == torch.float32
    assert p.out_dim == head["chans"][-1]
    # the padded rows / columns are zero, so they change nothing
    assert p.wf[sum(p.widths[1:-1]) + p.out_dim:].abs().sum() == 0


def test_apply_ray_dispatch_on_cpu(head):
    """A CPU tensor takes the twin and does not count as a launch; a device
    with no path raises."""
    p = tray.pack_ray_mlp_params(head["port"], dtype=torch.float32)
    feat = torch.from_numpy(head["feat"])
    z = torch.from_numpy(head["z"][..., :6])
    before = tray.apply_ray.launches
    torch.testing.assert_close(tray.apply_ray(p, feat, z),
                               tray.apply_ray_plain(p, feat, z),
                               rtol=0, atol=0)
    assert tray.apply_ray.launches == before
    with pytest.raises(ValueError):
        tray.apply_ray(p, feat.to("meta"), z.to("meta"))


def _hat_weights(alpha: np.ndarray, k: int) -> np.ndarray:
    pos = alpha[..., None] * (k - 1) - np.arange(k, dtype=np.float32)
    return np.maximum(0.0, 1.0 - np.abs(pos)).astype(np.float32)


def _anchor_inputs(head, k, taps):
    rng = np.random.RandomState(10 * k + taps)
    c_f = head["chans"][0] - 1
    feat_k = rng.randn(1, R, k, c_f).astype(np.float32)
    alpha = np.sort(rng.rand(1, R, taps).astype(np.float32), axis=-1)
    return feat_k, _hat_weights(alpha, k), head["z"][..., :taps]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("k,taps", [(1, 6), (2, 5), (3, 6), (5, 6), (3, 1)])
def test_anchor_plain_matches_pallas_interpret(head, dtype, k, taps):
    jdt, tdt = DTYPES[dtype]
    feat_k, w, z = _anchor_inputs(head, k, taps)
    packed = jray.pack_ray_mlp_params(head["params"], head["chans"], jdt)
    want = jray.apply_anchor_packed(packed, jnp.asarray(feat_k),
                                    jnp.asarray(w), jnp.asarray(z),
                                    head["last_op"], tile_r=64,
                                    compute_dtype=jdt, interpret=True)
    p = tray.pack_ray_mlp_params(head["port"], dtype=tdt)
    got = tray.apply_anchor_plain(p, torch.from_numpy(feat_k),
                                  torch.from_numpy(w), torch.from_numpy(z))
    assert got.shape == (1, R, taps, head["chans"][-1])
    assert got.dtype == torch.float32
    if dtype == "f32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                                   rtol=1e-4)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-2)


def test_one_anchor_of_weight_one_is_the_ray_mlp(head):
    p = tray.pack_ray_mlp_params(head["port"], dtype=torch.float32)
    feat = torch.from_numpy(head["feat"])
    z = torch.from_numpy(head["z"][..., :6])
    got = tray.apply_anchor_plain(p, feat[:, :, None], torch.ones(1, R, 6, 1),
                                  z)
    torch.testing.assert_close(got, tray.apply_ray_plain(p, feat, z),
                               atol=1e-6, rtol=0)


def test_apply_anchor_dispatch_on_cpu(head):
    p = tray.pack_ray_mlp_params(head["port"], dtype=torch.float32)
    feat_k, w, z = (torch.from_numpy(a) for a in _anchor_inputs(head, 3, 6))
    before = tray.apply_anchor.launches
    torch.testing.assert_close(tray.apply_anchor(p, feat_k, w, z),
                               tray.apply_anchor_plain(p, feat_k, w, z),
                               rtol=0, atol=0)
    assert tray.apply_anchor.launches == before
    with pytest.raises(ValueError):
        tray.apply_anchor(p, feat_k.to("meta"), w.to("meta"), z.to("meta"))

"""PyTorch port, gathering ray MLP: ``apply_gather_plain`` (the CUDA
kernel's twin, with its rounding points) against
monoport_tpu/ops/pallas/fused_gather_mlp.py, on the cases of
tests/test_gather_kernel.py: the Pallas kernel in interpret mode and its
XLA reference, f32 at atol 2e-5 / rtol 1e-4, one bf16 case at atol 2e-2;
``bilinear_taps`` against ``_bilinear_taps`` with uv out to +-1.3, tap
indices equal as integers. The kernel itself runs only on the card
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from monoport_tpu.ops.pallas import fused_gather_mlp as jgather
from monoport_tpu.ops.pallas.fused_ray_mlp import (apply_ray_xla,
                                                   pack_ray_mlp_params)
from monoport_tpu.ops.sampling import index as jindex
from monoport_tpu_torch import weights
from monoport_tpu_torch.models.heads import SurfaceClassifier
from monoport_tpu_torch.ops.cuda import fused_gather_mlp as tgather
from monoport_tpu_torch.ops.cuda import fused_ray_mlp as tray
from monoport_tpu_torch.ops.sampling import index as tindex

torch.set_num_threads(2)
F32 = dict(atol=2e-5, rtol=1e-4)

# name, head widths, map (h, w), rays, taps, uv range, tile_r
CASES = [("xla_reference", (33, 64, 32, 1), (12, 10), 70, 3, 1.1, 32),
         ("pregathered", (17, 48, 24, 1), (8, 8), 40, 2, 0.9, 16),
         ("per_point_taps1", (17, 32, 1), (6, 6), 33, 1, 1.0, 16),
         ("padded_width", (21, 40, 3), (7, 9), 50, 4, 1.2, 32)]


def _case(seed, chans, hw, rays, taps, span):
    rng = np.random.RandomState(seed)
    c_in = chans[0]
    params = {}
    for i in range(len(chans) - 1):
        fan_in = c_in if i == 0 else chans[i] + c_in
        params[f"filters_{i}"] = {
            "kernel": (rng.randn(fan_in, chans[i + 1]) * 0.2).astype(
                np.float32),
            "bias": (rng.randn(chans[i + 1]) * 0.1).astype(np.float32)}
    head = SurfaceClassifier(chans, last_op="sigmoid")
    head.load_state_dict(weights.torch_state_from_flax(params))
    return {"params": params, "chans": chans, "head": head,
            "map": (rng.randn(1, *hw, c_in - 1) * 0.3).astype(np.float32),
            "uv": rng.uniform(-span, span, (1, rays, 2)).astype(np.float32),
            "z": (rng.randn(1, rays, taps) * 0.5).astype(np.float32)}


def _plain(c, dtype):
    packed = tray.pack_ray_mlp_params(c["head"], dtype=dtype)
    return tgather.apply_gather_plain(
        packed, torch.from_numpy(c["map"]), torch.from_numpy(c["uv"]),
        torch.from_numpy(c["z"]))


@pytest.mark.parametrize("name,chans,hw,rays,taps,span,tile", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_matches_pallas_interpret_and_xla(name, chans, hw, rays, taps,
                                                span, tile):
    c = _case(len(name), chans, hw, rays, taps, span)
    packed = pack_ray_mlp_params(c["params"], chans, dtype=jnp.float32)
    args = (packed, jnp.asarray(c["map"]), jnp.asarray(c["uv"]),
            jnp.asarray(c["z"]), "sigmoid")
    kernel = jgather.apply_gather_ray_packed(
        *args, tile_r=tile, compute_dtype=jnp.float32, interpret=True)
    xla = jgather.apply_gather_xla(*args, compute_dtype=jnp.float32)
    got = _plain(c, torch.float32)
    assert got.shape == (1, rays, taps, chans[-1])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), **F32)
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), **F32)


def test_plain_matches_index_then_ray_mlp():
    """In f32 the gather is ``index``: the composition the frames run."""
    c = _case(7, (17, 48, 24, 1), (8, 8), 40, 2, 0.9)
    packed = tray.pack_ray_mlp_params(c["head"], dtype=torch.float32)
    fmap, uv, z = (torch.from_numpy(c[k]) for k in ("map", "uv", "z"))
    want = tray.apply_ray_plain(packed, tindex(fmap, uv), z)
    np.testing.assert_allclose(_plain(c, torch.float32).numpy(),
                               want.numpy(), **F32)
    jpacked = pack_ray_mlp_params(c["params"], c["chans"], dtype=jnp.float32)
    jwant = apply_ray_xla(jpacked, jindex(jnp.asarray(c["map"]),
                                          jnp.asarray(c["uv"])),
                          jnp.asarray(c["z"]), "sigmoid",
                          compute_dtype=jnp.float32)
    np.testing.assert_allclose(_plain(c, torch.float32).numpy(),
                               np.asarray(jwant), **F32)


def test_plain_matches_xla_reference_bf16():
    c = _case(8, (33, 64, 32, 1), (12, 10), 70, 3, 1.1)
    packed = pack_ray_mlp_params(c["params"], c["chans"], dtype=jnp.bfloat16)
    want = jgather.apply_gather_xla(
        packed, jnp.asarray(c["map"]), jnp.asarray(c["uv"]),
        jnp.asarray(c["z"]), "sigmoid", compute_dtype=jnp.bfloat16)
    np.testing.assert_allclose(_plain(c, torch.bfloat16).numpy(),
                               np.asarray(want, np.float32), atol=2e-2)


@pytest.mark.parametrize("hw", [(9, 11), (128, 128), (5, 2)])
def test_bilinear_taps_equal_jax(hw):
    rng = np.random.RandomState(0)
    uv = rng.uniform(-1.3, 1.3, (1, 400, 2)).astype(np.float32)
    uv[0, :8] = [[-1, -1], [1, 1], [-1, 1], [0, 0], [1, -1.0000001],
                 [0.5, -0.25], [1.0000001, 0], [-1.3, 1.3]]
    jidx, jwgt = jgather._bilinear_taps(jnp.asarray(uv), *hw)
    idx, wgt = tgather.bilinear_taps(torch.from_numpy(uv), *hw)
    assert idx.dtype == torch.int32 and wgt.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(wgt.numpy(), np.asarray(jwgt), atol=1e-7,
                               rtol=0)
    # taps outside the image weigh exactly 0; inside, the weights sum to 1
    inside = (np.abs(uv) <= 1.0).all(-1)
    np.testing.assert_allclose(wgt.numpy().sum(-1)[inside], 1.0, atol=1e-6)
    far = (np.abs(uv) > 1.0 + 2.0 / (min(hw) - 1)).any(-1)
    assert (wgt.numpy()[far].min(-1) == 0.0).all()


def test_wrapper_takes_one_frame_and_the_heads_width():
    c = _case(9, (17, 32, 1), (6, 6), 10, 1, 1.0)
    packed = tray.pack_ray_mlp_params(c["head"], dtype=torch.float32)
    fmap, uv, z = (torch.from_numpy(c[k]) for k in ("map", "uv", "z"))
    got = tgather.apply_gather_ray(packed, fmap, uv, z)      # CPU: plain
    np.testing.assert_array_equal(got.numpy(),
                                  _plain(c, torch.float32).numpy())
    with pytest.raises(ValueError, match="batch 1"):
        tgather.apply_gather_ray(packed, fmap.repeat(2, 1, 1, 1),
                                 uv.repeat(2, 1, 1), z.repeat(2, 1, 1))
    with pytest.raises(ValueError, match="width"):
        tgather.apply_gather_ray(packed, fmap[..., :8], uv, z)
    with pytest.raises(ValueError, match="no path"):
        tgather.apply_gather_ray(packed, fmap.to("meta"), uv, z)


def test_profile_gather_paths_agree_at_a_small_size(monkeypatch):
    """The A/B's three paths of a shape compute the same query (on the
    CPU through the plain versions): in_kernel differs from index by the
    bf16 rounding of the table only, and the entry point refuses a CPU."""
    from monoport_tpu_torch import profile_gather as pg

    shapes = (("fine", 12 * 12, 3), ("point", 50, 1))
    inputs = pg.make_inputs(seed=3, device="cpu", chans=(33, 64, 32, 1),
                            map_shape=(1, 10, 9, 32), side=12, shapes=shapes)
    assert inputs["packed"].dtype == torch.bfloat16
    fns = pg.paths(inputs)
    assert sorted(fns["fine"]) == ["grid", "in_kernel", "index"]
    assert sorted(fns["point"]) == ["in_kernel", "index"]
    for label, rays, taps in shapes:
        got = {name: fn() for name, fn in fns[label].items()}
        assert got["index"].shape == (1, rays, taps, 1)
        np.testing.assert_allclose(got["in_kernel"].numpy(),
                                   got["index"].numpy(), atol=2e-2)
    # the lattice path is the index path at the lattice's own rays
    g = inputs["grid"]
    uv = torch.stack([g["u"][0][:, None].expand(12, 12),
                      g["v"][0][None, :].expand(12, 12)], -1).reshape(1, -1, 2)
    want = tray.apply_ray(inputs["packed"], tindex(inputs["feat32"], uv),
                          g["z"])
    np.testing.assert_allclose(fns["fine"]["grid"]().numpy(), want.numpy(),
                               atol=2e-2)
    with pytest.raises(RuntimeError, match="CUDA"):
        pg.run(device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pg.run()

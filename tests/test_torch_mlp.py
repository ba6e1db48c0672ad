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
from monoport_tpu_torch.ops.cuda import wgmma

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


# The bf16 wgmma kernel's host side: the pre-tiled weight stream, the walk
# the kernel makes over it, and the launcher's checks. The kernel itself
# runs only on the card (tests/test_torch_cuda.py).
FULL_HEADS = {"netG": ((257, 1024, 512, 256, 128, 1), "sigmoid"),
              "netC": ((513, 1024, 512, 256, 128, 3), "tanh"),
              "narrow": ((65, 96, 64, 48, 1), "sigmoid")}


def _seeded_head(chans, last_op, seed=11):
    rng = np.random.RandomState(seed)
    head = SurfaceClassifier(chans, last_op=last_op)
    with torch.no_grad():
        for lin in head.layers():
            o, i = lin.weight.shape
            lin.weight.copy_(torch.from_numpy(
                (rng.randn(o, i) / np.sqrt(i)).astype(np.float32)))
            lin.bias.copy_(torch.from_numpy(
                (rng.randn(o) * 0.1).astype(np.float32)))
    return head


@pytest.mark.parametrize("name", sorted(FULL_HEADS))
def test_tiled_stream_inverts_to_wf_and_wh(name):
    """Undoing the tile permutation layer by layer gives back ``wf`` and
    ``wh`` exactly, zeros in the kernel-width padding, the biases in
    ``tile_bias``; the stream holds nothing else."""
    p = tmlp.pack_mlp_params(_seeded_head(*FULL_HEADS[name]))
    c = p.widths[0]
    assert p.tile_widths == tuple(wgmma.kernel_width(w) for w in p.widths[1:])
    pos, boff = 0, 0
    for i, off in enumerate(p.xoff):
        n_k, n = p.tile_widths[i], p.widths[i + 1]
        kh = p.tile_widths[i - 1] if i else 0
        m = wgmma.untile_layout(p.tiles[pos:pos + n_k * (kh + c)], n_k, kh + c)
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


@pytest.mark.parametrize("name", sorted(FULL_HEADS))
def test_tile_layout_is_the_core_matrix_order(name):
    """Element (n, k) of a [N_pass, 32] K-tile sits at ((k // 8) * N_pass +
    n) * 8 + k % 8 of its tile, tiles K-major within a pass of <= 512 rows:
    the offsets the kernel's wgmma descriptors read."""
    n = wgmma.kernel_width(FULL_HEADS[name][0][1])
    k = 64
    w = torch.arange(n * k, dtype=torch.float32).reshape(n, k)
    flat = wgmma.tile_layout(w)
    pn = min(n, wgmma.PASS_N)
    for row, col in ((0, 0), (7, 9), (n - 1, k - 1), (pn // 2 + 3, 37)):
        p_, r = divmod(row, pn)
        t, kk = divmod(col, wgmma.BK)
        base = (p_ * (k // wgmma.BK) + t) * pn * wgmma.BK
        assert flat[base + ((kk // 8) * pn + r) * 8 + kk % 8] == w[row, col]
    assert torch.equal(wgmma.untile_layout(flat, n, k), w)


def _walk_stream(p, x):
    """The bf16 kernel's schedule in plain PyTorch: the producer's stage
    order over the packed stream, A from h or from the x tile, f32 sums,
    bias, activation, h rounded and kept at its kernel width."""
    from monoport_tpu_torch.ops.cuda.fused_ray_mlp import _activate

    xr = tmlp.pad_feat(p, x).reshape(-1, p.widths[0])
    c, last = p.widths[0], len(p.tile_widths) - 1
    h = torch.zeros(xr.shape[0], max(p.tile_widths), dtype=torch.bfloat16)
    pos = boff = 0
    for i, n in enumerate(p.tile_widths):
        pn = min(n, wgmma.PASS_N)
        nh = p.tile_widths[i - 1] // wgmma.BK if i else 0
        acc = torch.zeros(xr.shape[0], n)
        for pass_ in range(n // pn):
            for kt in range(nh + c // wgmma.BK):
                tile = p.tiles[pos:pos + pn * wgmma.BK]
                pos += pn * wgmma.BK
                w = wgmma.untile_layout(tile, pn, wgmma.BK)
                a = (h[:, kt * wgmma.BK:(kt + 1) * wgmma.BK] if kt < nh else
                     xr[:, (kt - nh) * wgmma.BK:(kt - nh + 1) * wgmma.BK])
                cols = slice(pass_ * pn, (pass_ + 1) * pn)
                acc[:, cols] += a.float() @ w.float().t()
        v = _activate(acc + p.tile_bias[boff:boff + n], i == last, p.last_op)
        boff += n
        if i < last:
            h[:, :n] = v.to(torch.bfloat16)
    return v[:, :p.out_dim].reshape(*x.shape[:-1], p.out_dim)


@pytest.mark.parametrize("name", ["narrow", "netC"])
def test_stream_walk_matches_plain(name):
    """Walking the packed stream as the kernel does gives the plain
    version's output (bf16 atol 2e-2; the sums differ only in order)."""
    p = tmlp.pack_mlp_params(_seeded_head(*FULL_HEADS[name]))
    x = torch.from_numpy(np.random.RandomState(3).randn(
        1, 70, p.c_f).astype(np.float32))
    torch.testing.assert_close(_walk_stream(p, x), tmlp.apply_mlp_plain(p, x),
                               atol=2e-2, rtol=0)


def test_kernel_widths_and_shape_limits():
    assert [wgmma.kernel_width(n) for n in (1, 32, 33, 96, 128, 257, 512,
                                           513, 1024)] == \
        [32, 32, 64, 128, 128, 512, 512, 1024, 1024]
    assert wgmma.wgmma_shape_error((1024, 512, 256, 128, 32)) is None
    assert wgmma.wgmma_shape_error((1024, 2048)) is None    # the last: passes
    # the in-place mode's limits; the scratch mode takes those heads
    assert wgmma.inplace_error((1024, 512, 256, 128, 32)) is None
    assert wgmma.inplace_error((1024, 2048)) is None
    assert "layer 0" in wgmma.inplace_error((2048, 64, 32))
    assert "hidden layer 1" in wgmma.inplace_error((1024, 1024, 32))
    for widths in ((2048, 64, 32), (1024, 1024, 32)):
        assert wgmma.needs_scratch(widths)
        assert wgmma.wgmma_shape_error(widths) is None
    assert not wgmma.needs_scratch((1024, 512, 256, 128, 32))
    assert "9 layers" in wgmma.wgmma_shape_error((32,) * 9)
    assert "not a kernel width" in wgmma.wgmma_shape_error((96, 32))


def test_wgmma_launcher_checks_raise_before_any_launch(monkeypatch):
    """Every refused operand raises ValueError before a build or a launch."""
    from monoport_tpu_torch.ops.cuda import build
    from monoport_tpu_torch.ops.cuda import fused_ray_mlp as tray

    def no_launch(*args, **kwargs):
        raise AssertionError("reached the build / launch")

    monkeypatch.setattr(build, "bind", no_launch)
    head = _seeded_head(*FULL_HEADS["narrow"])
    p = tmlp.pack_mlp_params(head)
    xr = torch.zeros(5, p.widths[0], dtype=torch.bfloat16)
    # nine layers: past kMaxLayers, the one limit either route keeps
    wide = tmlp.pack_mlp_params(
        SurfaceClassifier((65,) + (32,) * 8 + (1,)))
    cases = [
        (tmlp.pack_mlp_params(head, torch.float32), xr),   # no bf16 tiles
        (tray.pack_ray_mlp_params(head), xr),              # not a point pack
        (wide, torch.zeros(5, wide.widths[0], dtype=torch.bfloat16)),
        (p, xr.float()),                                   # not bf16
        (p, xr[:, :32]),                                   # not [N, C_in]
        (p, xr.reshape(1, 5, -1)),
        (p, torch.zeros(p.widths[0], 5, dtype=torch.bfloat16).t()),
        (p, xr),                                           # a CPU tensor
        (p, xr.to("meta")),                                # no CUDA tensor
    ]
    for packed, x in cases:
        with pytest.raises(ValueError):
            tmlp.launch_wgmma(packed, x)


def test_apply_mlp_dispatch_bf16():
    """bf16 packs dispatch as f32 ones: a CPU tensor takes the plain
    version and is no launch; a device with no path raises."""
    p = tmlp.pack_mlp_params(_seeded_head(*FULL_HEADS["narrow"]))
    x = torch.from_numpy(np.random.RandomState(4).randn(1, 9, p.c_f).astype(
        np.float32))
    before = tmlp.apply_mlp.launches
    torch.testing.assert_close(tmlp.apply_mlp(p, x),
                               tmlp.apply_mlp_plain(p, x), rtol=0, atol=0)
    assert tmlp.apply_mlp.launches == before
    with pytest.raises(ValueError):
        tmlp.apply_mlp(p, x.to("meta"))

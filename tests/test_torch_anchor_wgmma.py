"""PyTorch port, the bf16 routes of the anchored ray MLP (kernel 3) and the
gathering ray MLP (kernel 4): their host side on the CPU.

Both are a weighted-row pass (``csrc/mix_rows.cuh``) feeding the shared
wgmma kernel (``csrc/wgmma_mlp.cuh``); the kernels run only on the card
(tests/test_torch_cuda.py). Here: ``mix_rows_plain`` equals an explicit
per-row loop, bit for bit, in both forms (anchors, indexed rows), and its
indexed form equals the JAX combine of ``apply_gather_xla`` within one bf16
ulp; the pass, then a plain-PyTorch walk of the wgmma kernel's stream
(``torch_wgmma_walk.walk``) at one tap, equals ``apply_anchor_plain`` (the
TPU kernel's math, which mixes f32 projections) at the bf16 atol 2e-2, for
the narrow, netG and netC heads at K in {2, 3, 5}, T = 6 and a ragged ray
count, and on the narrow head the JAX ``apply_anchor_packed(...,
interpret=True)``; the indexed pass, then the walk with T taps, equals
``apply_gather_plain`` and the JAX ``apply_gather_xla`` on the narrow head
at 2e-2; the launchers raise on what the kernels do not take before any
build or launch; ``apply_anchor`` and ``apply_gather_ray`` send bf16 to the
pass + wgmma route and f32 to the FMA route (``csrc/mlp_tiles.cuh``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from monoport_tpu.ops.pallas import fused_gather_mlp as jgather
from monoport_tpu.ops.pallas import fused_ray_mlp as jray
from monoport_tpu_torch.models.heads import SurfaceClassifier
from monoport_tpu_torch.ops.cuda import build, mix_rows
from monoport_tpu_torch.ops.cuda import fused_gather_mlp as tgather
from monoport_tpu_torch.ops.cuda import fused_ray_mlp as tray
from torch_wgmma_walk import HEADS, bf16_ulps, make_head, split_bwz, walk

torch.set_num_threads(2)
BF16 = dict(atol=2e-2, rtol=0)
RAYS, TAPS = 70, 6                       # 70 rays: no multiple of 64


def _hat_weights(rng, rays, taps, k):
    """Hat weights [1, rays, taps, k]: each tap's two neighbouring anchors,
    summing to 1, as the engine makes them."""
    alpha = np.sort(rng.rand(1, rays, taps).astype(np.float32), axis=-1)
    pos = alpha[..., None] * (k - 1) - np.arange(k, dtype=np.float32)
    return np.maximum(0.0, 1.0 - np.abs(pos)).astype(np.float32)


def _anchor_inputs(p, k, seed=5, rays=RAYS, taps=TAPS):
    rng = np.random.RandomState(seed)
    f = lambda a: torch.from_numpy(a.astype(np.float32))
    return (f(rng.randn(1, rays, k, p.c_f)),
            f(_hat_weights(rng, rays, taps, k)),
            f(rng.uniform(-1.3, 1.3, (1, rays, taps))))


def _gather_inputs(p, rays=RAYS, taps=TAPS, hw=(9, 11), seed=6):
    rng = np.random.RandomState(seed)
    f = lambda a: torch.from_numpy(a.astype(np.float32))
    return (f(rng.randn(1, *hw, p.c_f)),
            f(rng.uniform(-1.2, 1.2, (1, rays, 2))),      # some taps outside
            f(rng.uniform(-1.3, 1.3, (1, rays, taps))))


def _anchor_route(p, feat_k, w, z):
    """The bf16 anchored route on the CPU: the pass (hi | lo rows), then the
    walk of the wgmma kernel's anchored stream ([W_f; W_f]) at one tap over
    the R * T mixed rows."""
    b_, r, k, _ = feat_k.shape
    taps = z.shape[-1]
    x = mix_rows.mix_rows_plain(tray.anchor_table(p, feat_k),
                                w.reshape(-1, k), taps=taps,
                                c_pad=p.widths[0], split=True)
    a = p.anchor
    got = walk(a, a.tiles, *split_bwz(a.tile_bwz), a.tile_widths, x,
               z.reshape(-1, 1))
    return got.reshape(b_, r, taps, p.out_dim)


def _gather_route(p, fmap, uv, z):
    """The bf16 gathering route on the CPU: the indexed pass over the bf16
    table, then the walk with the T taps."""
    _, h, w, c = fmap.shape
    idx, wgt = tgather.bilinear_taps(uv, h, w)
    x = mix_rows.mix_rows_plain(fmap.reshape(h * w, c).to(torch.bfloat16),
                                wgt[0], idx=idx[0], c_pad=p.widths[0])
    return walk(p, p.tiles, *split_bwz(p.tile_bwz), p.tile_widths,
                x[None, :, :p.c_f], z)


@pytest.mark.parametrize("form", ["anchors", "indexed"])
def test_mix_rows_plain_equals_a_loop(form):
    """Each output row is its terms' f32 products added in order j = 0..J-1
    and rounded once: bit-equal to a loop over rows; zero weights (hats,
    taps outside the image) included; columns past the table's width are
    0."""
    rng = np.random.RandomState(1)
    c, taps = 24, 3
    if form == "anchors":
        k, rays = 5, 7
        table = torch.from_numpy(rng.randn(rays * k, c).astype(np.float32))
        w = torch.from_numpy(_hat_weights(rng, rays, taps, k)[0].reshape(
            -1, k))
        idx = None
        rows = [[m // taps * k + j for j in range(k)]
                for m in range(rays * taps)]
    else:
        table = torch.from_numpy(rng.randn(30, c).astype(np.float32))
        w = torch.from_numpy(rng.rand(40, 4).astype(np.float32))
        w[::3, 1] = 0.0
        idx = torch.from_numpy(rng.randint(0, 30, (40, 4)).astype(np.int32))
        rows = idx.tolist()
    table = table.to(torch.bfloat16)
    got = mix_rows.mix_rows_plain(table, w, idx=idx, taps=taps, c_pad=32)
    split = mix_rows.mix_rows_plain(table, w, idx=idx, taps=taps, c_pad=32,
                                    split=True)
    assert got.shape == (w.shape[0], 32) and got.dtype == torch.bfloat16
    assert split.shape == (w.shape[0], 64) and torch.equal(split[:, :32], got)
    for m, row in enumerate(rows):
        acc = table[row[0]].float() * w[m, 0]
        for j in range(1, len(row)):
            acc = acc + table[row[j]].float() * w[m, j]
        hi = acc.to(torch.bfloat16)
        assert torch.equal(got[m, :c], hi), m
        assert torch.equal(split[m, 32:32 + c],
                           (acc - hi.float()).to(torch.bfloat16)), m
    for half in (got, split[:, :32], split[:, 32:]):
        assert not half[:, c:].float().abs().any()
    # hi + lo keeps ~16 bits of the f32 sum where hi alone keeps 8
    exact = mix_rows.mix_rows_plain(table.float(), w, idx=idx, taps=taps)
    two = split[:, :c].float() + split[:, 32:32 + c].float()
    assert (two - exact).abs().max() <= 2 ** -15 * exact.abs().max()
    assert (got[:, :c].float() - exact).abs().max() > 2 ** -12 * \
        exact.abs().max()


def test_indexed_mix_is_the_jax_gather_combine():
    """The indexed pass over ``bilinear_taps`` is the combine of
    ``apply_gather_xla`` (bf16 table, f32 weighted sum, one rounding)
    within one bf16 ulp (the sums may run in another order)."""
    rng = np.random.RandomState(2)
    h, w, c = 12, 10, 40
    fmap = rng.randn(1, h, w, c).astype(np.float32)
    uv = rng.uniform(-1.2, 1.2, (1, 300, 2)).astype(np.float32)
    jidx, jwgt = jgather._bilinear_taps(jnp.asarray(uv), h, w)
    table = jnp.asarray(fmap).reshape(1, h * w, c).astype(jnp.bfloat16)
    rows = jnp.take_along_axis(table, jidx.reshape(1, -1)[..., None],
                               axis=1).reshape(1, 300, 4, c)
    want = (rows.astype(jnp.float32) * jwgt[..., None]).sum(axis=2).astype(
        jnp.bfloat16)
    idx, wgt = tgather.bilinear_taps(torch.from_numpy(uv), h, w)
    got = mix_rows.mix_rows_plain(
        torch.from_numpy(fmap).reshape(h * w, c).to(torch.bfloat16), wgt[0],
        idx=idx[0])
    want = torch.from_numpy(np.array(want.astype(jnp.float32))).to(
        torch.bfloat16)[0]
    assert int(bf16_ulps(got, want).max()) <= 1


@pytest.mark.parametrize("k", [2, 3, 5])
@pytest.mark.parametrize("name", sorted(HEADS))
def test_anchor_route_matches_plain(name, k):
    """The mixed rows through the walk at one tap equal the TPU kernel's
    math (f32 projections mixed per tap) at the bf16 tolerance, though the
    route rounds the mixed row's two halves to bf16."""
    p = tray.pack_ray_mlp_params(make_head(name)[0])
    feat_k, w, z = _anchor_inputs(p, k)
    got = _anchor_route(p, feat_k, w, z)
    assert got.shape == (1, RAYS, TAPS, p.out_dim)
    torch.testing.assert_close(got, tray.apply_anchor_plain(p, feat_k, w, z),
                               **BF16)


def test_anchor_route_matches_pallas_interpret():
    """On the narrow head the route equals the JAX anchored kernel
    (interpret mode), K = 3, T = 6."""
    head, params = make_head("narrow")
    p = tray.pack_ray_mlp_params(head)
    feat_k, w, z = _anchor_inputs(p, 3, seed=7)
    packed = jray.pack_ray_mlp_params(params, HEADS["narrow"][0],
                                      jnp.bfloat16)
    want = jray.apply_anchor_packed(
        packed, jnp.asarray(feat_k.numpy()), jnp.asarray(w.numpy()),
        jnp.asarray(z.numpy()), "sigmoid", tile_r=128,
        compute_dtype=jnp.bfloat16, interpret=True)
    np.testing.assert_allclose(_anchor_route(p, feat_k, w, z).numpy(),
                               np.asarray(want), **BF16)


def test_gather_route_matches_plain_and_xla():
    """The indexed pass, then the walk with the T taps, equals
    ``apply_gather_plain`` and the JAX ``apply_gather_xla`` on the narrow
    head (uv past the image on some rays)."""
    head, params = make_head("narrow")
    p = tray.pack_ray_mlp_params(head)
    fmap, uv, z = _gather_inputs(p)
    got = _gather_route(p, fmap, uv, z)
    assert got.shape == (1, RAYS, TAPS, p.out_dim)
    torch.testing.assert_close(got, tgather.apply_gather_plain(p, fmap, uv, z),
                               **BF16)
    packed = jray.pack_ray_mlp_params(params, HEADS["narrow"][0],
                                      jnp.bfloat16)
    want = jgather.apply_gather_xla(packed, jnp.asarray(fmap.numpy()),
                                    jnp.asarray(uv.numpy()),
                                    jnp.asarray(z.numpy()), "sigmoid",
                                    compute_dtype=jnp.bfloat16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BF16)


def test_launchers_raise_before_any_build_or_launch(monkeypatch):
    """Every refused operand raises ValueError, naming what it refuses,
    before a build or a launch."""
    def no_build(*args, **kwargs):
        raise AssertionError("reached the build / launch")

    monkeypatch.setattr(build, "bind", no_build)
    head = make_head("narrow")[0]
    p = tray.pack_ray_mlp_params(head)
    feat_k, w, z = _anchor_inputs(p, 3, rays=5)
    # nine layers: past kMaxLayers, the one limit either route keeps
    wide = tray.pack_ray_mlp_params(
        SurfaceClassifier((65,) + (32,) * 8 + (1,)))
    unpacked = tray.pack_head(head, torch.bfloat16, None, True)
    cases = [
        (lambda: tray._launch_anchor(p, feat_k, w[..., :2], z), "w_taps"),
        (lambda: tray._launch_anchor(p, feat_k, w, z[:, :4]), "z shape"),
        (lambda: tray._launch_anchor(                      # K > 8
            p, torch.zeros(1, 5, 9, p.c_f), torch.zeros(1, 5, 6, 9), z),
         "anchors"),
        (lambda: tray._launch_anchor(p, feat_k[..., :8], w, z), "width"),
        (lambda: tray._launch_anchor(wide, torch.zeros(1, 5, 3, 64), w, z),
         "cannot take"),
        (lambda: tray._launch_anchor(unpacked, feat_k, w, z), "bf16 operands"),
        (lambda: tray.launch_anchor_wgmma(
            tray.pack_ray_mlp_params(head, torch.float32),
            torch.zeros(30, 128, dtype=torch.bfloat16), torch.zeros(30, 1)),
         "bf16 operands"),
        (lambda: tray.launch_anchor_wgmma(            # hi alone, no lo
            p, torch.zeros(30, 64, dtype=torch.bfloat16), torch.zeros(30, 1)),
         "x must be"),
        (lambda: tray.stream_anchor_wgmma(
            wide, torch.zeros(30, 128, dtype=torch.bfloat16),
            torch.zeros(30, 1)), "cannot take"),
        (lambda: tgather._launch(unpacked, *_gather_inputs(p, rays=5)),
         "bf16 operands"),
        (lambda: tray._launch_anchor(p, feat_k, w, z), "CUDA tensors"),
        (lambda: tgather._launch(p, *_gather_inputs(p, rays=5)),
         "CUDA tensors"),
    ]
    table = torch.zeros(15, 64, dtype=torch.bfloat16)
    wk = torch.zeros(30, 3)
    idx = torch.zeros(30, 4, dtype=torch.int32)
    launch = lambda table, w, c_pad=64, **kw: mix_rows.launch_mix_rows(
        "fused_ray_mlp", "mix_anchor_rows", table, w, c_pad, **kw)
    cases += [
        (lambda: launch(table.float(), wk, taps=6), "table must be bf16"),
        (lambda: launch(table, wk.double(), taps=6), "w must be"),
        (lambda: launch(table, wk.t(), taps=6), "w must be"),
        (lambda: launch(table, torch.zeros(30, 9), taps=6), "terms"),
        (lambda: launch(table, wk, taps=5), "table rows"),
        (lambda: launch(table, wk), "table rows"),
        (lambda: launch(table, torch.zeros(30, 4), idx=idx.long()),
         "idx must be"),
        (lambda: launch(table, torch.zeros(30, 4), idx=idx[:, :3]),
         "idx must be"),
        (lambda: launch(table, wk, taps=6, c_pad=60), "c_pad"),
        (lambda: launch(table, wk, taps=6, c_pad=32), "c_pad"),
        (lambda: launch(table, wk, taps=6), "CUDA tensors"),
        (lambda: launch(table.to("meta"), wk.to("meta"), taps=6),
         "CUDA tensors"),
    ]
    for call, match in cases:
        with pytest.raises(ValueError, match=match):
            call()


def _record_launches(monkeypatch, seen):
    """Stand-ins for every launcher of the two routes, recording what they
    get; the build is refused."""
    def fake_mix(library, function, table, w, c_pad, idx=None, taps=None,
                 split=False):
        seen.append(("mix", library, function, table.dtype,
                     tuple(table.shape), tuple(w.shape), idx is not None,
                     taps, c_pad, split))
        return mix_rows.mix_rows_plain(table, w, idx=idx, taps=taps,
                                       c_pad=c_pad, split=split)

    def fake_wgmma(kind):
        def run(packed, x, z):
            seen.append((kind, x.dtype, tuple(x.shape), z.dtype,
                         tuple(z.shape), x.is_contiguous()))
            return torch.zeros(x.shape[0], z.shape[1], packed.out_dim)
        return run

    def fake_packed(library, function, packed, f, n_rays, taps, z=None,
                    wk=None, n_anchors=None, gather=None):
        seen.append(("fma", function, tuple(f.shape), n_rays, taps,
                     n_anchors, gather is not None))
        return torch.zeros(n_rays, taps, packed.out_dim)

    def refuse(*args, **kwargs):
        raise AssertionError("reached the build / launch")

    monkeypatch.setattr(build, "bind", refuse)
    monkeypatch.setattr(mix_rows, "launch_mix_rows", fake_mix)
    monkeypatch.setattr(tray, "launch_anchor_wgmma", fake_wgmma("anchor"))
    monkeypatch.setattr(tray, "launch_ray_wgmma", fake_wgmma("ray"))
    monkeypatch.setattr(tray, "launch_packed", fake_packed)
    monkeypatch.setattr(tgather, "launch_packed", fake_packed)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_apply_anchor_routes_by_dtype(monkeypatch, dtype):
    """A CUDA-bound call takes, for bf16, one pass over the anchors where
    they lie ([R K, c_f]) into [R T, 2 widths[0]] hi | lo rows and one
    wgmma launch at one tap (z [R T, 1]); for f32 the FMA launcher with K
    anchors. One counted launch either way; the other route is never
    reached."""
    p = tray.pack_ray_mlp_params(make_head("narrow")[0], dtype=dtype)
    feat_k, w, z = _anchor_inputs(p, 3, rays=9)
    seen = []
    _record_launches(monkeypatch, seen)
    before = tray.apply_anchor.launches
    out = tray._launch_anchor(p, feat_k, w, z)
    assert tray.apply_anchor.launches == before + 1
    assert out.shape == (1, 9, 6, p.out_dim)
    if dtype == torch.bfloat16:
        assert seen == [
            ("mix", "fused_ray_mlp", "mix_anchor_rows", torch.bfloat16,
             (27, p.c_f), (54, 3), False, 6, p.widths[0], True),
            ("anchor", torch.bfloat16, (54, 2 * p.widths[0]), torch.float32,
             (54, 1), True)]
    else:
        assert seen == [("fma", "fused_anchor_mlp_forward",
                         (27, p.widths[0]), 9, 6, 3, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_apply_gather_ray_routes_by_dtype(monkeypatch, dtype):
    """For bf16 one indexed pass over the bf16 table into [R, widths[0]]
    rows and one launch of the ray MLP's wgmma kernel with the T taps,
    counted on ``apply_gather_ray`` and not on ``apply_ray``; for f32 the
    FMA launcher with the gather."""
    p = tray.pack_ray_mlp_params(make_head("narrow")[0], dtype=dtype)
    fmap, uv, z = _gather_inputs(p, rays=9)
    seen = []
    _record_launches(monkeypatch, seen)
    before = (tgather.apply_gather_ray.launches, tray.apply_ray.launches)
    out = tgather._launch(p, fmap, uv, z)
    assert (tgather.apply_gather_ray.launches,
            tray.apply_ray.launches) == (before[0] + 1, before[1])
    assert out.shape == (1, 9, 6, p.out_dim)
    if dtype == torch.bfloat16:
        assert seen == [
            ("mix", "fused_gather_mlp", "mix_gather_rows", torch.bfloat16,
             (99, p.c_f), (9, 4), True, None, p.widths[0], False),
            ("ray", torch.bfloat16, (9, p.widths[0]), torch.float32, (9, 6),
             True)]
    else:
        assert seen == [("fma", "fused_gather_mlp_forward",
                         (99, p.widths[0]), 9, 6, None, True)]

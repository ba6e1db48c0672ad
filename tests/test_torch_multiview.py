"""PyTorch port, PIFu's multi-view netG (``num_views`` > 1) on the CPU:

* the port's ``SurfaceClassifier(num_views=2 and 4)`` against the JAX
  package's on seeded weights (plain heads, f32, atol 1e-5: two f32 MLPs
  of a few hundred terms a sum);
* the view-pooled kernel's plain twin (``fused_mlp.apply_mlp_views_plain``,
  the kernel's rounding points) against the plain head, at the published
  netG widths and at a narrow head (f32 atol 2e-5 / rtol 1e-4, the
  repository's f32 kernel tolerance), and its refusals;
* the engine's multi-view dense frame against the benchmark's plain
  reference (``cardbench/reference/frames/dense_views.py``): a 1-stack HG
  netG at 64^2, V = 4, levels 9-17-33 (every candidate within its budget),
  seeded weights whose last layer has a -8 weight on z, on a ring of yaws
  0/30/60/90 (the pooled z is then not 0, and the -8 puts a surface at
  varied depths in most columns; a column whose surface is the volume's
  front face peels to 0/0 in both, compared as equal NaNs). ``sdf`` atol 2e-5 (both sides plain f32; the twin pools the
  views' input projections where the reference projects the pooled input,
  a rounding-level difference); the silhouette equal but for
  ``FLIP_FRACTION`` of the pixels, where a ray's largest occupancy lies
  within 1e-4 of the iso-level (knife edges); depth 2e-4 voxels and the
  normal render 2e-3 on the pixels valid in both;
* the ``ring4`` traffic's calibs (view 0 the identity, each view the
  rotation by its yaw about the vertical axis) and renders (the yaw-180
  view is the yaw-0 silhouette mirrored);
* the construction-time refusals of every path but the dense frame;
* the spans and query records of a multi-view frame;
* ``chip_smoke.py`` phase 21's helpers: its work count of the form is the
  benchmark reader's (``metrics/kernel2.views.roofline.py``), its ring is
  ``ring4``'s.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``)."""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cardbench.harness import views, weights as bench_weights
from cardbench.harness.manifest import Manifest
from cardbench.reference.frame import frame_path, load_nets
from monoport_tpu.models.heads.surface_classifier import (
    SurfaceClassifier as JaxSC)
from monoport_tpu_torch.config import CN
from monoport_tpu_torch.engine import EngineCfg, RayCfg, ReconEngine
from monoport_tpu_torch.models.heads import SurfaceClassifier
from monoport_tpu_torch.ops.cuda import fused_mlp as tmlp
from monoport_tpu_torch.parallel.mesh import make_mesh
from monoport_tpu_torch.recon.hierarchy import HierarchicalRecon
from monoport_tpu_torch.utils import profiling
from monoport_tpu_torch.weights import build_net
from torch_multiview_small import RECON, SEED, ring_spec, small_config

torch.set_num_threads(2)
FLIP_FRACTION = 0.01


def _seeded_head(chans, last_op, views, seed=7) -> SurfaceClassifier:
    head = SurfaceClassifier(chans, last_op=last_op, num_views=views)
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for lin in head.layers():
            lin.weight.copy_(torch.from_numpy(rng.randn(
                *lin.weight.shape).astype(np.float32)
                / np.sqrt(lin.weight.shape[1])))
            lin.bias.copy_(torch.from_numpy(
                rng.randn(*lin.bias.shape).astype(np.float32) * 0.1))
    return head


@pytest.mark.parametrize("chans", [(33, 16, 8, 1), (65, 48, 32, 24, 16, 1)])
@pytest.mark.parametrize("views", [2, 4])
def test_head_matches_jax(views, chans):
    head = _seeded_head(chans, "sigmoid", views)
    params = {f"filters_{i}": {"kernel": lin.weight.detach().numpy().T,
                               "bias": lin.bias.detach().numpy()}
              for i, lin in enumerate(head.layers())}
    x = np.random.RandomState(3).randn(3 * views, 50, chans[0]).astype(
        np.float32)
    jnet = JaxSC(filter_channels=chans, num_views=views, no_residual=False,
                 last_op=jax.nn.sigmoid)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jnet.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = head(torch.from_numpy(x)).numpy()
    assert got.shape == (3, 50, 1) == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("chans,views", [
    ((257, 1024, 512, 256, 128, 1), 4),
    ((65, 48, 32, 24, 16, 1), 2),
    ((65, 48, 32, 24, 16, 1), 8),
    ((33, 16, 8, 3), 4)])
def test_views_twin_matches_plain_head(chans, views):
    head = _seeded_head(chans, "sigmoid" if chans[-1] == 1 else "tanh", views)
    p = tmlp.pack_mlp_params(head, dtype=torch.float32, device="cpu")
    x = torch.from_numpy(np.random.RandomState(4).randn(
        2, 37, views, chans[0]).astype(np.float32))
    got = tmlp.apply_mlp_views(p, x, views)
    with torch.no_grad():
        want = head(x.permute(0, 2, 1, 3).reshape(2 * views, 37, chans[0]))
    assert got.shape == want.shape == (2, 37, chans[-1])
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)


def test_views_form_refusals():
    head = _seeded_head((33, 16, 8, 1), "sigmoid", 4)
    x = torch.zeros(1, 5, 4, 33)
    with pytest.raises(ValueError, match="f32 route only"):
        tmlp.apply_mlp_views(tmlp.pack_mlp_params(head, torch.bfloat16,
                                                  "cpu"), x, 4)
    p = tmlp.pack_mlp_params(head, torch.float32, "cpu")
    with pytest.raises(ValueError, match="power of two"):
        tmlp.apply_mlp_views(p, torch.zeros(1, 5, 3, 33), 3)
    two = tmlp.pack_mlp_params(_seeded_head((33, 16, 1), "sigmoid", 4),
                               torch.float32, "cpu")
    with pytest.raises(ValueError, match="3 layers"):
        tmlp.apply_mlp_views(two, x, 4)


# -- the engine's multi-view frame ---------------------------------------------
@pytest.fixture(scope="module")
def small():
    config = small_config()
    state = bench_weights.seeded_state(config["netG"], config["weights"],
                                       SEED, "cpu")
    tr = views.generate(ring_spec(), SEED, 64, "cpu")
    engine, _ = views.build_engine(config, {"netG": state}, "cpu")
    ref = frame_path("dense_views").Frame(
        config, load_nets(config, {"netG": state}, "cpu"))
    return {"config": config, "state": state, "traffic": tr,
            "engine": engine, "ref": ref}


@pytest.mark.parametrize("body", [0, 1])
def test_frame_matches_reference(small, body):
    tr = small["traffic"]
    images, calibs = tr.images[body], tr.calibs[0]
    assert images.shape == (4, 64, 64, 3) and calibs.shape == (4, 4, 4)
    got = small["engine"].frame(images, None, calibs)
    with torch.no_grad():
        want = small["ref"](images, None, calibs)
    torch.testing.assert_close(got["sdf"], want["sdf"], atol=2e-5, rtol=0)
    gv, wv = got["valid"].bool(), want["valid"].bool()
    # a surface at varied depths, not the volume's front face (0/0 there)
    depth = want["depth"][wv]
    assert torch.isfinite(depth).float().mean() > 0.9
    assert depth[torch.isfinite(depth)].std() > 1.0
    flips = gv != wv
    assert flips.float().mean() <= FLIP_FRACTION
    assert (want["valid_margin"][flips] < 1e-4).all()
    both = gv & wv
    torch.testing.assert_close(got["depth"][both], want["depth"][both],
                               atol=2e-4, rtol=0, equal_nan=True)
    subj = ~(got["render_norm"] >= 1).all(-1) & ~(
        want["render_norm"] >= 1).all(-1)
    torch.testing.assert_close(got["render_norm"][subj],
                               want["render_norm"][subj], atol=2e-3, rtol=0)
    assert (got["recon_counts"][1:].numpy() <= np.asarray(
        RECON["budgets"][2:])).all()


def test_frame_spans_and_query_records(small):
    tr = small["traffic"]
    with profiling.recording() as rec:
        small["engine"].frame(tr.images[0], None, tr.calibs[0])
    names = [s.name for s in rec.spans]
    assert names.count("recon.views.sample") == len(RECON["resolutions"])
    net_span = next(s for s in rec.spans if s.name == "backbone.netG")
    assert net_span.attrs["views"] == 4 and net_span.attrs["graph"] == "eager"
    sample = [s for s in rec.spans if s.name == "recon.views.sample"]
    assert all(s.parent.name == "recon.hierarchy" for s in sample)
    qs = rec.queries
    assert [q.views for q in qs] == [4] * len(RECON["resolutions"])
    assert qs[0].rows == RECON["resolutions"][0] ** 3
    assert all(q.span.name == "recon.hierarchy" for q in qs)


def test_single_view_records_stay_as_they_were():
    with profiling.recording() as rec:
        profiling.query("q", 5)
    assert rec.queries[0].views == 1
    with profiling.collecting() as got:
        profiling.query("q", 5, views=4)
        profiling.query("r", 6)
    assert got == [("q", 5, 1, 0, 4), ("r", 6, 1, 0)]


# -- the ring4 traffic -----------------------------------------------------
def test_ring4_calibs_are_rotations_by_their_yaws():
    spec = Manifest.traffic("ring4")
    assert spec["driver"] == "views"
    yaws = spec["camera"]["yaws"]
    calibs = views.ring_calibs(yaws)
    assert calibs.shape == (4, 4, 4) and calibs.dtype == np.float32
    np.testing.assert_array_equal(calibs[0], np.eye(4, dtype=np.float32))
    for yaw, c in zip(yaws, calibs):
        t = np.radians(yaw)
        r = c[:3, :3].astype(np.float64)
        np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-6)
        np.testing.assert_allclose(r[1], [0, 1, 0], atol=1e-7)
        # the world x axis turns by the yaw in the view's image plane
        np.testing.assert_allclose(r @ [1, 0, 0],
                                   [np.cos(t), 0, -np.sin(t)], atol=1e-6)
        np.testing.assert_array_equal(c[3], [0, 0, 0, 1])
        np.testing.assert_array_equal(c[:3, 3], [0, 0, 0])


def test_ring4_renders_see_the_body_from_each_yaw():
    spec = dict(Manifest.traffic("ring4"), bodies=2)
    tr = views.generate(spec, SEED, 64, "cpu")
    assert tr.images.shape == (2, 4, 64, 64, 3) and len(tr.calibs) == 1
    assert tr.frame(5) == (1, 0)
    # the front renders are the frontal mix's bodies of the same seed
    from cardbench.harness import traffic
    front = traffic.generate(dict(Manifest.traffic("frontal"), bodies=2),
                             SEED, 64, "cpu")
    torch.testing.assert_close(tr.images[:, 0], front.images, atol=0, rtol=0)
    hit = (tr.images != 0).any(-1)                     # [bodies, V, S, S]
    mirrored = hit[:, 2].flip(-1)
    assert (hit[:, 0] != mirrored).float().mean() < 0.01
    assert (hit[:, 1] != hit[:, 0]).any()


# -- refusals -----------------------------------------------------------------
def _net(views=4):
    config = small_config()
    state = bench_weights.seeded_state(config["netG"], config["weights"],
                                       SEED, "cpu")
    spec = config["netG"]
    opt = CN({k: spec[k] for k in ("projection", "backbone", "normalizer",
                                   "loss")})
    opt.head = CN({"IMF": "PIFuNetGMLP"})
    opt.num_views = views
    return build_net(opt, state, "cpu")


@pytest.mark.parametrize("case", ["ray", "march", "netC", "mesh", "bf16"])
def test_engine_refuses_every_other_path(case):
    net = _net()
    kw = {"recon": HierarchicalRecon(**RECON), "device": "cpu"}
    cfg = EngineCfg(ray=RayCfg(mode="dense"))
    if case == "ray":
        cfg = EngineCfg(ray=RayCfg(mode="ray", fine_res=33, taps=5))
    elif case == "march":
        cfg = EngineCfg(ray=RayCfg(mode="ray", fine_res=33, taps=5,
                                   march_levels=(9, 17)))
    elif case == "netC":
        kw["netC"] = net
    elif case == "mesh":
        kw["mesh"] = make_mesh()
    elif case == "bf16":
        cfg = EngineCfg(ray=RayCfg(mode="dense"),
                        compute_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multi-view netG"):
        ReconEngine(net, config=cfg, **kw)


def test_engine_refuses_a_clip_and_a_single_view_input(small):
    eng, tr = small["engine"], small["traffic"]
    with pytest.raises(ValueError, match="4 images and 4 calibs"):
        eng.frame(tr.images[0, :1], None, tr.calibs[0][:1])
    with pytest.raises(ValueError, match="no clip"):
        eng.frames(tr.images[0])
    assert eng.head_g is None and eng.anchor_g is None


# -- chip_smoke.py phase 21 against the benchmark --------------------------
def _roofline_reader():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "cardbench", "metrics",
        "kernel2.views.roofline.py")
    spec = importlib.util.spec_from_file_location("views_roofline", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("points", [4_913, 262_144])
def test_chip_smoke_views_work_is_the_readers(points):
    """The smoke's operations and bytes of the view-pooled form at the
    published head are the roofline reader's: V x 1,115,904 + 66,049
    multiply-adds a point; the bytes but for the biases, which the smoke
    leaves out of every row's bytes. The kernel projects every view's row
    for every layer, so it does more than that bound counts."""
    import chip_smoke

    widths = [257, 1024, 512, 256, 128, 1]
    head = SurfaceClassifier(widths, last_op="sigmoid", num_views=4)
    flops, t_ops, nbytes = chip_smoke.views_mlp_work(head, points, 4)
    want = _roofline_reader().views_point_work(widths, points, 4)
    assert flops == want[0]
    assert nbytes + 4 * sum(widths[1:]) == want[2]
    assert t_ops == pytest.approx(want[1], rel=1e-12)
    assert flops == 2.0 * points * (4 * 1_115_904 + 66_049)
    assert 1.0 < chip_smoke.views_recompute(head, 4) < 1.1


def test_chip_smoke_ring_is_ring4s():
    import chip_smoke

    yaws = Manifest.traffic("ring4")["camera"]["yaws"]
    assert tuple(yaws) == chip_smoke.RING_YAWS
    assert chip_smoke.VIEWS == len(yaws)
    np.testing.assert_array_equal(chip_smoke.ring_calibs(yaws),
                                  views.ring_calibs(yaws))

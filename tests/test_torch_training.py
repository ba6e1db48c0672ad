"""PyTorch port, training: the optimizers against optax, the loss and
gradients of ``MonoPortNet`` against ``jax.value_and_grad``, three
``make_train_step`` steps against the JAX package's, the scan step, the
soft-onehot normalizer, the metrics and ``init_params``, all on the CPU at
small sizes (1-2 stack HGFilters at 64^2, ResnetFilter, batch 2, 256
points). Weights are drawn by the port's ``init_params`` (numpy-free CPU
generator) and cross to flax through ``weights.flax_params_from_torch``.

The card check (chip_smoke phase 13) holds full-width steps to
``monoport_tpu_torch/data/train_golden.npz`` (``frame_check.GOLDEN_TRAIN``);
write it with
``JAX_PLATFORMS=cpu python tests/test_torch_training.py --write`` (JAX on
the CPU, ~3 min).
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

from monoport_tpu.config import CN as JCN  # noqa: E402
from monoport_tpu.models import MonoPortNet as JaxNet  # noqa: E402
from monoport_tpu.parallel import train_step as jts  # noqa: E402
from monoport_tpu_torch import frame_check, weights  # noqa: E402
from monoport_tpu_torch.config import CN  # noqa: E402
from monoport_tpu_torch.models.monoport_net import MonoPortNet  # noqa: E402
from monoport_tpu_torch.parallel import train_step as ts  # noqa: E402

torch.set_num_threads(2)
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)


# -- helpers -----------------------------------------------------------------
def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _close_scaled(got: dict, want: dict, atol: float, rtol: float,
                  floor: float = 0.0):
    """Every leaf within atol of its largest |value| plus rtol of itself.
    ``floor`` (a share of the largest |value| of all leaves) keeps the
    scale of a leaf that is zero but for rounding (the bias of a conv
    before a BatchNorm) off its own noise."""
    assert set(got) == set(want)
    top = max(np.abs(np.asarray(w, np.float64)).max() for w in want.values())
    for k in want:
        w = np.asarray(want[k], np.float64)
        scale = max(np.abs(w).max(), floor * top, 1e-30)
        np.testing.assert_allclose(np.asarray(got[k], np.float64) / scale,
                                   w / scale, atol=atol, rtol=rtol,
                                   err_msg=k)


def _opts(kind: str) -> dict:
    hg = {"IMF": "PIFuHGFilters", "num_stack": 2, "num_hourglass": 1,
          "hourglass_dim": 16, "norm": "group", "hg_down": "ave_pool"}
    o = {"projection": "orthogonal", "normalizer": {"IMF": "PIFuNomalizer"}}
    if kind == "G":       # two stacks: two supervised stages
        o.update(backbone=hg, head={"IMF": "PIFuNetGMLP"},
                 loss={"IMF": "MSE"})
    elif kind == "B":     # train-mode BatchNorm
        o.update(backbone={**hg, "num_stack": 1, "norm": "batch_train"},
                 head={"IMF": "PIFuNetGMLP"}, loss={"IMF": "MSE"})
    else:                 # netC with a feat_prior of 16 channels
        o.update(backbone={"IMF": "PIFuResBlkFilters"},
                 head={"IMF": "PIFuNetCMLP"}, loss={"IMF": "L1"})
    return o


HEADS = {"G": (17, 1024, 512, 256, 128, 1), "B": (17, 1024, 512, 256, 128, 1),
         "C": (273, 1024, 512, 256, 128, 3)}


def _batch(kind: str, seed: int = 0, size: int = 64, n: int = 256) -> dict:
    rng = np.random.RandomState(seed)
    b = {"images": rng.rand(2, size, size, 3).astype(np.float32) * 2 - 1,
         # some points fall outside the image: in_img masks them
         "points": rng.uniform(-1.1, 1.1, (2, n, 3)).astype(np.float32),
         "calibs": np.tile(np.diag([1.0, 1.0, 0.9, 1.0]).astype(np.float32),
                           (2, 1, 1))}
    if kind == "C":
        b["labels"] = rng.uniform(-1, 1, (2, n, 3)).astype(np.float32)
        b["feat_prior"] = rng.randn(2, 8, 8, 16).astype(np.float32)
    else:
        b["labels"] = (rng.rand(2, n, 1) > 0.5).astype(np.float32)
    return b


def _port_net(kind: str, seed: int = 0) -> MonoPortNet:
    net = MonoPortNet(CN(_opts(kind)), head_channels=HEADS[kind])
    return ts.init_params(net, torch.Generator().manual_seed(seed))


def _variables(net: MonoPortNet) -> dict:
    return weights.flax_params_from_torch(net.state_dict())


def _tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_loss_fn(jnet):
    def loss_fn(params, stats, batch):
        kw = dict(labels=batch["labels"], feat_prior=batch.get("feat_prior"),
                  train=True)
        args = (batch["images"], batch["points"], batch["calibs"])
        if stats is None:
            return jnet.apply({"params": params}, *args, **kw)[1], None
        (_, loss), new = jnet.apply({"params": params, "batch_stats": stats},
                                    *args, mutable=["batch_stats"], **kw)
        return loss, new["batch_stats"]
    return loss_fn


def _jax_value_and_grad(kind, variables, batch, f64):
    jnet = JaxNet(JCN(_opts(kind)))
    fn = jax.jit(jax.value_and_grad(_jax_loss_fn(jnet), has_aux=True))
    args = (variables["params"], variables.get("batch_stats"), batch)
    if not f64:
        return fn(*args)
    with jax.enable_x64(True):
        args = jax.tree.map(lambda t: np.asarray(t, np.float64), args)
        return jax.tree.map(np.asarray, fn(*args))


# -- optimizers --------------------------------------------------------------
def _grads_sequence(shapes, steps=6):
    rng = np.random.RandomState(4)
    return [[rng.randn(*s).astype(np.float32) * (0.5 + k) for s in shapes]
            for k in range(steps)]


def _run_pair(jtx, ttx, steps=6):
    """Both optimizers over the same 6 gradients; params after each step
    and the final state."""
    shapes = [(3, 4), (5,), (2, 3, 3, 2)]
    p0 = [np.random.RandomState(3).randn(*s).astype(np.float32)
          for s in shapes]
    jp = {str(i): jnp.asarray(p) for i, p in enumerate(p0)}
    js = jtx.init(jp)
    tp = [torch.tensor(p) for p in p0]
    tstate = ttx.init(tp)
    for k, g in enumerate(_grads_sequence(shapes, steps)):
        u, js = jtx.update({str(i): jnp.asarray(x) for i, x in enumerate(g)},
                           js, jp)
        jp = optax.apply_updates(jp, u)
        torch._foreach_add_(tp, ttx.update([torch.tensor(x) for x in g],
                                           tstate, tp, k))
        _close_scaled({str(i): t.numpy() for i, t in enumerate(tp)},
                      {k2: np.asarray(v) for k2, v in jp.items()},
                      atol=1e-6, rtol=1e-6)
    return js, tstate


OPT_CASES = [(name, kw, extra)
             for name, kw in [("sgd", {}), ("sgd", {"momentum": 0.9}),
                              ("adam", {}), ("rmsprop", {"momentum": 0.9}),
                              ("adadelta", {})]
             for extra in [{}, {"weight_decay": 1e-2, "schedule": (2, 4),
                                "gamma": 0.1, "grad_clip": 1.0}]]


@pytest.mark.parametrize("name,kw,extra", OPT_CASES,
                         ids=[f"{c[0]}{'-m' if c[1] else ''}"
                              f"{'-wd-sched-clip' if c[2] else ''}"
                              for c in OPT_CASES])
def test_optimizer_matches_optax(name, kw, extra):
    lr = 1.0 if name == "adadelta" else 1e-2
    js, tstate = _run_pair(jts.make_optimizer(name, lr, **kw, **extra),
                           ts.make_optimizer(name, lr, **kw, **extra))
    # the moments too: optax's state leaves in chain order against the
    # port's slots in chain order
    want = [np.asarray(x) for x in jax.tree.leaves(js)
            if np.ndim(x) > 0]
    got = [t.numpy() for slot in tstate.values() for t in slot]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close_scaled({"s": g}, {"s": w}, atol=1e-6, rtol=1e-6)


def test_cosine_schedule_and_unclipped_clip_match_optax():
    """The capsule apps' chains: clip (not triggered at 1e3) -> Adam on a
    cosine schedule that reaches its floor before the last step."""
    jtx = optax.chain(optax.clip_by_global_norm(1e3), optax.adam(
        optax.cosine_decay_schedule(1e-2, 4, alpha=0.05)))
    ttx = ts.Optimizer(ts.ClipByGlobalNorm(1e3), ts.ScaleByAdam(),
                       ts.ScaleByLearningRate(
                           ts.cosine_decay_schedule(1e-2, 4, alpha=0.05)))
    _run_pair(jtx, ttx)
    sched = optax.cosine_decay_schedule(3e-4, 10, alpha=0.05)
    mine = ts.cosine_decay_schedule(3e-4, 10, alpha=0.05)
    np.testing.assert_allclose([mine(c) for c in range(13)],
                               [float(sched(c)) for c in range(13)],
                               rtol=1e-6)
    pw = optax.piecewise_constant_schedule(1.0, {3: 0.1, 5: 0.1})
    mine = ts.piecewise_constant_schedule(1.0, {3: 0.1, 5: 0.1})
    np.testing.assert_allclose([mine(c) for c in range(8)],
                               [float(pw(c)) for c in range(8)], rtol=1e-6)


# -- loss and gradients ------------------------------------------------------
# where f64 runs: JAX's f32 GroupNorm moments (E[x^2] - E[x]^2) over the
# ResnetFilter's 64^2 stem put its early gradients up to 4e-2 of their
# largest value off its own f64 ones (the port's f32 stays within 2.3e-6);
# the 2-stack netG's inner hourglass normalises 8x8 groups, where the
# port's f32 backward is also 1.2e-3 off, and the BatchNorm net's first
# norm scale has a gradient 1e-5 of the net's largest that both f32
# backwards get 1.5-3% wrong (f64 on both sides: within 1e-9)
F64 = {"G": "both", "C": "jax", "B": "both"}


@pytest.mark.parametrize("kind", ["G", "C", "B"])
def test_loss_and_grads_match_jax(kind):
    """The loss (rtol 1e-5) and every gradient leaf (within 2e-5 of its
    largest value plus 1e-4 of itself) against ``jax.value_and_grad``;
    BatchNorm's updated running stats rtol 1e-5 (``F64``: which side runs
    in f64). Leaves that are zero but for rounding (a conv bias before a
    BatchNorm) are scaled by 1e-4 of the net's largest gradient."""
    net = _port_net(kind)
    variables = _variables(net)
    batch = _batch(kind)
    (want_loss, stats), grads = _jax_value_and_grad(kind, variables, batch,
                                                    F64[kind] is not None)
    net.train()
    _, loss = net(**_tensors(batch), train=True)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    if F64[kind] == "both":
        net.load_state_dict(weights.torch_state_from_flax(variables))
        net.double()
        _, loss = net(**{k: v.double() for k, v in _tensors(batch).items()},
                      train=True)
        np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                                   rtol=1e-12)
    loss.backward()
    got = weights.flax_params_from_torch(
        {n: p.grad for n, p in net.named_parameters()})["params"]
    _close_scaled(_flat(got), _flat(grads), atol=2e-5, rtol=1e-4,
                  floor=1e-4)
    if kind == "B":
        moved = weights.flax_params_from_torch(net.state_dict())
        _close_scaled(_flat(moved["batch_stats"]), _flat(stats),
                      atol=0.0, rtol=1e-5)


def test_query_train_supervises_every_stage():
    """train=True: one masked prediction a stage (2 for a 2-stack
    HGFilter), the loss their mean; train=False: the last stage only."""
    net = _port_net("G").eval()
    b = _tensors(_batch("G"))
    with torch.no_grad():
        feats = net.filter(b["images"])
        preds = net.query(feats, b["points"], b["calibs"], train=True)
        last = net.query(feats, b["points"], b["calibs"])
    assert len(preds) == 2 and len(last) == 1
    torch.testing.assert_close(preds[-1], last[0], rtol=0, atol=0)
    outside = (b["points"][..., :2].abs() > 1.0).any(-1)
    assert outside.any() and (preds[0][outside] == 0).all()
    want = sum(((p - b["labels"]) ** 2).mean() for p in preds) / 2
    torch.testing.assert_close(net.get_loss(preds, b["labels"]), want)


# -- train steps -------------------------------------------------------------
STEP_CASES = {"G": {}, "B": {"weight_decay": 1e-3, "grad_clip": 1.0}}


@pytest.mark.parametrize("kind", ["G", "B"])
def test_three_train_steps_match_jax(kind):
    """Three steps of ``make_train_step`` on three batches against the JAX
    package's, in f32: losses rtol 1e-4, BatchNorm running stats rtol
    1e-5. SGD with momentum, a rule linear in the gradient (the rules
    themselves are held to optax above): Adam's and RMSprop's first
    update is about lr * g / |g|, so a gradient that is rounding noise in
    both frameworks (a conv bias before a BatchNorm) moves a full lr in a
    direction its noise picks."""
    kw = STEP_CASES[kind]
    net = _port_net(kind)
    variables = _variables(net)
    batches = [_batch(kind, seed) for seed in range(3)]

    jtx = jts.make_optimizer("sgd", 0.5, momentum=0.9, **kw)
    jstate = jts.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        opt_state=jtx.init(variables["params"]), tx=jtx,
        batch_stats=variables.get("batch_stats"))
    jstep = jts.make_train_step(JaxNet(JCN(_opts(kind))))
    want = []
    for b in batches:
        jstate, loss = jstep(jstate, b)
        want.append(float(loss))

    state = ts.create_train_state(net, ts.make_optimizer(
        "sgd", 0.5, momentum=0.9, **kw))
    step = ts.make_train_step(net)
    got = []
    for b in batches:
        state, loss = step(state, _tensors(b))
        got.append(float(loss))
    assert state.step == 3
    np.testing.assert_allclose(got, want, rtol=1e-4)
    if kind == "B":
        moved = weights.flax_params_from_torch(net.state_dict())
        # (plus 1e-6 of a leaf's largest value: bn1's running means near 0
        # move 9e-7 of it apart over three f32 steps at lr 0.5)
        _close_scaled(_flat(moved["batch_stats"]),
                      _flat(jax.tree.map(np.asarray, jstate.batch_stats)),
                      atol=1e-6, rtol=1e-5)


def test_scan_train_step_equals_loop():
    batches = [_tensors(_batch("B", seed, size=32, n=64))
               for seed in range(3)]
    results = []
    for scan in (False, True):
        net = _port_net("B")
        state = ts.create_train_state(net, ts.make_optimizer("adam", 1e-3))
        if scan:
            stacked = {k: torch.stack([b[k] for b in batches])
                       for k in batches[0]}
            state, losses = ts.make_scan_train_step(net)(state, stacked)
        else:
            step = ts.make_train_step(net)
            losses = torch.stack([step(state, b)[1] for b in batches])
        results.append((losses, net.state_dict()))
    torch.testing.assert_close(results[0][0], results[1][0], rtol=0, atol=0)
    for k, v in results[0][1].items():
        torch.testing.assert_close(v, results[1][1][k], rtol=0, atol=0)


def test_world_of_one_mesh_step_is_the_plain_step():
    """``make_train_step`` and ``make_scan_train_step`` under a mesh of a
    world of one (no process group) equal the steps without a mesh, bit
    for bit; ``create_train_state`` under it changes nothing."""
    from monoport_tpu_torch.parallel.mesh import make_mesh

    batches = [_tensors(_batch("B", seed, size=32, n=64))
               for seed in range(2)]
    stacked = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    results = []
    for mesh in (None, make_mesh()):
        assert mesh is None or mesh.shape == {"data": 1, "points": 1}
        net = _port_net("B")
        tx = ts.make_optimizer("sgd", 0.5, momentum=0.9, grad_clip=1.0)
        state = ts.create_train_state(net, tx, mesh=mesh)
        state, loss = ts.make_train_step(net, mesh)(state, batches[0])
        state, losses = ts.make_scan_train_step(net, mesh)(state, stacked)
        results.append((torch.cat([loss[None], losses]), net.state_dict()))
    torch.testing.assert_close(results[0][0], results[1][0], rtol=0, atol=0)
    for k, v in results[0][1].items():
        torch.testing.assert_close(v, results[1][1][k], rtol=0, atol=0)
    for make in (ts.make_train_step, ts.make_scan_train_step):
        with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
            make(net, mesh=object())


# -- small pieces ------------------------------------------------------------
def test_soft_onehot_normalizer_matches_jax():
    from monoport_tpu.models.normalizers import DepthNormalizer as JaxNorm
    from monoport_tpu_torch.models.normalizers import DepthNormalizer

    z = np.random.RandomState(2).uniform(-1.3, 1.3, (2, 50, 1))
    # bins hit exactly (floor == ceil: the ceil write wins) and the ends
    z[0, :5, 0] = [-1.0, 1.0, 0.0, -1.0 + 2.0 / 15, 1.0 - 4.0 / 15]
    z = z.astype(np.float32)
    want = JaxNorm(soft_onehot=True, soft_dim=16)(jnp.asarray(z))
    got = DepthNormalizer(soft_onehot=True, soft_dim=16)(torch.from_numpy(z))
    assert got.shape == (2, 50, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)
    opt = _opts("G")
    opt["normalizer"] = {"IMF": "PIFuNomalizer", "soft_onehot": True,
                         "soft_dim": 16}
    net = MonoPortNet(CN(opt), head_channels=(32, 8, 1))
    with pytest.raises(ValueError, match="scalar z normalizer"):
        net.query_taps([[torch.zeros(1, 4, 4, 16)]], torch.zeros(1, 3, 2),
                       torch.zeros(1, 3, 2))


def test_metrics_match_jax():
    from monoport_tpu.training import metrics as jm
    from monoport_tpu_torch.training import metrics as tm

    rng = np.random.RandomState(9)
    pred, target = rng.rand(2, 300, 1), (rng.rand(2, 300, 1) > 0.4) * 1.0
    for fn in ("occupancy_iou", "occupancy_accuracy"):
        np.testing.assert_allclose(
            float(getattr(tm, fn)(torch.tensor(pred), torch.tensor(target))),
            float(getattr(jm, fn)(jnp.asarray(pred), jnp.asarray(target))),
            rtol=1e-6)
    a, b = rng.rand(3000, 3), rng.rand(2500, 3)
    assert tm.chamfer_distance(a, b) == jm.chamfer_distance(a, b)
    assert tm.point_to_surface(a, b) == jm.point_to_surface(a, b)
    img, ref = rng.rand(8, 8, 3), rng.rand(8, 8, 3)
    mask = rng.rand(8, 8) > 0.3
    assert tm.masked_psnr(img, ref, mask) == jm.masked_psnr(img, ref, mask)

    net = _port_net("B")
    variables = _variables(net)
    batch = _batch("B")
    from monoport_tpu.models.monoport_net import eval_net as jax_eval_net
    want = jm.evaluate_occupancy(jax_eval_net(JaxNet(JCN(_opts("B")))),
                                 variables, batch)
    from monoport_tpu_torch.models.monoport_net import eval_net
    got = tm.evaluate_occupancy(eval_net(net), _tensors(batch))
    assert set(got) == {"iou", "accuracy", "mse"}
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6)


def test_init_params_follows_flax_distributions():
    """Dense / Conv kernels: lecun_normal (std within 5% of flax's at a
    512-wide layer, cut at 2 std); biases 0; norms scale 1, bias 0; netC's
    head output layer at 1e-4 of the variance."""
    import flax.linen as fnn
    from monoport_tpu_torch.models.heads import PIFuNetCMLP, SurfaceClassifier

    head = ts.init_params(SurfaceClassifier((512, 512, 512, 1)),
                          torch.Generator().manual_seed(1))
    w = head.filters_1.weight.detach().numpy()          # [512, 1024]
    flax_w = np.asarray(fnn.initializers.lecun_normal()(
        jax.random.PRNGKey(0), (1024, 512)))
    assert abs(w.std() / flax_w.std() - 1.0) < 0.05
    assert abs(w.std() * np.sqrt(1024) - 1.0) < 0.05
    assert np.abs(w).max() <= 2.0 / 0.87962566103423978 / np.sqrt(1024)
    assert all((lin.bias == 0).all() for lin in head.layers())

    c = ts.init_params(PIFuNetCMLP(), torch.Generator().manual_seed(1))
    out = c.filters_4.weight.detach().numpy()            # [3, 128 + 513]
    assert abs(out.std() * np.sqrt(641 / 1e-4) - 1.0) < 0.1
    net = _port_net("B")
    bn = net.image_filter.bn1
    assert (bn.weight == 1).all() and (bn.bias == 0).all()
    assert (bn.running_var == 1).all() and (bn.running_mean == 0).all()
    conv = net.image_filter.conv1.weight.detach().numpy()
    assert abs(conv.std() * np.sqrt(3 * 49) - 1.0) < 0.1


# -- the golden of chip_smoke phase 13 ----------------------------------------
def _write_golden(path: str = frame_check.GOLDEN_TRAIN) -> None:
    """Full-width parity golden: JAX on the CPU, f32 (``--write``)."""
    from monoport_tpu.config import get_cfg_defaults
    from monoport_tpu.training.datasets import capsule as jcap
    from monoport_tpu.utils.params_io import load_params

    data = os.path.join(ROOT, "monoport_tpu", "data")
    cfg = get_cfg_defaults()
    out = {}
    g = jcap.synth_train_batch(jax.random.PRNGKey(7), batch=2, size=512,
                               n_points=4096, hard=True)
    out["g_images"] = np.asarray(g["images"], np.float16)
    out["g_points"] = np.asarray(g["points"], np.float32)
    out["g_labels"] = np.asarray(g["labels"], np.float32)

    def colour_item(key):
        k_skel, k_cloth, k_app, k_pts = jax.random.split(key, 4)
        caps = jcap.clothe(k_cloth, jcap.skeleton3d(
            k_skel, scale_range=(0.45, 1.0), pose_spread=1.35,
            z_spread=0.35))
        app = jcap.sample_appearance(k_app)
        image, _ = jcap.render_front(caps, 512, appearance=app)
        pts = jcap.sample_surface_points(k_pts, caps, 4096)
        return image, pts, jcap.surface_color(pts, appearance=app)

    image, pts, colours = jax.vmap(colour_item)(
        jax.random.split(jax.random.PRNGKey(8), 2))
    out["c_images"] = np.asarray(image, np.float16)
    out["c_points"] = np.asarray(pts, np.float32)
    out["c_labels"] = np.asarray(colours, np.float32)
    eye = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))

    netG = JaxNet(cfg.netG)
    netC = JaxNet(cfg.netC)
    params_g = load_params(os.path.join(data, "netg_capsule.npz"))[0]
    params_c = load_params(os.path.join(data, "netc_capsule.npz"))[0]
    c_images = jnp.asarray(out["c_images"], jnp.float32)
    prior = jax.jit(lambda p, x: netG.apply({"params": p}, x,
                                            method="filter")[-1][-1])(
        params_g, c_images)
    runs = {
        "g": (netG, params_g, optax.adam(optax.cosine_decay_schedule(
            1e-3, 1500, alpha=0.05)),
            {"images": jnp.asarray(out["g_images"], jnp.float32),
             "points": out["g_points"], "calibs": eye,
             "labels": out["g_labels"]}),
        "c": (netC, params_c, optax.chain(
            optax.clip_by_global_norm(1.0), optax.adam(
                optax.cosine_decay_schedule(3e-4, 3000, alpha=0.05))),
            {"images": c_images, "points": out["c_points"],
             "calibs": eye, "labels": out["c_labels"],
             "feat_prior": prior}),
    }
    for tag, (net, params, tx, batch) in runs.items():
        loss_fn = _jax_loss_fn(net)
        vg = jax.jit(jax.value_and_grad(
            lambda p, b: loss_fn(p, None, b)[0]))
        loss, grads = vg(params, batch)
        out[f"{tag}_loss"] = np.float32(loss)
        summary = frame_check.grad_summary(
            jax.tree.map(np.asarray, grads))
        names = sorted(summary)
        out[f"{tag}_grad_names"] = np.asarray(names)
        out[f"{tag}_grad_norms"] = np.asarray([summary[n][0] for n in names])
        out[f"{tag}_grad_dots"] = np.asarray([summary[n][1] for n in names])

        @jax.jit
        def step(p, s, b):
            loss, grads = vg(p, b)
            upd, s = tx.update(grads, s, p)
            return optax.apply_updates(p, upd), s, loss

        p, s, losses = params, tx.init(params), []
        for _ in range(3):
            p, s, loss = step(p, s, batch)
            losses.append(float(loss))
        out[f"{tag}_step_losses"] = np.asarray(losses, np.float32)
        print(tag, float(out[f"{tag}_loss"]), losses, flush=True)
    np.savez_compressed(path, **out)
    print("wrote", path, os.path.getsize(path), "bytes")


if __name__ == "__main__":
    if "--write" in sys.argv:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_default_matmul_precision", "highest")
        _write_golden()

"""PyTorch port, training of the perception nets against monoport_tpu on
the CPU: ``optax_sigmoid_bce``, ``matting_loss`` and ``detection_loss``
(values and gradients against ``jax.value_and_grad``), the composite and
scene builders fed the JAX package's own draws
(tests/torch_perception_draws.py), three Adam steps of each net,
``alpha_iou`` / ``box_iou``, the npz round trips both ways, a falling
detection loss, and both apps' ``main`` on the CPU. Small sizes (width
4-8, 32-128^2), 2 torch threads. The committed nets' gates are in
tests/test_torch_perception_gates.py.

The card check (chip_smoke's phase ``train_perception``) holds full-width
steps to ``monoport_tpu_torch/data/perception_train_golden.npz``; write it
with ``JAX_PLATFORMS=cpu python tests/test_torch_perception_training.py
--write`` (JAX on the CPU, f32)."""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from monoport_tpu.pipeline import detection as jdet  # noqa: E402
from monoport_tpu.pipeline import segmentation as jseg  # noqa: E402
from monoport_tpu.training import detection as jtd  # noqa: E402
from monoport_tpu.training import matting as jtm  # noqa: E402
from monoport_tpu_torch import frame_check, weights  # noqa: E402
from monoport_tpu_torch.parallel import train_step as ts  # noqa: E402
from monoport_tpu_torch.pipeline import detection as pdet  # noqa: E402
from monoport_tpu_torch.pipeline import segmentation as pseg  # noqa: E402
from monoport_tpu_torch.training import detection as ptd  # noqa: E402
from monoport_tpu_torch.training import matting as ptm  # noqa: E402
from torch_perception_draws import (compile_fast, port_composites,  # noqa
                                    port_scenes, synth_fn)

torch.set_num_threads(2)
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
DATA = os.path.join(ROOT, "monoport_tpu", "data")
GOLDEN = frame_check.GOLDEN_PERCEPTION_TRAIN


def _jax_grid(size):
    ax = jnp.linspace(-1.0, 1.0, size)
    gx, gy = jnp.meshgrid(ax, -ax, indexing="xy")
    return jnp.stack([gx, gy], axis=-1)


# -- helpers ------------------------------------------------------------------
def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _close_scaled(got: dict, want: dict, atol: float, rtol: float):
    """Every leaf within atol of its largest |value| plus rtol of itself."""
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k], np.float64)
        scale = max(np.abs(w).max(), 1e-30)
        np.testing.assert_allclose(np.asarray(got[k], np.float64) / scale,
                                   w / scale, atol=atol, rtol=rtol,
                                   err_msg=k)


def _nets(kind: str, width: int, seed: int = 0):
    """(port net with flax-distributed weights, JAX module, its variables)."""
    gen = torch.Generator().manual_seed(seed)
    if kind == "matte":
        net = pseg.MatteNet(width=width)
        ptm.init_params(net, gen)
        jnet = jseg.MatteNet(width=width)
    else:
        net = ptd.init_detectnet(pdet.DetectNet(width=width), gen)
        jnet = jdet.DetectNet(width=width)
    return net, jnet, weights.flax_params_from_torch(net.state_dict())


def _jax_loss(kind, jnet):
    if kind == "matte":
        return lambda v, b: jseg.matting_loss(v, jnet, *b)
    return lambda v, b: jtd.detection_loss(v, jnet, *b)


def _port_loss(kind):
    return pseg.matting_loss if kind == "matte" else ptd.detection_loss


def _jax_batch(kind, key, batch, size):
    return synth_fn("matte" if kind == "matte" else "scene", batch, size)(key)


def _f64(t):
    t = np.asarray(t)
    return t.astype(np.float64) if t.dtype.kind == "f" else t


def _tensors(batch):
    return [torch.from_numpy(np.array(x)) for x in batch]


# -- losses -------------------------------------------------------------------
def test_optax_sigmoid_bce_matches_optax():
    rng = np.random.RandomState(0)
    logits = (rng.randn(4, 33, 17) * 6).astype(np.float32)
    labels = rng.rand(4, 33, 17).astype(np.float32)
    labels[0] = labels[0] > 0.5
    want = optax.sigmoid_binary_cross_entropy(logits, labels)
    got = pseg.optax_sigmoid_bce(torch.from_numpy(logits),
                                 torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("kind", ["matte", "detect"])
def test_loss_and_grads_match_jax(kind):
    """The loss (rtol 1e-5) and every gradient leaf (within 2e-5 of its
    largest value plus 1e-4 of itself) against ``jax.value_and_grad`` run
    in f64: JAX's f32 GroupNorm moments (E[x^2] - E[x]^2) are the weak
    side, as in tests/test_torch_training.py. MatteNet width 8 at 64^2,
    DetectNet width 8, stride 16 at 128^2, batch 2, on JAX's synthetic
    batches."""
    size = 64 if kind == "matte" else 128
    net, jnet, variables = _nets(kind, 8)
    batch = _jax_batch(kind, jax.random.PRNGKey(5), 2, size)
    with jax.enable_x64(True):
        args = jax.tree.map(_f64, (variables, batch))
        want_loss, grads = jax.tree.map(np.asarray, compile_fast(
            jax.value_and_grad(_jax_loss(kind, jnet)), *args)(*args))
    loss = _port_loss(kind)(net, *_tensors(batch))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    loss.backward()
    got = weights.flax_params_from_torch(
        {n: p.grad for n, p in net.named_parameters()})
    _close_scaled(_flat(got), _flat(grads), atol=2e-5, rtol=1e-4)


def test_detection_loss_truncates_then_clips_centres():
    """A centre left of the frame truncates toward zero (cell 0, as
    ``astype``), one right of it clips to the last cell; the L1 terms read
    those cells in both packages."""
    net, jnet, variables = _nets("detect", 4)
    images = np.random.RandomState(0).rand(1, 64, 64, 3).astype(np.float32)
    boxes = np.asarray([[[-40.0, 2.0, 20.0, 30.0], [50.0, 5.0, 90.0, 60.0],
                         [10.0, 10.0, 30.0, 30.0], [0.0, 0.0, 0.0, 0.0]]],
                       np.float32)
    valid = np.asarray([[True, True, True, False]])
    args = (variables, (images, boxes, valid))
    want = compile_fast(_jax_loss("detect", jnet), *args)(*args)
    got = ptd.detection_loss(net, *_tensors((images, boxes, valid)))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)


# -- generators on JAX's draws ------------------------------------------------
def test_pixel_grid_is_jax_linspace():
    """The correctly rounded grid is within an f32 ulp of jnp.linspace's."""
    for size in (32, 97, 512):
        np.testing.assert_allclose(ptm.pixel_grid(size, "cpu").numpy(),
                                   np.asarray(_jax_grid(size)), atol=1.2e-7,
                                   rtol=0)


@pytest.mark.parametrize("seed", [0, 3])
def test_composites_from_jax_draws(seed):
    """Images within 1e-5 (``_texture`` takes sin of up to ~50 rad in f32),
    mattes within 1e-4; 6 composites at 96^2 (seed 3 holds a person-free
    frame)."""
    key = jax.random.PRNGKey(seed)
    want_img, want_alpha = _jax_batch("matte", key, 6, 96)
    img, alpha = port_composites(key, 6, 96)
    np.testing.assert_allclose(img.numpy(), np.asarray(want_img), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(want_alpha),
                               atol=1e-4, rtol=0)
    if seed == 3:
        assert (alpha.flatten(1).amax(1) == 0).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_scenes_from_jax_draws(seed):
    """Images within 1e-5, boxes within 1e-4, ``valid`` equal; 4 scenes at
    96^2."""
    key = jax.random.PRNGKey(seed)
    want = _jax_batch("detect", key, 4, 96)
    got = port_scenes(key, 4, 96)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert 0 < int(got[2].sum()) < got[2].numel()


def test_generators_on_a_torch_generator():
    """The port's own draws: shapes, dtypes and ranges; a person in most
    composites; boxes inside the frame where valid; reproducible from a
    seed."""
    gen = torch.Generator().manual_seed(0)
    img, alpha = ptm.synth_batch(gen, 8, 64)
    assert img.shape == (8, 64, 64, 3) and alpha.shape == (8, 64, 64)
    assert 0.0 <= float(img.min()) and float(img.max()) <= 1.0
    assert (alpha.flatten(1).amax(1) > 0.5).sum() >= 4
    one, a1 = ptm.synth_composite(torch.Generator().manual_seed(0), 64)
    assert one.shape == (64, 64, 3) and a1.shape == (64, 64)
    images, boxes, valid = ptd.synth_det_batch(gen, 8, 64)
    assert images.shape == (8, 64, 64, 3) and boxes.shape == (8, 4, 4)
    assert valid.dtype == torch.bool and bool(valid.any())
    b = boxes[valid]
    assert float(b.min()) >= 0.0 and float(b.max()) <= 63.0
    assert (b[:, 2] >= b[:, 0]).all() and (b[:, 3] >= b[:, 1]).all()
    again = ptd.synth_det_batch(torch.Generator().manual_seed(5), 2, 32)
    other = ptd.synth_det_batch(torch.Generator().manual_seed(5), 2, 32)
    for x, y in zip(again, other):
        assert torch.equal(x, y)


# -- training -----------------------------------------------------------------
@pytest.mark.parametrize("kind", ["matte", "detect"])
def test_three_adam_steps_match_jax(kind):
    """Three steps of the port's Adam (``make_train_fns``' state,
    ``loss_step``) on three fixed batches against optax's Adam on
    ``jax.value_and_grad``, both in f64 (in f32 the two GroupNorms'
    moments differ in the last bits, and Adam's first update is about lr *
    sign(g)): the losses rtol 1e-6, the parameters after the steps within
    2e-5 of each leaf's largest value. The port rounds Adam's bias
    correction 1 - b^t to f32, as optax does in f32 (held to optax at 1e-7
    in tests/test_torch_training.py), where JAX in x64 keeps it in f64:
    1 - f32(0.999) is 1.3e-5 off 1e-3, so a sign-like first update differs
    by 6.5e-6 of itself (6.8e-6 measured; losses 2e-7). MatteNet width 4
    at 32^2, DetectNet width 4 at 64^2, batch 2."""
    size = 32 if kind == "matte" else 64
    module = pseg.MatteNet(width=4) if kind == "matte" else \
        pdet.DetectNet(width=4)
    fns = (ptm.make_train_fns if kind == "matte" else ptd.make_train_fns)
    init_fn, _ = fns(module, size, 2, learning_rate=1e-3)
    state = init_fn(torch.Generator().manual_seed(1))
    variables = weights.flax_params_from_torch(module.state_dict())
    batches = [_jax_batch(kind, jax.random.PRNGKey(10 + i), 2, size)
               for i in range(3)]
    if kind == "detect":
        head = variables["params"]["Conv_0"]["bias"]
        np.testing.assert_array_equal(head, np.full((1,), -2.19, np.float32))
    module.double()
    got = [float(ts.loss_step(state, _port_loss(kind), *[
        t.double() if t.is_floating_point() else t for t in _tensors(b)]))
        for b in batches]
    jnet = jseg.MatteNet(width=4) if kind == "matte" else \
        jdet.DetectNet(width=4)
    with jax.enable_x64(True):
        params = jax.tree.map(_f64, variables)
        tx = optax.adam(1e-3)
        opt_state = tx.init(params)
        batches = [jax.tree.map(_f64, b) for b in batches]
        vg = jax.value_and_grad(_jax_loss(kind, jnet))

        def step(p, s, b):
            loss, grads = vg(p, b)
            upd, s = tx.update(grads, s, p)
            return optax.apply_updates(p, upd), s, loss

        step = compile_fast(step, params, opt_state, batches[0])
        want = []
        for b in batches:
            params, opt_state, loss = step(params, opt_state, b)
            want.append(float(loss))
        params = jax.tree.map(np.asarray, params)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert state.step == 3
    _close_scaled(_flat(weights.flax_params_from_torch(module.state_dict())),
                  _flat(params), atol=2e-5, rtol=0)


def test_detection_loss_falls():
    """tests/test_detection.py's gate: width 8, 128^2, batch 4; the mean
    of 30 steps below that of the first 5."""
    net = pdet.DetectNet(width=8)
    init_fn, run_fn = ptd.make_train_fns(net, 128, 4, 1e-3)
    state = init_fn(torch.Generator().manual_seed(0))
    state, l0 = run_fn(state, torch.Generator().manual_seed(1), 5)
    state, l1 = run_fn(state, torch.Generator().manual_seed(2), 30)
    assert state.step == 35
    assert float(l1) < float(l0), (float(l0), float(l1))


def test_cosine_schedule_runs_across_sizes():
    """Two sizes' run_fns on one state share one schedule: the count is the
    state's step."""
    net = pdet.DetectNet(width=4)
    fns = [ptd.make_train_fns(net, s, 2, 1e-2, total_steps=4)
           for s in (32, 64)]
    state = fns[0][0](torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    for init_fn, run_fn in fns:
        state, loss = run_fn(state, gen, 2)
        assert torch.isfinite(loss)
    assert state.step == 4
    lr = state.tx.transforms[-1].learning_rate
    sched = optax.cosine_decay_schedule(1e-2, 4, alpha=0.05)
    for count in range(5):
        assert lr(count) == pytest.approx(float(sched(count)), rel=1e-6)


def test_train_state_leaves_cudnn_alone(monkeypatch):
    """A library call changes nothing process-wide: ``create_train_state``
    leaves ``cudnn.benchmark`` as it found it; the apps' own call,
    ``timed_convolutions``, sets it on the card only."""
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    ts.create_train_state(pseg.MatteNet(width=4),
                          ts.make_optimizer("adam", 1e-3),
                          torch.Generator().manual_seed(0))
    ts.timed_convolutions("cpu")
    assert torch.backends.cudnn.benchmark is False
    ts.timed_convolutions("cuda")
    assert torch.backends.cudnn.benchmark is True


def test_alpha_iou_and_box_iou_match_jax():
    rng = np.random.RandomState(0)
    pred = rng.rand(5, 16, 16).astype(np.float32)
    gt = (rng.rand(5, 16, 16) > 0.6).astype(np.float32)
    gt[1] = 0.0                   # empty, and the prediction is not
    gt[2] = 0.0                   # empty, and so is the prediction
    pred[2] = 0.1
    pred[3] = 0.0                 # nothing predicted on a subject
    want = jtm.alpha_iou(jnp.asarray(pred), jnp.asarray(gt))
    got = ptm.alpha_iou(torch.from_numpy(pred), torch.from_numpy(gt))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    a = (rng.rand(3, 4, 4) * 50).astype(np.float32)
    b = (rng.rand(3, 4, 4) * 50).astype(np.float32)
    a[..., 2:] += a[..., :2]
    b[..., 2:] += b[..., :2]
    b[0, 0] = a[0, 0]             # identical boxes: 1
    b[0, 1] = [0.0, 0.0, 0.0, 0.0]  # an empty box: 0
    want = jtd.box_iou(jnp.asarray(a), jnp.asarray(b))
    got = ptd.box_iou(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)
    assert float(got[0, 0]) == pytest.approx(1.0)


# -- checkpoints --------------------------------------------------------------
def test_npz_round_trips_both_ways(tmp_path):
    """The port's files load in the JAX package (its ``load_params``, its
    nets' outputs equal the port's within 1e-3: the f16 file rounds both
    alike) and the JAX package's files load in the port, tensor for
    tensor."""
    from monoport_tpu.utils.params_io import load_params as jload
    from monoport_tpu_torch.utils.params_io import save_params as psave

    x = np.random.RandomState(0).rand(1, 32, 32, 3).astype(np.float32)
    net, jnet, _ = _nets("matte", 4)
    path = str(tmp_path / "m.npz")
    ptm.save_params(path, net, 4)
    params, width = jtm.load_params(path)
    assert width == 4 and set(params) == {"params"}
    back, width = ptm.load_params(path)
    net2 = weights.load_module(pseg.MatteNet(width=width), back, "cpu")
    want = jax.jit(jnet.apply)(params, jnp.asarray(x * 2 - 1))
    with torch.no_grad():
        got = net2(torch.from_numpy(x * 2 - 1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)

    det, jdnet, _ = _nets("detect", 4)
    path = str(tmp_path / "d.npz")
    psave(path, det, meta={"width": 4, "stride": 16})
    params, meta = jload(path)
    assert meta == {"width": 4, "stride": 16}
    jd = jdet.Detection({"params": params}, width=4, stride=16)
    pd = pdet.Detection.load_default(path, device="cpu")
    want = jd(jnp.asarray(x))
    got = pd(torch.from_numpy(x))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=1e-5)

    # the JAX package's file in the port
    jpath = str(tmp_path / "j.npz")
    jtm.save_params(jpath, jax.tree.map(np.asarray, jax.jit(jseg.MatteNet(
        width=4).init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))), 4)
    params, width = ptm.load_params(jpath)
    net3 = weights.load_module(pseg.MatteNet(width=width), params, "cpu")
    jparams = jload(jpath)[0]
    for name, t in _flat(weights.flax_params_from_torch(
            net3.state_dict())).items():
        np.testing.assert_array_equal(t, np.asarray(_flat(jparams)[name]))


# -- the committed nets: the JAX package's trained-net gates ------------------
# -- the apps -----------------------------------------------------------------
def test_train_matting_app_on_the_cpu(tmp_path):
    from monoport_tpu_torch.apps import train_matting

    out = str(tmp_path / "m.npz")
    res = train_matting.main(["--cpu", "--steps", "4", "--chunk", "2",
                              "--size", "32", "--batch", "2", "--width", "4",
                              "--out", out])
    assert res["chunk_steps"] == [2, 2]
    assert all(np.isfinite(res["chunk_losses"])) and 0 <= res["iou"] <= 1
    params, width = jtm.load_params(out)
    assert width == 4
    y = jax.jit(jseg.MatteNet(width=4).apply)(params,
                                              jnp.zeros((1, 32, 32, 3)))
    assert y.shape == (1, 32, 32, 1)


def test_train_detection_app_on_the_cpu(tmp_path):
    from monoport_tpu.utils.params_io import load_params as jload
    from monoport_tpu_torch.apps import train_detection

    out = str(tmp_path / "d.npz")
    res = train_detection.main(["--cpu", "--steps", "4", "--chunk", "1",
                                "--sizes", "32,64", "--batch", "2",
                                "--width", "4", "--out", out])
    assert res["chunk_sizes"] == [32, 64, 32, 64]
    assert all(np.isfinite(res["chunk_losses"]))
    assert set(res["heldout"]) == {32, 64}
    params, meta = jload(out)
    assert meta == {"width": 4, "stride": 16}
    boxes, probs = jdet.Detection({"params": params}, width=4, stride=16)(
        jnp.zeros((1, 64, 64, 3)))
    assert boxes.shape == (1, 4, 4)


def test_apps_need_a_card_without_cpu(monkeypatch):
    from monoport_tpu_torch.apps import train_detection, train_matting

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for app in (train_matting, train_detection):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            app.main(["--steps", "1"])


# -- the golden of chip_smoke's phase train_perception ------------------------
def _golden_batches():
    """(matte batch, detect batch) of the golden: JAX's draws, the images
    stored as uint8 (both packages read x / 255 in f32), the mattes as
    f16."""
    images, alpha = _jax_batch("matte", jax.random.PRNGKey(21), 8, 256)
    d_images, boxes, valid = _jax_batch("detect", jax.random.PRNGKey(22), 2,
                                        512)
    u8 = lambda x: np.round(np.asarray(x) * 255.0).astype(np.uint8)
    return ({"m_images": u8(images),
             "m_alpha": np.asarray(alpha, np.float16)},
            {"d_images": u8(d_images), "d_boxes": np.asarray(boxes),
             "d_valid": np.asarray(valid)})


def golden_batch(g: dict, tag: str) -> list:
    """A golden's batch as f32 numpy arrays (images x / 255, mattes from
    f16), boxes and flags as stored."""
    out = []
    for k in ([f"{tag}_images", f"{tag}_alpha"] if tag == "m"
              else [f"{tag}_images", f"{tag}_boxes", f"{tag}_valid"]):
        v = g[k]
        if v.dtype == np.uint8:
            v = v.astype(np.float32) / np.float32(255.0)
        elif v.dtype == np.float16:
            v = v.astype(np.float32)
        out.append(v)
    return out


def _write_golden(path: str = GOLDEN) -> None:
    """Full-width parity golden: JAX on the CPU, f32 (``--write``): a step
    of the committed MatteNet (width 16, 256^2, batch 8) and DetectNet
    (its width, stride 16, 512^2, batch 2) with the apps' Adam at 1e-3:
    the loss, each gradient leaf's norm and projection, and three steps'
    losses."""
    from monoport_tpu.utils.params_io import load_params as jload

    m, d = _golden_batches()
    out = {**m, **d}
    mparams, mwidth = jtm.load_params(os.path.join(DATA, "mattenet.npz"))
    dparams, dmeta = jload(os.path.join(DATA, "detectnet.npz"))
    runs = {"m": (jseg.MatteNet(width=mwidth), mparams,
                  tuple(golden_batch(out, "m")), "matte"),
            "d": (jdet.DetectNet(width=dmeta["width"],
                                 stride=dmeta["stride"]),
                  {"params": dparams}, tuple(golden_batch(out, "d")),
                  "detect")}
    for tag, (jnet, variables, batch, kind) in runs.items():
        vg = jax.jit(jax.value_and_grad(_jax_loss(kind, jnet)))
        loss, grads = vg(variables, batch)
        out[f"{tag}_loss"] = np.float32(loss)
        summary = frame_check.grad_summary(
            jax.tree.map(np.asarray, grads)["params"])
        names = sorted(summary)
        out[f"{tag}_grad_names"] = np.asarray(names)
        out[f"{tag}_grad_norms"] = np.asarray([summary[n][0] for n in names])
        out[f"{tag}_grad_dots"] = np.asarray([summary[n][1] for n in names])
        tx = optax.adam(1e-3)

        @jax.jit
        def step(p, s, b):
            loss, grads = vg(p, b)
            upd, s = tx.update(grads, s, p)
            return optax.apply_updates(p, upd), s, loss

        p, s, losses = variables, tx.init(variables), []
        for _ in range(3):
            p, s, loss = step(p, s, batch)
            losses.append(float(loss))
        out[f"{tag}_step_losses"] = np.asarray(losses, np.float32)
        print(tag, losses, flush=True)
    np.savez_compressed(path, **out)
    print("wrote", path, os.path.getsize(path), "bytes")


@pytest.mark.slow
def test_cpu_steps_match_golden():
    """The port's f32 steps on the CPU against the golden: the loss rtol
    1e-4, each gradient leaf's norm within 2e-3 of the golden's (f32
    GroupNorm moments on both sides), three steps' losses rtol 2e-3."""
    torch.set_num_threads(8)
    g = dict(np.load(GOLDEN))
    mparams, mwidth = ptm.load_params(os.path.join(DATA, "mattenet.npz"))
    dparams, dmeta = weights.load_params(os.path.join(DATA, "detectnet.npz"))
    batch = lambda tag: [torch.from_numpy(x) for x in golden_batch(g, tag)]
    runs = {"m": (pseg.MatteNet(width=mwidth), mparams, batch("m"),
                  pseg.matting_loss),
            "d": (pdet.DetectNet(width=dmeta["width"],
                                 stride=dmeta["stride"]), dparams,
                  batch("d"), ptd.detection_loss)}
    for tag, (net, params, batch, loss_fn) in runs.items():
        net = weights.load_module(net, params, "cpu")
        state = ts.create_train_state(net, ts.make_optimizer("adam", 1e-3))
        loss = loss_fn(net, *batch)
        loss.backward()
        mine = frame_check.grad_summary(weights.flax_params_from_torch(
            {n: p.grad for n, p in net.named_parameters()})["params"])
        names = [str(n) for n in g[f"{tag}_grad_names"]]
        assert sorted(mine) == names
        norms = np.asarray([mine[n][0] for n in names])
        np.testing.assert_allclose(norms, g[f"{tag}_grad_norms"], rtol=2e-3)
        np.testing.assert_allclose(float(loss.detach()),
                                   float(g[f"{tag}_loss"]), rtol=1e-4)
        losses = [float(ts.loss_step(state, loss_fn, *batch))
                  for _ in range(3)]
        np.testing.assert_allclose(losses, g[f"{tag}_step_losses"],
                                   rtol=2e-3)


if __name__ == "__main__":
    if "--write" in sys.argv:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_default_matmul_precision", "highest")
        _write_golden()

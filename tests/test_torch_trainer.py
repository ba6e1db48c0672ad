"""PyTorch port, the training loop and its files: the Trainer's checkpoint
round trip and resume (mirroring ``tests/test_training.py``), its eval
hook, ``train_epoch`` on the synthetic blobs and its mesh in a world of
two ranks; the npz interop with the JAX package in both directions; the
training apps (``apps.train`` for netG and netC, both capsule apps) on
the CPU at 64^2, each ending with a saved file that loads."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from monoport_tpu.config import CN as JCN
from monoport_tpu.models import MonoPortNet as JaxNet
from monoport_tpu_torch import weights
from monoport_tpu_torch.config import CN, get_cfg_defaults
from monoport_tpu_torch.models.monoport_net import MonoPortNet
from monoport_tpu_torch.parallel import train_step as ts
from monoport_tpu_torch.training import Trainer
from monoport_tpu_torch.training.datasets import SyntheticBlobDataset
from monoport_tpu_torch.utils.params_io import load_params, save_params

torch.set_num_threads(2)
TINY = ["netG.backbone.num_stack", "1", "netG.backbone.num_hourglass", "1",
        "netG.backbone.hourglass_dim", "32"]


def _opts(norm: str = "group") -> dict:
    return {"projection": "orthogonal",
            "normalizer": {"IMF": "PIFuNomalizer"},
            "backbone": {"IMF": "PIFuHGFilters", "num_stack": 1,
                         "num_hourglass": 1, "hourglass_dim": 32,
                         "norm": norm, "hg_down": "ave_pool"},
            "head": {"IMF": "PIFuNetGMLP"}, "loss": {"IMF": "MSE"}}


def _net(norm: str = "group") -> MonoPortNet:
    return MonoPortNet(CN(_opts(norm)),
                       head_channels=(33, 1024, 512, 256, 128, 1))


def _cfg(tmp_path, **over):
    cfg = get_cfg_defaults()
    cfg.checkpoints_path = str(tmp_path / "ckpt")
    cfg.results_path = str(tmp_path / "results")
    cfg.name = "t"
    cfg.optim = "adam"
    cfg.freq_plot = 1
    cfg.freq_save = 1000
    for k, v in over.items():
        cfg[k] = v
    return cfg


def _batch(n: int = 2, size: int = 64, points: int = 128) -> dict:
    ds = SyntheticBlobDataset(size=size, num_sample_geo=points, length=n)
    return ds.as_train_batch(range(n))


# -- Trainer ------------------------------------------------------------------
def test_trainer_ckpt_roundtrip_and_resume(tmp_path):
    cfg = _cfg(tmp_path, resume=True, optim="RMSprop", momentum=0.9)
    batch = _batch()
    tr = Trainer(_net(), cfg, use_mesh=False, device="cpu")
    tr.init_state()
    for _ in range(2):
        tr.state, _ = tr.step_fn(tr.state, {k: torch.from_numpy(v)
                                            for k, v in batch.items()})
    tr.update_ckpt("ckpt_test", epoch=3, iteration=7)
    path = os.path.join(tr.checkpoints_path, "ckpt_test")
    saved = torch.load(path, weights_only=True)
    assert saved["step"] == 2 and saved["opt"]["optim"] == "RMSprop"
    assert set(saved["opt_state"]) == {"0.nu", "2.trace"}

    tr2 = Trainer(_net(), cfg, use_mesh=False, device="cpu")
    tr2.init_state(torch.Generator().manual_seed(5))     # other weights
    tr2.load_ckpt(path)
    assert (tr2.epoch, tr2.iteration, tr2.state.step) == (3, 7, 2)
    for k, v in tr.net.state_dict().items():
        torch.testing.assert_close(tr2.net.state_dict()[k], v, rtol=0,
                                   atol=0)
    for slot, tensors in tr.state.opt_state.items():
        for a, b in zip(tensors, tr2.state.opt_state[slot]):
            torch.testing.assert_close(b, a, rtol=0, atol=0)
    # both continue identically
    for t in (tr, tr2):
        t.state, loss = t.step_fn(t.state, {k: torch.from_numpy(v)
                                            for k, v in batch.items()})
        t.loss = float(loss)
    assert tr.loss == tr2.loss

    cfg.resume = False                    # weights only
    tr3 = Trainer(_net(), cfg, use_mesh=False, device="cpu")
    tr3.init_state()
    tr3.load_ckpt(path)
    assert (tr3.epoch, tr3.iteration, tr3.state.step) == (0, 0, 0)
    assert all((t == 0).all() for t in tr3.state.opt_state["0.nu"])


def test_trainer_eval_hook_and_train_epoch(tmp_path):
    """``evaluate`` every ``freq_eval`` steps on running BatchNorm stats,
    then back to train mode; ``train_epoch`` on the synthetic blobs."""
    cfg = _cfg(tmp_path, freq_plot=2, freq_eval=2, freq_save=3)
    net = _net("batch_train")
    tr = Trainer(net, cfg, use_mesh=False, device="cpu")
    ds = SyntheticBlobDataset(size=64, num_sample_geo=128, length=6)
    eval_batch = _batch(2)
    batches = (ds.as_train_batch([i, i + 1]) for i in (0, 2, 4))
    mean = tr.train_epoch(batches, epoch=0, eval_batch=eval_batch)
    assert np.isfinite(mean) and tr.iteration == 3 and tr.epoch == 0
    assert os.path.exists(os.path.join(tr.checkpoints_path, "ckpt_3"))
    assert net.training
    bn = net.image_filter.bn1
    stats = bn.running_mean.clone()
    metrics = tr.evaluate(eval_batch)
    assert set(metrics) == {"iou", "accuracy", "mse"}
    assert 0.0 <= metrics["accuracy"] <= 1.0
    torch.testing.assert_close(bn.running_mean, stats, rtol=0, atol=0)
    assert net.training


def test_trainer_in_a_world_of_two_builds_jax_mesh(tmp_path, monkeypatch):
    """In a world of two ranks (torch's fake backend: real process groups,
    no-op collectives) the Trainer builds the JAX Trainer's mesh over two
    devices; rank 0 alone writes files. Where the batch takes no split
    and the points take one, the mesh is (1, 2)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from monoport_tpu.config import get_cfg_defaults as jax_defaults
    from monoport_tpu.training.trainer import Trainer as JaxTrainer

    devices = jax.devices()
    monkeypatch.setattr(jax, "devices", lambda: devices[:2])
    for bs in (1, 2):
        jcfg = jax_defaults()
        jcfg.checkpoints_path = str(tmp_path / "jax")
        jcfg.results_path = str(tmp_path / "jax")
        jcfg.batch_size = bs
        want = JaxTrainer(JaxNet(jcfg.netG), jcfg).mesh.shape
        for rank in (0, 1):
            dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                    world_size=2)
            try:
                cfg = _cfg(tmp_path / f"r{rank}", batch_size=bs)
                tr = Trainer(_net(), cfg, device="cpu")
                assert tr.mesh.shape == dict(want), (bs, rank)
                assert tr.mesh.coords == ((rank, 0) if bs == 2
                                          else (0, rank))
                assert tr.tb_writer is None or rank == 0
                assert os.path.isdir(tr.checkpoints_path) == (rank == 0)
                tr.init_state()
                tr.update_ckpt("c", 0, 0)
                assert os.path.exists(os.path.join(
                    tr.checkpoints_path, "c")) == (rank == 0)
            finally:
                dist.destroy_process_group()


# -- npz interop with the JAX package -----------------------------------------
def test_port_saved_npz_loads_in_the_jax_package(tmp_path):
    from monoport_tpu.utils.params_io import load_params as jax_load

    net = ts.init_params(_net(), torch.Generator().manual_seed(2))
    path = str(tmp_path / "g.npz")
    save_params(path, net, meta={"steps": 3})
    with np.load(path) as data:
        assert data["image_filter/conv1/kernel"].dtype == np.float16
        assert data["image_filter/conv1/kernel"].shape == (7, 7, 3, 64)
        assert data["surface_classifier/filters_1/kernel"].shape == (1057,
                                                                     512)
    params, meta = jax_load(path)
    assert meta == {"steps": 3}
    port = weights.build_net(CN(_opts()), load_params(path)[0], "cpu")
    b = _batch()
    want = JaxNet(JCN(_opts())).apply({"params": params}, b["images"],
                                      b["points"], b["calibs"])
    with torch.no_grad():
        got = port(torch.from_numpy(b["images"]),
                   torch.from_numpy(b["points"]),
                   torch.from_numpy(b["calibs"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_jax_trained_npz_loads_into_the_port(tmp_path):
    """A JAX net after one ``make_train_step`` step, saved by the JAX
    package's ``save_params``, loads into the port tensor for tensor."""
    from monoport_tpu.parallel import train_step as jts
    from monoport_tpu.utils.params_io import save_params as jax_save

    variables = weights.flax_params_from_torch(ts.init_params(
        _net(), torch.Generator().manual_seed(3)).state_dict())
    tx = jts.make_optimizer("adam", 1e-3)
    state = jts.TrainState(step=jnp.zeros((), jnp.int32),
                           params=variables["params"],
                           opt_state=tx.init(variables["params"]), tx=tx)
    state, _ = jts.make_train_step(JaxNet(JCN(_opts())))(state, _batch())
    path = str(tmp_path / "j.npz")
    jax_save(path, state.params, meta={"width": 32})
    params, meta = load_params(path)
    assert meta == {"width": 32}
    port = weights.build_net(CN(_opts()), params, "cpu")
    want = weights.torch_state_from_flax(jax.tree.map(
        lambda a: np.asarray(a).astype(np.float16).astype(np.float32),
        state.params))
    for k, v in port.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)
    assert not torch.equal(port.state_dict()["image_filter.conv1.weight"],
                           weights.torch_state_from_flax(variables)[
                               "image_filter.conv1.weight"])


# -- the apps on the CPU ------------------------------------------------------
def test_train_app_netg_and_resume(tmp_path):
    from monoport_tpu_torch.apps.train import main

    common = ["batch_size", "2", "optim", "adam", "resume", "True",
              "dataset.num_sample_geo", "128", "freq_plot", "1",
              "freq_save", "100000", "checkpoints_path", str(tmp_path / "c"),
              "results_path", str(tmp_path / "r")] + TINY
    loss, tr = main(["--dataset", "synthetic", "--epochs", "1",
                     "--image_size", "64", "--device", "cpu", "--"] + common)
    assert np.isfinite(loss) and tr.iteration == 4
    ckpt = str(tmp_path / "c" / "default" / "epoch_0")
    saved = torch.load(ckpt, weights_only=True)
    argv = ["--dataset", "synthetic", "--image_size", "64", "--device",
            "cpu", "--resume_from", ckpt]
    _, tr = main(argv + ["--epochs", "1", "--"] + common)
    assert (tr.epoch, tr.iteration, tr.state.step) == (1, 4, 4)
    for slot, tensors in saved["opt_state"].items():
        for name, t in tensors.items():
            i = [n for n, _ in tr.net.named_parameters()].index(name)
            torch.testing.assert_close(tr.state.opt_state[slot][i], t,
                                       rtol=0, atol=0)
    loss, tr = main(argv + ["--epochs", "2", "--"] + common)
    assert np.isfinite(loss) and tr.iteration == 8 and tr.state.step == 8


def test_train_app_netc_through_ppl(tmp_path):
    from monoport_tpu_torch.apps.train import main
    from monoport_tpu_torch.training.datasets.fixture import \
        make_dynamic_fixture

    root = str(tmp_path / "ppl")
    make_dynamic_fixture(root, subjects=("c0",), rich=True, textured=True,
                         broken=False, seed=11)
    loss, tr = main(["--dataset", "ppl_dynamic", "--net", "netC", "--netg",
                     "", "--epochs", "1", "--device", "cpu", "--",
                     "dataset.root_render", root,
                     "dataset.rotation_step", "120",
                     "dataset.num_sample_geo", "64",
                     "dataset.num_sample_color", "64",
                     "dataset.blur", "0.0", "dataset.input_size", "64",
                     "batch_size", "2", "num_threads", "0",
                     "freq_plot", "1", "freq_save", "100000",
                     "optim", "adam", "grad_clip", "1.0",
                     "checkpoints_path", str(tmp_path / "c"),
                     "results_path", str(tmp_path / "r")] + TINY)
    assert np.isfinite(loss) and tr.iteration == 1
    # netC's head takes netG's 32 prior channels + 256 + z
    assert tr.net.surface_classifier.filter_channels[0] == 289
    saved = torch.load(str(tmp_path / "c" / "default" / "epoch_0"),
                       weights_only=True)
    tr.net.load_state_dict(saved["params"], strict=True)
    assert saved["opt"]["grad_clip"] == 1.0 and saved["iteration"] == 1


@pytest.mark.parametrize("net", ["G", "C"])
def test_capsule_apps_on_the_cpu(net, tmp_path):
    from monoport_tpu_torch.apps import train_capsule_netC, train_capsule_netG

    out = str(tmp_path / f"net{net}.npz")
    argv = ["--device", "cpu", "--size", "64", "--steps", "2", "--chunk",
            "1", "--points", "256", "--out", out]
    if net == "G":
        res = train_capsule_netG.main(argv)
        assert 0.0 <= res["iou"] <= 1.0
    else:
        res = train_capsule_netC.main(argv + ["--mixed", "1"])
        assert np.isfinite(res["l1"]) and np.isfinite(res["psnr"])
    assert len(res["chunk_losses"]) == 2
    assert all(np.isfinite(res["chunk_losses"]))
    cfg = get_cfg_defaults()
    loaded = weights.build_net(cfg[f"net{net}"], load_params(out)[0], "cpu")
    assert loaded.surface_classifier.filter_channels[0] == (
        257 if net == "G" else 513)

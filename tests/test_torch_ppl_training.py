"""PyTorch port, training through the file-backed PPL path on the CPU: the
JAX package's two convergence gates (``tests/test_ppl_dataset.py``:
``test_ppl_training_improves_eval_iou`` and
``test_netc_trains_through_ppl_path``) ported as they stand (the same
fixture trees, tiny nets, input size 128, overrides, epochs and
thresholds, on ``--device cpu``), and a tiny run of
``apps/train_ppl --recipe r5`` (1 + 2 epochs, phase C resumed after its
first) in a process of its own, as a user runs it (a Tier-1 worker holds
JAX's threads, and one Tier-1 run hung in this test when it ran in the
worker): the JSON lines, the exact resume, no kernel launch in a train
step, the trained nets' frame."""

import json
import os
import random
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from monoport_tpu_torch.apps import train, train_ppl
from monoport_tpu_torch.config import get_cfg_defaults
from monoport_tpu_torch.models.backbones import BACKBONES, ResnetFilter
from monoport_tpu_torch.models.heads import (HEAD_SPECS, HEADS,
                                             SurfaceClassifier)
from monoport_tpu_torch.training.datasets import PPLDynamicDataset
from monoport_tpu_torch.training.datasets.fixture import make_dynamic_fixture

torch.set_num_threads(2)
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
TINY_G = ["netG.backbone.num_stack", "1", "netG.backbone.num_hourglass", "1",
          "netG.backbone.hourglass_dim", "64"]


def _ds_cfg(**over):
    cfg = get_cfg_defaults().dataset
    cfg.rotation_step = 120
    cfg.num_sample_geo = 64
    cfg.blur = 0.0
    for k, v in over.items():
        cfg[k] = v
    return cfg


def test_ppl_training_improves_eval_iou(tmp_path):
    """Training on the rich PPL fixture improves the held-out point IOU
    over the Trainer's init by more than 0.1 and ends above 0.52 (the JAX
    gate: a 1-stack hourglass at input size 128, 12 epochs; the eval is
    the same subjects at held-out rotations 60 / 180 / 300)."""
    train_root = str(tmp_path / "train")
    val_root = str(tmp_path / "val")
    make_dynamic_fixture(train_root, subjects=("r0", "r1"),
                         rotations=(0, 120, 240), rich=True,
                         textured=True, broken=False, seed=5)
    make_dynamic_fixture(val_root, subjects=("r0", "r1"),
                         rotations=(60, 180, 300), rich=True,
                         textured=True, broken=False, seed=5)
    overrides = ["dataset.rotation_step", "120",
                 "dataset.num_sample_geo", "256",
                 "dataset.blur", "0.0",
                 "dataset.input_size", "128",
                 "dataset.aug_bri", "0.0", "dataset.aug_con", "0.0",
                 "dataset.aug_sat", "0.0", "dataset.aug_hue", "0.0",
                 "batch_size", "2",
                 "num_threads", "0",
                 "freq_plot", "100",
                 "freq_save", "100000",
                 "optim", "adam",
                 "learning_rate", "1e-3",
                 "checkpoints_path", str(tmp_path / "ckpt"),
                 "results_path", str(tmp_path / "results"),
                 "name", "gate"] + TINY_G

    ds_val = PPLDynamicDataset(
        _ds_cfg(num_sample_geo=256, rotation_step=60, input_size=128),
        val_root, training=False)
    ds_val.rotations = (60, 180, 300)
    random.seed(0)
    np.random.seed(0)
    items = [ds_val.get_item(i) for i in range(6)]
    stack = lambda k: torch.from_numpy(np.stack([it[k] for it in items]))
    batch = {"images": stack("image"), "calibs": stack("calib"),
             "points": stack("samples_geo"), "labels": stack("labels_geo")}

    _, cfg = train.parse_args(["--dataset", "ppl_dynamic", "--",
                               "dataset.root_render", train_root]
                              + overrides)
    iou_init = train_ppl.point_iou(train_ppl.init_net(cfg, "netG", "cpu"),
                                   batch)
    train.main(["--dataset", "ppl_dynamic", "--epochs", "12", "--device",
                "cpu", "--", "dataset.root_render", train_root] + overrides)
    trained = train_ppl.net_from(
        cfg, "netG", str(tmp_path / "ckpt" / "gate" / "epoch_11"), "cpu")
    iou_after = train_ppl.point_iou(trained, batch)
    assert iou_after > iou_init + 0.1, (iou_init, iou_after)
    assert iou_after > 0.52, iou_after


def test_netc_trains_through_ppl_path(tmp_path, monkeypatch):
    """netC through fixture colour files -> ``get_sampling_color`` ->
    DataLoader -> ``apps/train --net netC`` (the feature prior of a frozen
    netG from seed 0) -> Trainer: after 6 epochs the trained parameters'
    colour L1 on a fixed batch beats the init's by 0.05 (the JAX gate: a
    128-channel ResNet filter, a 193-64-3 head)."""
    monkeypatch.setitem(BACKBONES, "tiny_resblk",
                        lambda opt=None: ResnetFilter(ngf=32, n_blocks=2))
    monkeypatch.setitem(HEADS, "tiny_chead",
                        lambda opt=None, filter_channels=None:
                        SurfaceClassifier(filter_channels or (193, 64, 3),
                                          last_op="tanh"))
    monkeypatch.setitem(HEAD_SPECS, "tiny_chead", ((193, 64, 3), "tanh"))

    root = str(tmp_path / "ppl_color")
    make_dynamic_fixture(root, subjects=("c0", "c1"),
                         rotations=(0, 120, 240), rich=True,
                         textured=True, broken=False, seed=11)
    overrides = ["dataset.rotation_step", "120",
                 "dataset.num_sample_geo", "64",
                 "dataset.num_sample_color", "128",
                 "dataset.sigma_color", "0.001",
                 "dataset.blur", "0.0",
                 "dataset.input_size", "128",
                 "dataset.aug_bri", "0.0", "dataset.aug_con", "0.0",
                 "dataset.aug_sat", "0.0", "dataset.aug_hue", "0.0",
                 "batch_size", "2",
                 "num_threads", "0",
                 "freq_plot", "1", "freq_save", "100000",
                 "optim", "adam", "learning_rate", "1e-3",
                 "grad_clip", "1.0",
                 "checkpoints_path", str(tmp_path / "ckpt"),
                 "results_path", str(tmp_path / "results"),
                 "name", "netc_gate",
                 "netC.backbone.IMF", "tiny_resblk",
                 "netC.head.IMF", "tiny_chead"] + TINY_G
    argv = ["--dataset", "ppl_dynamic", "--net", "netC", "--netg", "",
            "--device", "cpu", "--", "dataset.root_render", root] + overrides
    args, cfg = train.parse_args(argv)
    prior_fn = train.make_prior_fn(cfg, "", "cpu")
    random.seed(0)
    np.random.seed(0)
    loader = train.build_loader(args, cfg)
    batch = {k: torch.as_tensor(v).float() for k, v in train.to_train_batch(
        next(iter(loader.epoch(0))), "netC").items()}
    batch["feat_prior"] = prior_fn(batch["images"])
    assert batch["points"].shape == (2, 128, 3)
    assert batch["labels"].shape == (2, 128, 3)

    def l1(net):
        with torch.no_grad():
            pred = net.eval()(batch["images"], batch["points"],
                              batch["calibs"],
                              feat_prior=batch["feat_prior"])
        return float((pred - batch["labels"]).abs().mean())

    l_init = l1(train_ppl.init_net(cfg, "netC", "cpu"))
    loss, _ = train.main(["--epochs", "6"] + argv)
    assert np.isfinite(loss)
    trained = train_ppl.net_from(
        cfg, "netC", str(tmp_path / "ckpt" / "netc_gate" / "epoch_5"), "cpu")
    l_trained = l1(trained)
    assert l_trained < l_init - 0.05, (l_init, l_trained)


def _run_app(argv: list, timeout: float = 300) -> list:
    """``python -m monoport_tpu_torch.apps.train_ppl argv`` in a process of
    its own session (a clean interpreter: no JAX threads for the loader's
    forked workers to inherit), killed with its workers after ``timeout``
    seconds. -> the JSON lines it printed."""
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "monoport_tpu_torch.apps.train_ppl", *argv],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        _, err = proc.communicate()
        pytest.fail(f"train_ppl did not end in {timeout} s: {err[-2000:]}")
    assert proc.returncode == 0, err[-3000:]
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def test_train_ppl_r5_tiny_run_with_resume(tmp_path):
    """``train_ppl --recipe r5`` cut to 2 subjects x 3 rotations at 64^2,
    phase G 1 epoch (2 loader workers), phase C 2 epochs resumed after the
    first, run as a user runs it: the JSON lines, finite numbers, the
    exact resume, no kernel launch in training, and the trained nets'
    frame."""
    lines = _run_app([
        "--recipe", "r5", "--device", "cpu", "--subjects", "2",
        "--rotation_step", "120", "--epochs_g", "1", "--epochs_c", "2",
        "--epochs_c_resume_at", "1", "--keep", str(tmp_path / "run"), "--",
        "dataset.input_size", "64", "dataset.num_sample_geo", "64",
        "dataset.num_sample_color", "64", "netG.backbone.num_stack", "1",
        "netG.backbone.num_hourglass", "1", "netG.backbone.hourglass_dim",
        "32"])
    assert len(lines) == 2
    out = lines[-1]
    assert (out["subjects"], out["rotations"]) == (2, 3)
    assert len(out["netg_epoch_losses"]) == 1
    assert len(out["netc_epoch_losses"]) == 2
    for key in ("netg_iou_init", "netg_iou_heldout"):
        assert 0.0 <= out[key] <= 1.0
    for key in ("netc_psnr_init", "netc_psnr_mid", "netc_psnr_final"):
        assert np.isfinite(out[key])
    assert all(np.isfinite(out["netg_epoch_losses"]
                           + out["netc_epoch_losses"]))
    assert out["resume"]["exact"], out["resume"]
    assert out["resume"]["restored"] == out["resume"]["saved"]
    assert not any(out["training_kernel_launches"].values())
    assert out["frame"]["finite"] and out["frame"]["profile"] == \
        "reduced_129_f32"
    # the checkpoints and the npz stay where --keep puts them
    run = tmp_path / "run"
    assert os.path.exists(run / "netg_ppl_r5.npz")
    assert os.path.exists(run / "ckpt" / "netc_r5" / "epoch_1")


def test_train_ppl_r4_tiny_run_with_resume(tmp_path):
    """``train_ppl --recipe r4`` cut to 2 subjects x 3 rotations at 64^2,
    1 epoch, then resumed to 2: the held-out IOU after every epoch (its
    phase-A and final readings among them), the exact resume, no kernel
    launch in training, and the trained netG's frame."""
    lines = _run_app([
        "--recipe", "r4", "--device", "cpu", "--subjects", "2",
        "--rotation_step", "120", "--epochs_a", "1", "--epochs_total", "2",
        "--", "dataset.input_size", "64", "dataset.num_sample_geo", "64",
        "netG.backbone.num_stack", "1", "netG.backbone.num_hourglass", "1",
        "netG.backbone.hourglass_dim", "32"])
    out = lines[-1]
    assert (out["subjects"], out["rotations"]) == (2, 3)
    assert len(out["iou_by_epoch"]) == 2
    assert out["iou_by_epoch"] == [out["iou_after_a"], out["iou_after_b"]]
    assert all(0.0 <= v <= 1.0 for v in [out["iou_init"],
                                         *out["iou_by_epoch"]])
    assert out["steps_per_epoch"] == 1    # 6 items, batches of 4: one full
    assert len(out["epoch_losses"]) == 2
    assert all(np.isfinite(out["epoch_losses"]))
    assert out["resume"]["exact"], out["resume"]
    assert not any(out["training_kernel_launches"].values())
    assert out["frame"]["finite"]
    assert out["base"] == "(removed)"


def test_train_ppl_recipes_keep_the_scripts_settings():
    """The config lists of ``scripts/train_ppl_r4.py`` / ``_r5.py``."""
    args = train_ppl.parse_args(["--recipe", "r4"])
    assert (args.subjects, args.rotation_step) == (6, 60)
    assert (args.epochs_a, args.epochs_total) == (4, 10)
    args = train_ppl.parse_args([])
    assert args.recipe == "r5" and (args.subjects, args.rotation_step) == \
        (8, 45)
    assert (args.epochs_g, args.epochs_c, args.epochs_c_resume_at) == \
        (40, 12, 6)
    g, c = dict(zip(train_ppl.CFG_G[::2], train_ppl.CFG_G[1::2])), \
        dict(zip(train_ppl.CFG_C[::2], train_ppl.CFG_C[1::2]))
    assert g["dataset.rotation_step"] == "45" and g["num_threads"] == "2"
    assert g["learning_rate"] == "3e-4" and g["batch_size"] == "4"
    assert c["learning_rate"] == "1e-3" and c["grad_clip"] == "1.0"
    assert c["num_threads"] == "0" and c["dataset.num_sample_color"] == "512"
    assert train_ppl.overrides(args, train_ppl.CFG_G)[1] == "45"

"""The PPL training recipes through the file-backed path (port of the JAX
package's ``scripts/train_ppl_r4.py`` and ``scripts/train_ppl_r5.py``).

The reference's whole training story: a rich multi-subject, multi-rotation,
textured ``PPLDynamicDataset`` fixture tree -> ``DataLoader`` workers ->
``Trainer`` -> the train step (``apps/train.py``), with a mid-run resume
from a checkpoint, and the held-out subject's point metrics from the nets'
point query.

* ``--recipe r4``: netG on 6 subjects x 6 rotations, ``--epochs_a`` 4,
  then a resume to ``--epochs_total`` 10; the held-out IOU@0.5 at init,
  after phase A and at the end (and after every epoch), and the
  epoch-loss ladder.
* ``--recipe r5``: phase G, netG on 8 subjects x 8 rotations for
  ``--epochs_g`` 40 with 2 loader workers; phase C, netC on the frozen
  phase-G netG's feature prior (``--netg``) for ``--epochs_c`` 12 at lr
  1e-3 with the global-norm clip 1.0 and in-process loading, resumed at
  ``--epochs_c_resume_at`` 6; the held-out IOU and the netC PSNR at init,
  mid-run and final.

Checkpoints are the Trainer's (``torch.save``); the trained netG is saved
as the JAX package's npz (``utils/params_io``). Each run also checks that
the resume restored the optimizer tensors, step and epoch exactly, that no
kernel of ours ran in a train step, and ends with one frontal frame of the
trained nets through ``ReconEngine`` (the card: the bench profile in bf16,
4 ray-MLP launches; the CPU: the reduced 129 profile, f32).

Run (the card unless ``--device`` says otherwise; config overrides after a
literal ``--`` go to both phases and the evaluation):
    python -m monoport_tpu_torch.apps.train_ppl --recipe r5
    python -m monoport_tpu_torch.apps.train_ppl --recipe r4 --epochs_a 4 \\
        --epochs_total 10
Prints one JSON line as each phase ends; the last holds every number.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import re
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from .. import evaluate
from ..config import get_cfg_defaults
from ..ops.cuda import fused_gather_mlp, fused_mlp, fused_ray_mlp
from ..parallel.train_step import init_params
from ..training.datasets import PPLDynamicDataset
from ..training.datasets.fixture import make_dynamic_fixture
from ..utils.params_io import save_params
from ..weights import build_net, load_params, resolve_device
from . import train

# scripts/train_ppl_r4.py:36-49
CFG_R4 = [
    "dataset.rotation_step", "60",
    "dataset.num_sample_geo", "512",
    "dataset.blur", "0.0",
    "batch_size", "4",
    "num_threads", "2",
    "freq_plot", "1",
    "freq_save", "100000",
    "optim", "adam",
    "learning_rate", "3e-4",
    "schedule", "[1000]",
]
# scripts/train_ppl_r5.py:38-68: phase G as r4 at 45 degrees; phase C adds
# the colour samples, lr 1e-3 with the clip, and in-process loading (the
# JAX run's forked worker hung in phase C)
CFG_G = [o if o != "60" else "45" for o in CFG_R4]
CFG_C = CFG_G + [
    "dataset.num_sample_color", "512",
    "dataset.sigma_color", "0.002",
    "learning_rate", "1e-3",
    "grad_clip", "1.0",
    "num_threads", "0",
]
RECIPES = {"r4": {"subjects": 6, "rotation_step": 60},
           "r5": {"subjects": 8, "rotation_step": 45}}
# the kernels a train step must not launch (the plain head under autograd)
KERNELS = {"fused_ray_mlp": fused_ray_mlp.apply_ray,
           "fused_anchor_mlp": fused_ray_mlp.apply_anchor,
           "fused_mlp": fused_mlp.apply_mlp,
           "fused_gather_mlp": fused_gather_mlp.apply_gather_ray}


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--recipe", choices=sorted(RECIPES), default="r5")
    p.add_argument("--epochs_a", type=int, default=4, help="r4: phase A")
    p.add_argument("--epochs_total", type=int, default=10, help="r4")
    p.add_argument("--epochs_g", type=int, default=40, help="r5: phase G")
    p.add_argument("--epochs_c", type=int, default=12, help="r5: phase C")
    p.add_argument("--epochs_c_resume_at", type=int, default=6, help="r5")
    p.add_argument("--subjects", type=int, default=0,
                   help="training subjects (default: the recipe's)")
    p.add_argument("--rotation_step", type=int, default=0,
                   help="degrees between the renders (default: the "
                   "recipe's)")
    p.add_argument("--skip_g", default="",
                   help="r5: reuse a netG npz (skip phase G)")
    p.add_argument("--keep", default="",
                   help="build the trees and checkpoints here and keep them")
    p.add_argument("--device", default=None,
                   help="torch device; default cuda (no CPU fallback)")
    argv = list(sys.argv[1:] if argv is None else argv)
    extra = []
    if "--" in argv:
        split = argv.index("--")
        argv, extra = argv[:split], argv[split + 1:]
    args = p.parse_args(argv)
    recipe = RECIPES[args.recipe]
    args.subjects = args.subjects or recipe["subjects"]
    args.rotation_step = args.rotation_step or recipe["rotation_step"]
    args.extra = extra
    return args


def overrides(args, base: list) -> list:
    """A recipe's config list at this run's rotation step, then the
    caller's own overrides."""
    out = list(base)
    out[out.index("dataset.rotation_step") + 1] = str(args.rotation_step)
    return out + args.extra


def build_trees(base: str, n_subjects: int, step: int):
    """The rich, textured training tree (subjects s0.., seed 100) and the
    held-out subject's (val_a, seed 777), at every ``step`` degrees."""
    train_root = os.path.join(base, "train")
    val_root = os.path.join(base, "val")
    rotations = tuple(range(0, 360, step))
    make_dynamic_fixture(train_root,
                         subjects=tuple(f"s{i}" for i in range(n_subjects)),
                         rotations=rotations, rich=True, textured=True,
                         broken=False, seed=100)
    make_dynamic_fixture(val_root, subjects=("val_a",), rotations=rotations,
                         rich=True, textured=True, broken=False, seed=777)
    return train_root, val_root


def val_batch(val_root: str, opts: list, device, color: bool = False):
    """The held-out subject's items at every rotation (no augmentation, the
    samples drawn after seeding ``random`` and numpy with 0) as one batch
    on ``device``: image, calib, points and labels (``samples_geo`` /
    ``labels_geo``, or the colour ones)."""
    cfg = get_cfg_defaults()
    cfg.merge_from_list(opts)
    ds = PPLDynamicDataset(cfg.dataset, val_root, training=False)
    random.seed(0)
    np.random.seed(0)
    items = [ds.get_item(i) for i in range(len(ds))]
    key = "color" if color else "geo"
    to = lambda k: torch.from_numpy(np.stack([it[k] for it in items])).to(
        device=device, dtype=torch.float32)
    return {"images": to("image"), "calibs": to("calib"),
            "points": to(f"samples_{key}"), "labels": to(f"labels_{key}")}


def point_iou(net, batch: dict) -> float:
    """Held-out IOU@0.5 of a netG's point query over the batch."""
    with torch.no_grad():
        pred = net.eval()(batch["images"], batch["points"],
                          batch["calibs"])[..., 0] > 0.5
    labels = batch["labels"] > 0.5
    return float((pred & labels).sum() / max(int((pred | labels).sum()), 1))


def point_psnr(net, batch: dict, prior: torch.Tensor) -> float:
    """Held-out colour PSNR of a netC's point query on the [0, 1] scale
    (-10 log10 MSE), netG's feature prior given."""
    with torch.no_grad():
        pred = net.eval()(batch["images"], batch["points"], batch["calibs"],
                          feat_prior=prior)
    # (pred + 1) / 2 against (labels + 1) / 2
    mse = float(((pred - batch["labels"]) ** 2).mean()) / 4.0
    return -10.0 * float(np.log10(max(mse, 1e-12)))


def net_from(cfg, name: str, ckpt: str, device):
    """``cfg[name]``'s net (its head sized as the Trainer's) with a Trainer
    checkpoint's parameters."""
    net = train.build_train_net(cfg, name)
    state = torch.load(ckpt, map_location="cpu", weights_only=True)
    net.load_state_dict(state["params"], strict=True)
    return net.to(device)


def init_net(cfg, name: str, device):
    """The Trainer's initial ``cfg[name]`` net (``init_params`` from a CPU
    generator seeded 0)."""
    net = init_params(train.build_train_net(cfg, name),
                      torch.Generator().manual_seed(0))
    return net.to(device)


def epoch_losses(results_dir: str) -> list:
    out = {}
    with open(os.path.join(results_dir, "train_logs.txt")) as f:
        for line in f:
            m = re.search(r"epoch (\d+) done, mean loss ([0-9.naninf]+)",
                          line)
            if m:
                out[int(m.group(1))] = float(m.group(2))
    return [round(out[k], 4) for k in sorted(out)]


def kernel_launches() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def train_and_resume(common: list, device, ckpt_dir: str, name: str,
                     resume_at: int, epochs: int) -> dict:
    """``apps.train`` for ``resume_at`` epochs, then from that checkpoint
    with ``resume True``: first with nothing left to run, to compare the
    restored optimizer tensors, step, epoch and iteration with the saved
    ones, then on to ``epochs``. -> the resume's readings."""
    dev = ["--device", str(device)]
    train.main(["--epochs", str(resume_at)] + dev + common)
    ckpt = os.path.join(ckpt_dir, name, f"epoch_{resume_at - 1}")
    saved = torch.load(ckpt, map_location=device, weights_only=True)
    argv = ["--resume_from", ckpt] + dev + common + ["resume", "True"]
    _, tr = train.main(["--epochs", str(resume_at)] + argv)
    names = [n for n, _ in tr.net.named_parameters()]
    differ = [f"{slot}/{n}" for slot, tensors in tr.state.opt_state.items()
              for n, t in zip(names, tensors)
              if not torch.equal(t, saved["opt_state"][slot][n])]
    differ += [k for k, v in tr.net.state_dict().items()
               if not torch.equal(v, saved["params"][k])]
    restored = [tr.state.step, tr.epoch, tr.iteration]
    want = [saved["step"], saved["epoch"], saved["iteration"]]
    train.main(["--epochs", str(epochs)] + argv)
    return {"at_epoch": resume_at, "restored": restored, "saved": want,
            "tensors_differing": len(differ), "exact": not differ
            and restored == want}


def frame_of(netG, netC, image: torch.Tensor, device) -> dict:
    """One frontal frame of the trained nets on a held-out image: the bench
    profile in bf16 on the card (4 ray-MLP launches with netC, 3 without),
    the reduced 129 profile in f32 elsewhere. -> launches, the frame's
    valid share and whether it is finite."""
    if device.type == "cuda":
        eng = evaluate.bench_engine(netG, netC, torch.bfloat16, device)
        profile = "bench_bf16"
    else:
        eng = evaluate.reduced_engine(netG, netC, torch.float32, device)
        profile = "reduced_129_f32"
    img = image[None]
    img_c = img if netC is not None else None
    eng.frame(img, img_c)                        # warm-up
    before = kernel_launches()
    out = eng.frame(img, img_c)
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = {k: v - before[k] for k, v in kernel_launches().items()}
    finite = all(bool(torch.isfinite(v).all()) for v in (
        out["depth"][out["valid"]], out["render_norm"],
        *([out["render_tex"]] if "render_tex" in out else [])))
    return {"profile": profile, "launches": launches,
            "valid_share": float(out["valid"].float().mean()),
            "finite": finite}


def run_r4(args, base: str, device, out: dict) -> dict:
    train_root, val_root = build_trees(base, args.subjects,
                                       args.rotation_step)
    opts = overrides(args, CFG_R4)
    cfg = get_cfg_defaults()
    cfg.merge_from_list(opts)
    batch = val_batch(val_root, opts, device)
    out["iou_init"] = round(point_iou(init_net(cfg, "netG", device), batch),
                            4)
    emit(out)
    ckpt_dir = os.path.join(base, "ckpt")
    res_dir = os.path.join(base, "results")
    common = ["--dataset", "ppl_dynamic", "--",
              "dataset.root_render", train_root,
              "checkpoints_path", ckpt_dir, "results_path", res_dir,
              "name", "ppl_r4"] + opts
    before = kernel_launches()
    out["resume"] = train_and_resume(common, device, ckpt_dir, "ppl_r4",
                                     args.epochs_a, args.epochs_total)
    out["training_kernel_launches"] = {
        k: v - before[k] for k, v in kernel_launches().items()}
    ck = lambda e: os.path.join(ckpt_dir, "ppl_r4", f"epoch_{e - 1}")
    # the held-out IOU after every epoch: where it leaves the IOU@0.5
    # plateau of a netG that answers "outside" everywhere
    ladder = [round(point_iou(net_from(cfg, "netG", ck(e), device), batch),
                    4) for e in range(1, args.epochs_total + 1)]
    out["iou_after_a"] = ladder[args.epochs_a - 1]
    out["iou_after_b"] = ladder[-1]
    out["iou_by_epoch"] = ladder
    out["steps_per_epoch"] = out["resume"]["saved"][2] // args.epochs_a
    netG = net_from(cfg, "netG", ck(args.epochs_total), device)
    out["epoch_losses"] = epoch_losses(os.path.join(res_dir, "ppl_r4"))
    out["frame"] = frame_of(netG.eval(), None, batch["images"][0], device)
    return out


def run_r5(args, base: str, device, out: dict) -> dict:
    train_root, val_root = build_trees(base, args.subjects,
                                       args.rotation_step)
    opts_g, opts_c = overrides(args, CFG_G), overrides(args, CFG_C)
    cfg_g, cfg_c = get_cfg_defaults(), get_cfg_defaults()
    cfg_g.merge_from_list(opts_g)
    cfg_c.merge_from_list(opts_c)
    ckpt_dir = os.path.join(base, "ckpt")
    res_dir = os.path.join(base, "results")
    batch = val_batch(val_root, opts_g, device)
    before = kernel_launches()

    # phase G: netG through the forked loader workers
    netg_npz = args.skip_g or os.path.join(base, "netg_ppl_r5.npz")
    if not args.skip_g:
        out["netg_iou_init"] = round(point_iou(
            init_net(cfg_g, "netG", device), batch), 4)
        train.main(["--epochs", str(args.epochs_g), "--device", str(device),
                    "--dataset", "ppl_dynamic", "--",
                    "dataset.root_render", train_root,
                    "checkpoints_path", ckpt_dir, "results_path", res_dir,
                    "name", "netg_r5"] + opts_g)
        netG = net_from(cfg_g, "netG", os.path.join(
            ckpt_dir, "netg_r5", f"epoch_{args.epochs_g - 1}"), device)
        save_params(netg_npz, netG)
        out["netg_epoch_losses"] = epoch_losses(
            os.path.join(res_dir, "netg_r5"))
    # the npz round trip (f16 on disk) is the netG every later step reads
    netG = build_net(cfg_g.netG, load_params(netg_npz)[0], device)
    out["netg_iou_heldout"] = round(point_iou(netG, batch), 4)
    emit(out)

    # phase C: netC on the frozen netG's feature prior, with a resume
    batch_c = val_batch(val_root, opts_c, device, color=True)
    with torch.no_grad():
        prior = netG.filter(batch_c["images"])[-1][-1]
    common = ["--dataset", "ppl_dynamic", "--net", "netC", "--netg",
              netg_npz, "--", "dataset.root_render", train_root,
              "checkpoints_path", ckpt_dir, "results_path", res_dir,
              "name", "netc_r5"] + opts_c
    out["netc_psnr_init"] = round(point_psnr(
        init_net(cfg_c, "netC", device), batch_c, prior), 2)
    out["resume"] = train_and_resume(common, device, ckpt_dir, "netc_r5",
                                     args.epochs_c_resume_at, args.epochs_c)
    out["training_kernel_launches"] = {
        k: v - before[k] for k, v in kernel_launches().items()}
    ck = lambda e: os.path.join(ckpt_dir, "netc_r5", f"epoch_{e - 1}")
    out["netc_psnr_mid"] = round(point_psnr(net_from(
        cfg_c, "netC", ck(args.epochs_c_resume_at), device), batch_c,
        prior), 2)
    netC = net_from(cfg_c, "netC", ck(args.epochs_c), device)
    out["netc_psnr_final"] = round(point_psnr(netC, batch_c, prior), 2)
    out["netc_epoch_losses"] = epoch_losses(os.path.join(res_dir, "netc_r5"))
    out["frame"] = frame_of(netG, netC.eval(), batch["images"][0],
                               device)
    return out


def emit(out: dict) -> None:
    print(json.dumps(out), flush=True)


def main(argv=None) -> dict:
    """-> the last printed line's numbers."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    base = args.keep or tempfile.mkdtemp(prefix=f"ppl_{args.recipe}_")
    out = {"recipe": args.recipe, "subjects": args.subjects,
           "rotations": len(range(0, 360, args.rotation_step)),
           "device": str(device), "base": base}
    t0 = time.perf_counter()
    try:
        run = run_r4 if args.recipe == "r4" else run_r5
        out = run(args, base, device, out)
    finally:
        if not args.keep:
            shutil.rmtree(base, ignore_errors=True)
            out["base"] = "(removed)"
    out["seconds"] = time.perf_counter() - t0
    if device.type == "cuda":
        out["card"] = torch.cuda.get_device_name(device)
    emit(out)
    return out


if __name__ == "__main__":
    main()

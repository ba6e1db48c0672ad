"""Training entry point (port of ``monoport_tpu/apps/train.py``).

Run:
    python -m monoport_tpu_torch.apps.train --dataset synthetic --epochs 2 \\
        -- batch_size 4 optim adam learning_rate 1e-3
    python -m monoport_tpu_torch.apps.train --dataset ppl_dynamic \\
        -- dataset.root_render /data/pifu_orth
    ... --resume_from <checkpoints_path>/<name>/epoch_0 -- resume True

Arguments before a literal ``--`` go to argparse, config overrides after
it. The nets run on ``cuda`` unless ``--device`` names another device.
Items are made in numpy (forked loader workers for the file-backed
datasets); batches go to the device in this process.

Over several cards, one process a card (data parallel, the Trainer's
mesh; every rank draws the same global batch and trains on its piece):
    torchrun --nproc-per-node=N -m monoport_tpu_torch.apps.train ...
With ``WORLD_SIZE`` > 1 the process group is initialized from torchrun's
environment: NCCL on the cards, gloo with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from ..config import get_cfg_defaults
from ..models.monoport_net import (MonoPortNet, backbone_channels,
                                   head_channels_for)
from ..parallel.mesh import rank_device
from ..parallel.train_step import init_params, timed_convolutions
from ..training import Trainer
from ..training.datasets import (PPLDynamicDataset, PPLStaticDataset,
                                 SyntheticBlobDataset, make_batches)
from ..training.trainer import to_device
from ..utils import compile_cache
from ..weights import DATA, build_net, load_params, resolve_device


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", default="synthetic",
                        choices=["synthetic", "ppl_dynamic", "ppl_static"])
    parser.add_argument("--net", default="netG", choices=["netG", "netC"])
    parser.add_argument("--netg", default=os.path.join(
                            DATA, "netg_capsule.npz"),
                        help="frozen geometry net weights (.npz) supplying "
                        "netC's feat_prior (netC conditions on netG's "
                        "features). An empty string or a missing file "
                        "falls back to a netG initialised from seed 0.")
    parser.add_argument("--epochs", type=int, default=0,
                        help="override cfg.num_epoch")
    parser.add_argument("--resume_from", default="",
                        help="checkpoint file to resume from; set `-- "
                        "resume True` to also restore the optimizer state, "
                        "step, epoch and iteration")
    parser.add_argument("--steps_per_epoch", type=int, default=0,
                        help="steps an epoch of the schedule's milestones "
                        "(default 1000)")
    parser.add_argument("--image_size", type=int, default=512)
    parser.add_argument("--device", default=None,
                        help="torch device; default cuda (no CPU fallback)")
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" in argv:
        split = argv.index("--")
        argv, opts = argv[:split], argv[split + 1:]
    else:
        opts = []
    args = parser.parse_args(argv)
    cfg = get_cfg_defaults()
    cfg.merge_from_list(opts)
    cfg.freeze()
    return args, cfg


def build_dataset(args, cfg):
    if args.dataset == "synthetic":
        return SyntheticBlobDataset(
            size=args.image_size,
            num_sample_geo=cfg.dataset.num_sample_geo,
            length=max(8, cfg.batch_size * 4))
    if args.dataset == "ppl_dynamic":
        return PPLDynamicDataset(cfg.dataset, cfg.dataset.root_render)
    return PPLStaticDataset(cfg.dataset, cfg.dataset.root_render)


def build_loader(args, cfg):
    """Multiprocess loader for the file-backed datasets (cfg.num_threads
    workers); None for the in-memory synthetic one."""
    from ..training.datasets import DataLoader

    if args.dataset == "synthetic":
        return None
    factory = PPLDynamicDataset if args.dataset == "ppl_dynamic" \
        else PPLStaticDataset
    return DataLoader(factory, (cfg.dataset, cfg.dataset.root_render),
                      batch_size=cfg.batch_size,
                      num_workers=cfg.num_threads)


def to_train_batch(batch: dict, net: str = "netG") -> dict:
    """netG: occupancy supervision (samples_geo). netC: surface-colour
    supervision (samples_color); the caller adds 'feat_prior' from the
    frozen geometry net (``make_prior_fn``)."""
    if net == "netC":
        return {"images": batch["image"],
                "points": batch["samples_color"],
                "calibs": batch["calib"], "labels": batch["labels_color"]}
    labels = batch["labels_geo"]
    if labels.ndim == 2:
        labels = labels[..., None]
    return {"images": batch["image"], "points": batch["samples_geo"],
            "calibs": batch["calib"], "labels": labels}


def build_train_net(cfg, net: str = "netG") -> MonoPortNet:
    """The net of ``cfg[net]`` with its head sized for the configured
    backbone (netC's input also takes netG's features as its prior)."""
    prior = backbone_channels(cfg.netG.backbone) if net == "netC" else 0
    return MonoPortNet(cfg[net], head_channels_for(cfg[net], prior))


def make_prior_fn(cfg, netg_path: str, device=None):
    """-> ``prior_fn(images)``: the frozen netG's last feature stage
    (netG in eval mode, no gradients). A missing or empty path gives a
    netG initialised from seed 0."""
    device = resolve_device(device)
    if netg_path and os.path.exists(netg_path):
        netG = build_net(cfg.netG, load_params(netg_path)[0], device)
    else:
        netG = init_params(build_train_net(cfg, "netG"),
                           torch.Generator().manual_seed(0))
        netG = netG.requires_grad_(False).eval().to(device)

    def prior_fn(images: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return netG.filter(images)[-1][-1]

    return prior_fn


def main(argv=None):
    """-> (the last epoch's mean logged loss, the Trainer)."""
    args, cfg = parse_args(argv)
    device = resolve_device(args.device)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        torch.distributed.init_process_group(
            "nccl" if device.type == "cuda" else "gloo")
        device = rank_device(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
    compile_cache.enable()
    timed_convolutions(device)
    net = build_train_net(cfg, args.net)
    dataset = build_dataset(args, cfg)
    trainer = Trainer(net, cfg, steps_per_epoch=args.steps_per_epoch or 1000,
                      device=device)
    epochs = args.epochs or cfg.num_epoch

    loader = build_loader(args, cfg)
    prior_fn = (make_prior_fn(cfg, args.netg, device) if args.net == "netC"
                else None)

    def prep(b):
        batch = to_device(to_train_batch(b, args.net), device)
        if prior_fn is not None:
            batch["feat_prior"] = prior_fn(batch["images"])
        return batch

    if args.resume_from:
        trainer.init_state()
        trainer.load_ckpt(args.resume_from)
    last = float("nan")
    for epoch in range(trainer.epoch, epochs):
        source = (loader.epoch(epoch) if loader is not None
                  else make_batches(dataset, cfg.batch_size, seed=epoch))
        last = trainer.train_epoch((prep(b) for b in source), epoch)
        trainer.logger.info("epoch %d done, mean loss %.5f", epoch, last)
        # store epoch + 1: a resume from this checkpoint continues with
        # the next epoch rather than re-running the finished one
        trainer.update_ckpt(f"epoch_{epoch}", epoch + 1, trainer.iteration)
    return last, trainer


if __name__ == "__main__":
    main()

"""Rank bodies of the port's mesh tests (tests/test_torch_mesh.py): each
runs in a process of its own, one gloo rank, started by ``spawn``. This
module imports no JAX, so a spawned rank is a torch-only interpreter; the
test process computes the JAX side and hands the ranks their inputs
through a file (``torch.save``), and each rank writes its results to
``<out>/rank<r>.pt``."""

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from monoport_tpu_torch import weights
from monoport_tpu_torch.config import CN
from monoport_tpu_torch.engine import (EngineCfg, RayCfg, ReconEngine,
                                       RotatedCfg)
from monoport_tpu_torch.models.monoport_net import MonoPortNet
from monoport_tpu_torch.parallel import train_step as ts
from monoport_tpu_torch.parallel.mesh import make_mesh
from monoport_tpu_torch.recon.hierarchy import HierarchicalRecon

TIMEOUT = datetime.timedelta(seconds=120)


def _entry(rank: int, world: int, tmp: str, body, args: tuple) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world, timeout=TIMEOUT)
    try:
        torch.save(body(rank, *args), os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def start(world: int, tmp: str, body, *args):
    """Start ``body(rank, *args)`` on ``world`` gloo ranks; ``results``
    waits for them."""
    ctx = mp.spawn(_entry, args=(world, tmp, body, args), nprocs=world,
                   join=False)
    return ctx, world, tmp


def results(run) -> list:
    """The ranks' results, by rank. A rank that raises fails the run."""
    ctx, world, tmp = run
    while not ctx.join():
        pass
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


# -- frames ------------------------------------------------------------------
def engine(case: dict, nets: dict, mesh=None) -> ReconEngine:
    """The small engine of a frame case (tests/test_torch_engine.py's
    operating point)."""
    tg, tc = (weights.build_net(CN(opts), state, device="cpu")
              for opts, state in (nets[case["netG"]], nets["C"]))
    cfg = EngineCfg(render_size=32, ray=RayCfg(
        mode=case["mode"], fine_res=33, taps=4, window=24,
        march_levels=(9, 17) if case["mode"] == "ray" else None),
        rotated=RotatedCfg(**case.get("rotated", {})))
    return ReconEngine(tg, tc, recon=HierarchicalRecon(resolutions=(9, 17),
                                                       budgets=(0, 2048)),
                       config=cfg, device="cpu", mesh=mesh)


def frame(eng: ReconEngine, case: dict, image: np.ndarray) -> dict:
    img = torch.from_numpy(image)
    out = eng.frame(img, img, case["calib"], compact_hint=case.get("hint"))
    return {k: v.numpy() for k, v in out.items()}


def frames_rank(rank: int, path: str) -> dict:
    """Every case's frame under each mesh of the payload (``meshes``:
    name -> dp), and on rank 0 the unsharded frame of each case."""
    data = torch.load(path, weights_only=False)
    world = dist.get_world_size()
    out = {}
    for mesh_name, dp in data["meshes"].items():
        mesh = make_mesh(world, dp=dp)
        for name, case in data["cases"].items():
            out[mesh_name, name] = frame(engine(case, data["nets"], mesh),
                                         case, data["image"])
    if rank == 0:
        for name, case in data["cases"].items():
            out["single", name] = frame(engine(case, data["nets"]), case,
                                        data["image"])
    return out


# -- train steps --------------------------------------------------------------
def _net(opts: dict, heads: tuple, state: dict) -> MonoPortNet:
    """The net of ``opts`` in the state's dtype, holding ``state``."""
    net = MonoPortNet(CN(opts), head_channels=heads)
    net.to(next(iter(state.values())).dtype).load_state_dict(state)
    return net


def train_rank(rank: int, path: str) -> dict:
    """One step of each net of the payload on its global batch under a
    mesh of ``dp``, from the same weights on every rank (rank 0's: the
    others start from other draws), then the scan step of two batches
    against the same two steps one by one."""
    data = torch.load(path, weights_only=False)
    mesh = make_mesh(dist.get_world_size(), dp=data["dp"])
    out = {}
    for name, (opts, heads, state, batch) in data["nets"].items():
        net = _net(opts, heads, state)
        if rank != 0:
            ts.init_params(net, torch.Generator().manual_seed(rank))
        st = ts.create_train_state(net, ts.make_optimizer(**data["tx"]),
                                   mesh=mesh)
        _, loss = ts.make_train_step(net, mesh)(st, batch)
        out[name] = {"loss": loss, "state": net.state_dict()}
    opts, heads, state, batch = data["nets"][data["scan"]]
    steps = []
    for scan in (False, True):
        net = _net(opts, heads, state)
        st = ts.create_train_state(net, ts.make_optimizer(**data["tx"]),
                                   mesh=mesh)
        two = [batch, {k: v.flip(0) for k, v in batch.items()}]
        if scan:
            stacked = {k: torch.stack([b[k] for b in two]) for k in batch}
            _, losses = ts.make_scan_train_step(net, mesh)(st, stacked)
        else:
            step = ts.make_train_step(net, mesh)
            losses = torch.stack([step(st, b)[1] for b in two])
        steps.append((losses, net.state_dict()))
    out["scan"] = steps
    return out

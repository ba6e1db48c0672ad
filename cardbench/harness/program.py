"""The system under test: the port's ``ReconEngine`` at a configuration's
operating point, built from the benchmark's weights. This is the one
module of the harness that imports the port."""

from __future__ import annotations

import os
import time

import torch

_NET_KEYS = ("projection", "backbone", "normalizer", "head", "loss", "mean",
             "std")
_RAY_KEYS = ("fine_res", "taps", "window", "march_levels")


def _opt(spec: dict) -> dict:
    opt = {k: spec[k] for k in _NET_KEYS if k in spec}
    opt["head"] = {"IMF": spec["head"]["IMF"]}
    return opt


def build_kernels() -> dict:
    """Compile the port's kernel sources unless the checkout's build
    directory has them all; -> seconds by source (empty when cached)."""
    from monoport_tpu_torch.ops.cuda import build

    seconds: dict = {}
    if not all(os.path.exists(build.library_path(n))
               for n in build.sources()):
        build.build_all(seconds)
    for name in build.sources():
        build.library(name)
    return seconds


def engine_config(config: dict):
    """(HierarchicalRecon, EngineCfg) of a configuration's ``profile``: the
    hierarchy, and the path of its ``mode`` with the fields the profile
    gives (the engine's defaults for the rest)."""
    from monoport_tpu_torch.engine import EngineCfg, RayCfg, RotatedCfg
    from monoport_tpu_torch.recon.hierarchy import HierarchicalRecon

    p = config["profile"]
    h = p["hierarchy"]
    recon = HierarchicalRecon(
        resolutions=tuple(h["resolutions"]), budgets=tuple(h["budgets"]),
        b_min=tuple(p["b_min"]), b_max=tuple(p["b_max"]),
        balance_value=p["balance_value"], boundary_tau=h["boundary_tau"],
        dilate=h["dilate"], select=h["select"])
    ray = {k: tuple(p[k]) if isinstance(p[k], list) else p[k]
           for k in _RAY_KEYS if k in p}
    cfg = EngineCfg(
        render_size=p["render_size"],
        compute_dtype=getattr(torch, p["compute_dtype"]),
        ray=RayCfg(mode=p["mode"], **ray),
        rotated=RotatedCfg(**p.get("rotated", {})))
    return recon, cfg


def build_engine(config: dict, states: dict, device):
    """(engine, seconds to build it)."""
    from monoport_tpu_torch.config import CN
    from monoport_tpu_torch.engine import ReconEngine
    from monoport_tpu_torch.weights import build_net

    t0 = time.perf_counter()
    nets = {k: build_net(CN(_opt(config[k])), states[k], device)
            for k in states}
    recon, cfg = engine_config(config)
    engine = ReconEngine(nets["netG"], nets.get("netC"), recon=recon,
                         config=cfg, device=device)
    return engine, time.perf_counter() - t0

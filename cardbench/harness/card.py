"""The card a run measures, the process-wide settings it pins, and the
check that no JAX module is loaded."""

from __future__ import annotations

import subprocess
import sys

import torch

FORBIDDEN = ("jax", "jaxlib", "flax", "monoport_tpu")
SMI_FIELDS = ("name", "power.limit", "power.draw", "clocks.sm", "clocks.mem",
              "clocks.max.sm", "temperature.gpu")


def smi() -> dict:
    """What ``nvidia-smi`` reads of card 0 (empty where it is absent)."""
    try:
        line = subprocess.run(
            ["nvidia-smi", f"--query-gpu={','.join(SMI_FIELDS)}",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return {}
    return dict(zip(SMI_FIELDS, (v.strip() for v in line.split(","))))


def pin() -> dict:
    """cuDNN's timed algorithms off (the demo serves with them unset) and
    TF32 off (the engine's dtype policy; the reference is plain f32)."""
    torch.backends.cudnn.benchmark = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"cudnn.benchmark": False, "matmul.allow_tf32": False,
            "cudnn.allow_tf32": False}


def versions() -> dict:
    return {"python": sys.version.split()[0], "torch": torch.__version__,
            "cuda": torch.version.cuda, "cudnn": torch.backends.cudnn.version()}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX's
    or the JAX package's, compared whole."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def device(count: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(count))}

"""In-kernel gather against the pre-gathered compositions, on one card
(port of ``scripts/profile_gather_kernel.py``).

    python -m monoport_tpu_torch.profile_gather

Measures ``apply_gather_ray`` (the bilinear gather fused with the MLP:
in bf16 a weighted-row pass feeding the ray MLP's wgmma kernel) against
the compositions the frames use, at two frame shapes of the netG
head (257, 1024, 512, 256, 128, 1) over a 128 x 128 x 256 feature map:

  shape fine_192x6:   36,864 rays x 6 taps (the fine ray pass)
  shape point_36k_t1: 36,864 rays x 1 tap  (a per-point query)

paths a shape:
  index:     ``ops/sampling.index`` on the f32 map -> ``apply_ray``
  in_kernel: ``apply_gather_ray`` on the map as a bf16 table
  grid:      (fine_192x6 only) ``index_grid`` on the 192 x 192
             outer-product lattice -> ``apply_ray``: the frontal frames'
             separable sampling, a reference point beside the two

Weights, map, uv (uniform in +-0.74) and z come from a numpy seed. Times
are CUDA events around ``reps`` calls after a warm-up; prints ms and
M rays/s a path, then one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess

import numpy as np
import torch

from .models.heads.surface_classifier import SurfaceClassifier
from .ops.cuda.fused_gather_mlp import apply_gather_ray
from .ops.cuda.fused_ray_mlp import apply_ray, pack_ray_mlp_params
from .ops.sampling import index, index_grid
from .weights import resolve_device

CH = (257, 1024, 512, 256, 128, 1)          # the netG head
MAP = (1, 128, 128, 256)
SIDE = 192
SHAPES = (("fine_192x6", SIDE * SIDE, 6), ("point_36k_t1", 36864, 1))


def seeded_head(rng: np.random.RandomState, chans=CH) -> SurfaceClassifier:
    """A sigmoid head of widths ``chans`` with N(0, 0.05) weights and zero
    biases drawn from ``rng``."""
    head = SurfaceClassifier(chans, last_op="sigmoid")
    with torch.no_grad():
        for lin in head.layers():
            out_dim, fan_in = lin.weight.shape
            w = rng.randn(fan_in, out_dim).astype(np.float32) * 0.05
            lin.weight.copy_(torch.from_numpy(w.T.copy()))
            lin.bias.zero_()
    return head


def make_inputs(seed: int = 0, device="cpu", chans=CH, map_shape=MAP,
                side: int = SIDE, shapes=SHAPES) -> dict:
    """The head packed in bf16, the f32 map, and uv / z of every shape, from
    ``seed``."""
    rng = np.random.RandomState(seed)
    dev = torch.device(device)
    to = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    packed = pack_ray_mlp_params(seeded_head(rng, chans), torch.bfloat16, dev)
    inputs = {"packed": packed, "feat32": to(rng.randn(*map_shape)),
              "shapes": {}}
    for label, rays, taps in shapes:
        inputs["shapes"][label] = {
            "uv": to(rng.uniform(-0.74, 0.74, (1, rays, 2))),
            "z": to(rng.randn(1, rays, taps) * 0.3)}
    inputs["grid"] = {"u": to(rng.uniform(-0.74, 0.74, (1, side))),
                      "v": to(rng.uniform(-0.74, 0.74, (1, side))),
                      "z": to(rng.randn(1, side * side, shapes[0][2]) * 0.3)}
    return inputs


def paths(inputs: dict) -> dict:
    """{shape: {path: thunk}}: every measured call, on ``inputs``."""
    packed, feat32 = inputs["packed"], inputs["feat32"]
    table = feat32.to(torch.bfloat16)          # cast once, as a frame would
    out: dict = {}
    for label, s in inputs["shapes"].items():
        uv, z = s["uv"], s["z"]
        out[label] = {
            "index": lambda uv=uv, z=z: apply_ray(packed, index(feat32, uv),
                                                  z),
            "in_kernel": lambda uv=uv, z=z: apply_gather_ray(packed, table,
                                                             uv, z)}
    g = inputs["grid"]
    c = feat32.shape[-1]
    first = next(iter(out))
    out[first]["grid"] = lambda: apply_ray(
        packed, index_grid(feat32, g["u"], g["v"]).reshape(1, -1, c), g["z"])
    return out


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def run(device=None, reps: int = 20, seed: int = 0) -> dict:
    """Time every path on the card -> {"<shape>_<path>_ms", ..._mrays}.
    Also checks that in_kernel and index agree to bf16 accuracy (they
    differ by the table's rounding)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("profile_gather times the card: it needs CUDA")
    inputs = make_inputs(seed, dev)
    out: dict = {}
    for label, fns in paths(inputs).items():
        rays = inputs["shapes"][label]["uv"].shape[1]
        diff = (fns["in_kernel"]() - fns["index"]()).abs().max().item()
        out[f"{label}_in_kernel_vs_index_max_diff"] = diff
        if not diff < 5e-2:
            raise RuntimeError(f"{label}: in_kernel and index differ by "
                               f"{diff}")
        for name, fn in fns.items():
            ms = cuda_ms(fn, reps)
            out[f"{label}_{name}_ms"] = ms
            out[f"{label}_{name}_mrays"] = rays / ms / 1e3
            print(label, name, f"{ms:.3f} ms", f"{rays / ms / 1e3:.2f} Mrays/s",
                  flush=True)
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    return out


if __name__ == "__main__":
    print(json.dumps(run()))

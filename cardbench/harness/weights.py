"""A configuration's weights, made or loaded by the benchmark and handed to
both sides: one torch state dict a net (f32, on the device), in the
parameter names the reference and the system under test share.

``npz``: a flat checkpoint of '/'-joined flax names (f16 on disk) read
with numpy and renamed (conv HWIO -> OIHW, dense [in, out] -> [out, in],
norm scale -> weight). ``seeded``: drawn on the device from the run's seed
in two calls (normals for every tensor, uniforms for the BatchNorm
variances): conv and linear weights N(0, 1 / fan_in), norm weights
1 + N(0, 0.01), biases and running means N(0, 0.01), running variances
U(0.5, 1.5); with ``norm_stats: traffic`` every BatchNorm's running
statistics are then set to those of its input over the traffic's images
(one pass of the reference backbone over all of them, each layer fitted
before the next sees it), so that the features follow the subject and
not the draw's offsets; then the head is conditioned as the recipe says
(its last layer scaled and given a fixed weight on z, so a surface
crosses every ray).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..reference.nets import ImplicitNet
from .manifest import ROOT


def npz_state(path: str) -> dict:
    state = {}
    with np.load(os.path.join(ROOT, path)) as data:
        for name in data.files:
            if name.startswith("__"):
                continue
            value = np.asarray(data[name], np.float32)
            base, leaf = name.replace("/", ".").rsplit(".", 1)
            if leaf == "kernel" and value.ndim == 4:
                value = value.transpose(3, 2, 0, 1)
            elif leaf == "kernel" and value.ndim == 2:
                value = value.T
            elif leaf not in ("kernel", "scale", "bias"):
                raise KeyError(f"unexpected leaf {name!r} in {path}")
            leaf = "bias" if leaf == "bias" else "weight"
            state[f"{base}.{leaf}"] = torch.from_numpy(
                np.ascontiguousarray(value))
    return state


def seeded_state(spec: dict, recipe: dict, seed: int, device) -> dict:
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in
                  sorted(ImplicitNet(spec).state_dict().items())}
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    sizes = [int(np.prod(s)) for s in shapes.values()]
    normal = torch.randn(sum(sizes), generator=gen, device=device)
    n_var = sum(n for k, n in zip(shapes, sizes) if k.endswith("running_var"))
    uniform = torch.rand(n_var, generator=gen, device=device)
    state, at, at_var = {}, 0, 0
    for (key, shape), n in zip(shapes.items(), sizes):
        x = normal[at:at + n].reshape(shape)
        at += n
        if key.endswith("num_batches_tracked"):
            state[key] = torch.zeros((), dtype=torch.int64, device=device)
            continue
        if key.endswith("running_var"):
            x = uniform[at_var:at_var + n].reshape(shape) + 0.5
            at_var += n
        elif key.endswith("weight") and len(shape) > 1:
            x = x / float(np.sqrt(np.prod(shape[1:])))
        elif key.endswith("weight"):
            x = 1.0 + 0.1 * x
        else:
            x = 0.1 * x
        state[key] = x.contiguous()
    head = recipe["head"]
    last = f"surface_classifier.filters_{len(spec['head']['widths']) - 2}"
    state[f"{last}.weight"] *= head["last_scale"]
    state[f"{last}.weight"][:, -1] = head["last_z_weight"]
    state[f"{last}.bias"].zero_()
    return state


@torch.no_grad()
def fit_norm_stats(spec: dict, state: dict, images: torch.Tensor) -> None:
    """Set ``state``'s BatchNorm running statistics, in place, to those of
    each BatchNorm's input over ``images`` (the reference backbone, f32)."""
    net = ImplicitNet(spec).to(images.device)
    net.load_state_dict(state, strict=True)

    def fit(mod, args):
        x = args[0]
        mod.running_mean.copy_(x.mean(dim=(0, 2, 3)))
        mod.running_var.copy_(x.var(dim=(0, 2, 3)))

    hooks = [m.register_forward_pre_hook(fit) for m in net.modules()
             if isinstance(m, torch.nn.BatchNorm2d)]
    net.filter(images.float())
    for h in hooks:
        h.remove()
    for key, value in net.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            state[key].copy_(value)


def states(config: dict, seed: int, device, images=None) -> dict:
    """{'netG': state, ['netC': state]} of a configuration on ``device``;
    ``images``: the traffic's, for a recipe that fits norm statistics."""
    recipe = config["weights"]
    out = {}
    for key in ("netG", "netC"):
        if key not in config:
            continue
        if recipe["kind"] == "npz":
            out[key] = {k: v.to(device) for k, v in
                        npz_state(recipe[key]).items()}
        elif recipe["kind"] == "seeded":
            out[key] = seeded_state(config[key], recipe, seed, device)
            if recipe.get("norm_stats") == "traffic":
                fit_norm_stats(config[key], out[key], images)
        else:
            raise ValueError(f"unknown weights recipe {recipe['kind']!r}")
    return out

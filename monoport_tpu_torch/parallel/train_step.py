"""Train step and optimizers (port of
``monoport_tpu/parallel/train_step.py``).

One step: the forward over every supervised stage (``MonoPortNet``'s
``train=True`` path, the plain head), the multi-stage loss, the backward
and the update, with no host synchronisation (the loss comes back as a
device tensor; the global-norm clip picks its factor on the device).

The update rules are optax's, written on tensors, not torch.optim's
(``make_optimizer`` builds the same chain as the JAX package):
- RMSprop: decay 0.9, ``g / sqrt(nu + eps)`` with eps inside the root, nu
  from 0, then the learning rate, then the momentum trace;
- Adam: bias-corrected moments, ``m / (sqrt(v) + eps)``;
- Adadelta: its weight decay inside, not in the decayed-weights chain;
- SGD: the momentum trace before the learning rate;
- ``clip_by_global_norm`` over every parameter together, then
  ``add_decayed_weights``, then the optimizer;
- schedules are functions of the count of earlier updates:
  ``piecewise_constant_schedule`` scales from the update whose count
  equals a milestone on.

``TrainState`` holds the step (a host int: every count of the update
derives from it), the module (its parameters, and its BatchNorm running
stats as buffers) and the optimizer state.

Under a ``parallel.mesh.Mesh`` of several ranks (data parallel, one
process a rank): the state is replicated (``create_train_state``
broadcasts the first rank's parameters and buffers), the step takes the
global batch and each rank runs forward and backward on its piece
(``mesh.shard_batch``: the batch over ``data``, the points over ``data``
and ``points``), and one all-reduce averages the gradients and the loss
over the mesh before the update, so the global-norm clip reads the global
norm, as optax does under jit. Every loss of the package is a plain mean,
so with equal pieces the mean over ranks is the loss of the global batch.
BatchNorm's train-mode statistics are averaged over the ``data`` axis
(``models.backbones.hourglass.batch_stats_over``), as the JAX step's batch
mean is global.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from ..models.backbones.hourglass import batch_stats_over
from .mesh import DATA_AXIS, Mesh, check_mesh, shard_batch

Schedule = Callable[[int], float]
Tensors = list[torch.Tensor]


# -- schedules -------------------------------------------------------------
def piecewise_constant_schedule(init_value: float,
                                boundaries_and_scales: dict) -> Schedule:
    """``init_value`` times every scale whose boundary is <= the count
    (``optax.piecewise_constant_schedule``)."""
    steps = sorted(boundaries_and_scales.items())

    def schedule(count: int) -> float:
        v = init_value
        for boundary, scale in steps:
            if count >= boundary:
                v *= scale
        return v

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Schedule:
    """Half a cosine from ``init_value`` down to ``alpha * init_value`` over
    ``decay_steps`` updates, then flat (``optax.cosine_decay_schedule``)."""

    def schedule(count: int) -> float:
        count = min(count, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


# -- transforms (each returns new update tensors; only its state changes) --
class Transform:
    slots: tuple[str, ...] = ()

    def update(self, u: Tensors, state: dict, params: Tensors,
               count: int) -> Tensors:
        raise NotImplementedError


class ClipByGlobalNorm(Transform):
    """Scale every update by max_norm / (global norm) where that norm is
    not below ``max_norm``; chosen on the device."""

    def __init__(self, max_norm: float):
        self.max_norm = max_norm

    def update(self, u, state, params, count):
        g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(u)))
        keep = g_norm < self.max_norm
        div = torch.where(keep, 1.0, g_norm)
        mul = torch.where(keep, 1.0, self.max_norm)
        return torch._foreach_mul(torch._foreach_div(u, div), mul)


class AddDecayedWeights(Transform):
    def __init__(self, weight_decay: float):
        self.weight_decay = weight_decay

    def update(self, u, state, params, count):
        return torch._foreach_add(u, params, alpha=self.weight_decay)


class Trace(Transform):
    """Momentum: trace = g + decay * trace; the update is the trace."""
    slots = ("trace",)

    def __init__(self, decay: float):
        self.decay = decay

    def update(self, u, state, params, count):
        trace = state["trace"]
        torch._foreach_mul_(trace, self.decay)
        torch._foreach_add_(trace, u)
        return list(trace)


def _bias_correction(decay: float, count: int) -> float:
    # optax computes 1 - decay**count in f32
    return float(np.float32(1.0) - np.float32(decay) ** np.int32(count))


class ScaleByAdam(Transform):
    slots = ("mu", "nu")

    def __init__(self, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps

    def update(self, u, state, params, count):
        mu, nu = state["mu"], state["nu"]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, u, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, u, u, value=1.0 - self.b2)
        mu_hat = torch._foreach_div(mu, _bias_correction(self.b1, count + 1))
        nu_hat = torch._foreach_div(nu, _bias_correction(self.b2, count + 1))
        den = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(den, self.eps)
        return torch._foreach_div(mu_hat, den)


class ScaleByRms(Transform):
    """g * rsqrt(nu + eps), nu the running mean of g^2 from 0."""
    slots = ("nu",)

    def __init__(self, decay: float = 0.9, eps: float = 1e-8):
        self.decay, self.eps = decay, eps

    def update(self, u, state, params, count):
        nu = state["nu"]
        torch._foreach_mul_(nu, self.decay)
        torch._foreach_addcmul_(nu, u, u, value=1.0 - self.decay)
        return [g * torch.rsqrt(n + self.eps) for g, n in zip(u, nu)]


class ScaleByAdadelta(Transform):
    slots = ("e_g", "e_x")

    def __init__(self, rho: float = 0.9, eps: float = 1e-6):
        self.rho, self.eps = rho, eps

    def update(self, u, state, params, count):
        e_g, e_x = state["e_g"], state["e_x"]
        torch._foreach_mul_(e_g, self.rho)
        torch._foreach_addcmul_(e_g, u, u, value=1.0 - self.rho)
        out = [torch.sqrt(x + self.eps) / torch.sqrt(g2 + self.eps) * g
               for g, g2, x in zip(u, e_g, e_x)]
        torch._foreach_mul_(e_x, self.rho)
        torch._foreach_addcmul_(e_x, out, out, value=1.0 - self.rho)
        return out


class ScaleByLearningRate(Transform):
    def __init__(self, learning_rate: Union[float, Schedule]):
        self.learning_rate = learning_rate

    def update(self, u, state, params, count):
        lr = self.learning_rate
        return torch._foreach_mul(u, -(lr(count) if callable(lr) else lr))


class Optimizer:
    """A chain of transforms (``optax.chain``). The state is a dict of
    tensor lists aligned with the parameter list, one key a transform's
    slot (``'<index>.<slot>'``), every slot starting at zeros."""

    def __init__(self, *transforms: Transform):
        self.transforms = transforms

    def init(self, params: Tensors) -> dict[str, Tensors]:
        return {f"{i}.{slot}": [torch.zeros_like(p) for p in params]
                for i, t in enumerate(self.transforms) for slot in t.slots}

    def update(self, grads: Tensors, state: dict, params: Tensors,
               count: int) -> Tensors:
        u = list(grads)
        for i, t in enumerate(self.transforms):
            mine = {slot: state[f"{i}.{slot}"] for slot in t.slots}
            u = t.update(u, mine, params, count)
        return u


def make_optimizer(optim: str = "RMSprop", learning_rate: float = 1e-3,
                   weight_decay: float = 0.0, momentum: float = 0.0,
                   schedule: Sequence[int] = (), gamma: float = 0.1,
                   grad_clip: float = 0.0) -> Optimizer:
    """Optimizer + MultiStepLR-style schedule, as the JAX package's:
    ``schedule`` milestones are in steps with decay factor ``gamma``;
    ``grad_clip`` puts a global-norm clip first."""
    lr = (piecewise_constant_schedule(
        learning_rate, {int(m): gamma for m in schedule}) if schedule
        else learning_rate)
    name = optim.lower()
    if name == "adadelta":
        chain = [AddDecayedWeights(weight_decay)] if weight_decay else []
        chain += [ScaleByAdadelta(), ScaleByLearningRate(lr)]
    elif name == "sgd":
        chain = [Trace(momentum)] if momentum else []
        chain += [ScaleByLearningRate(lr)]
    elif name == "adam":
        chain = [ScaleByAdam(), ScaleByLearningRate(lr)]
    elif name == "rmsprop":
        chain = [ScaleByRms(), ScaleByLearningRate(lr), Trace(momentum)]
    else:
        raise NotImplementedError(optim)
    if weight_decay and name in ("sgd", "adam", "rmsprop"):
        chain.insert(0, AddDecayedWeights(weight_decay))
    if grad_clip:
        chain.insert(0, ClipByGlobalNorm(grad_clip))
    return Optimizer(*chain)


# -- parameter initialisation ---------------------------------------------
_TRUNC_STD = 0.87962566103423978   # std of a unit normal cut at +-2


def _variance_scaling(param: torch.Tensor, scale: float,
                      generator: torch.Generator) -> None:
    """flax's variance_scaling(scale, 'fan_in', 'truncated_normal'): a unit
    normal cut at +-2, times sqrt(scale / fan_in) / its std."""
    std = math.sqrt(scale / param[0].numel()) / _TRUNC_STD
    draw = torch.empty(param.shape)
    nn.init.trunc_normal_(draw, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)
    param.copy_(draw)


@torch.no_grad()
def init_params(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """From-scratch weights from flax's initialisers' distributions:
    lecun_normal Conv / Dense kernels (a head's output layer scaled by its
    ``out_init_scale``), zero biases, norms at scale 1 and bias 0 (running
    stats at 0 / 1). ``generator`` is a CPU generator; the draws are
    copied to the parameters' device."""
    from ..models.heads.surface_classifier import SurfaceClassifier

    out_scale = {}
    for module in net.modules():
        if isinstance(module, SurfaceClassifier):
            out_scale[module.layers()[-1]] = module.out_init_scale
    done = set()
    for module in net.modules():
        if isinstance(module, (nn.Conv2d, nn.Linear)):
            _variance_scaling(module.weight, out_scale.get(module, 1.0),
                              generator)
        elif isinstance(module, (nn.GroupNorm, nn.BatchNorm2d)):
            module.weight.fill_(1.0)
            if isinstance(module, nn.BatchNorm2d):
                module.reset_running_stats()
        else:
            continue
        if module.bias is not None:
            module.bias.zero_()
        done.update(id(p) for p in module.parameters(recurse=False))
    missed = [n for n, p in net.named_parameters() if id(p) not in done]
    if missed:
        raise TypeError(f"no initialiser for {missed[:5]}")
    return net


# -- state and step --------------------------------------------------------
@dataclasses.dataclass
class TrainState:
    step: int
    net: nn.Module
    opt_state: dict[str, Tensors]
    tx: Optimizer

    @property
    def params(self) -> Tensors:
        return list(self.net.parameters())

    @torch.no_grad()
    def apply_gradients(self, grads: Tensors) -> "TrainState":
        params = self.params
        updates = self.tx.update(grads, self.opt_state, params, self.step)
        torch._foreach_add_(params, updates)
        self.step += 1
        return self


def timed_convolutions(device) -> None:
    """On the card, set ``torch.backends.cudnn.benchmark`` for the process:
    cuDNN then times its convolution algorithms once a shape instead of
    taking its heuristic's pick, which in f32 without TF32 (cuDNN 9.2) is
    an FFT engine for the hourglass's 3x3 256 -> 128 convolutions at 128^2
    that launches ~33,000 small GEMMs: 254 ms a call against 0.49 ms
    measured on an H100. Process-wide, so only an entry point calls it
    (the training apps' ``main``), before its first convolution of a
    shape: PyTorch keeps a shape's pick."""
    if torch.device(device).type == "cuda":
        torch.backends.cudnn.benchmark = True


def create_train_state(net: nn.Module, tx: Optimizer,
                       generator: Optional[torch.Generator] = None,
                       mesh: Optional[Mesh] = None) -> TrainState:
    """A state at step 0 over ``net``'s parameters, drawn anew from
    ``generator`` (``init_params``) when one is given, else as loaded.
    Under a mesh of several ranks every rank then takes the first rank's
    parameters and buffers, whatever its generator drew. Nothing
    process-wide changes: the training apps pick cuDNN's algorithms
    themselves (``timed_convolutions``)."""
    if generator is not None:
        init_params(net, generator)
    group = mesh.group() if check_mesh(mesh) is not None else None
    if group is not None:
        src = int(mesh.ranks.flat[0])
        with torch.no_grad():
            for t in list(net.parameters()) + list(net.buffers()):
                dist.broadcast(t, src=src, group=group)
    net.requires_grad_(True).train()
    return TrainState(step=0, net=net, opt_state=tx.init(
        list(net.parameters())), tx=tx)


def _mesh_mean(tensors: Tensors, mesh: Mesh) -> Tensors:
    """The mean of each tensor over the mesh's ranks: one all-reduce of
    them all, flattened into one buffer."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.group())
    flat.div_(mesh.size)
    return [part.view_as(t) for part, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def loss_step(state: TrainState, loss_fn: Callable, *batch,
              mesh: Optional[Mesh] = None) -> torch.Tensor:
    """One optimizer step of ``state`` on ``loss_fn(state.net, *batch)``
    (a parameter without a gradient steps on zeros). Under a mesh of
    several ranks the gradients and the loss are first averaged over its
    ranks. -> the loss before the step, a device tensor (no host sync)."""
    params = state.params
    for p in params:
        p.grad = None
    loss = loss_fn(state.net, *batch)
    loss.backward()
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    loss = loss.detach()
    if mesh is not None and mesh.size > 1:
        *grads, loss = _mesh_mean(grads + [loss], mesh)
    state.apply_gradients(grads)
    for p in params:
        p.grad = None
    return loss


def _monoport_loss(net: nn.Module, batch: dict) -> torch.Tensor:
    return net(batch["images"], batch["points"], batch["calibs"],
               labels=batch["labels"], feat_prior=batch.get("feat_prior"),
               train=True)[1]


def make_train_step(net: nn.Module, mesh: Optional[Mesh] = None
                    ) -> Callable:
    """-> ``step(state, batch) -> (state, loss)``: forward (train mode,
    every stage), loss, backward and update of ``state`` in place. A batch
    holds images, points, calibs, labels and, for netC, 'feat_prior' (the
    frozen netG's last feature stage, computed outside the step).

    Under a mesh (module docstring) ``batch`` is the global batch, every
    rank of the mesh calls the step with the same one, and the loss is the
    global mean; an uneven split raises."""
    sharded = check_mesh(mesh) is not None and mesh.size > 1
    stats = (mesh.group(DATA_AXIS), mesh.shape[DATA_AXIS]) if sharded \
        else (None, 1)

    def step_fn(state: TrainState, batch: dict):
        if state.net is not net:
            raise ValueError("the state holds another module")
        net.train()
        if not sharded:
            return state, loss_step(state, _monoport_loss, batch)
        if not mesh.active:
            raise RuntimeError(f"rank {mesh.rank} is outside the mesh: it "
                               f"runs no step")
        with batch_stats_over(net, *stats):
            return state, loss_step(state, _monoport_loss,
                                    shard_batch(mesh, batch), mesh=mesh)

    return step_fn


def make_scan_train_step(net: nn.Module, mesh: Optional[Mesh] = None
                         ) -> Callable:
    """-> ``run(state, stacked) -> (state, losses)``: the steps of a batch
    stacked on a leading step axis, in order (the same arithmetic as
    ``make_train_step``; under a mesh each step's global batch)."""
    step_fn = make_train_step(net, mesh)

    def scan_fn(state: TrainState, stacked: dict):
        losses = []
        for i in range(len(stacked["images"])):
            state, loss = step_fn(state, {k: v[i] for k, v in
                                          stacked.items()})
            losses.append(loss)
        return state, torch.stack(losses)

    return scan_fn

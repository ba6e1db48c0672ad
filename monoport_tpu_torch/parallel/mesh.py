"""Device mesh over ``torch.distributed`` (port of
``monoport_tpu/parallel/mesh.py``).

A mesh lays the world's ranks out as a ``[dp, sp]`` array with two axes:

  * ``data``   - batch data parallelism: each rank trains on a slice of
                 the batch, and the gradients are averaged over the mesh;
  * ``points`` - sharding of the long query-point axis: each rank
                 evaluates a slice of the 3D query points (or rays) against
                 replicated image features, and the outputs are gathered.

One process is one rank, and a rank drives one card (or the CPU, with the
gloo backend). Where the JAX package hands shardings to jit and XLA inserts
the collectives, here each axis has a process group and the callers
(``engine.ReconEngine``, ``parallel/train_step``) run the collectives
themselves. ``batch_sharding`` keeps the JAX package's keys, as a spec of
axis names a dimension; ``shard`` cuts this rank's piece of a global
tensor by such a spec.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
POINT_AXIS = "points"
AXES = (DATA_AXIS, POINT_AXIS)

# a spec: the mesh axis (or None) that splits each leading dimension
Spec = tuple


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """The ranks of a (data, points) mesh and this rank's place in it.

    ranks: [dp, sp] global ranks; rank: this process's global rank;
    coords: (data index, point index) of this rank, None when the rank is
    outside the mesh (it then takes part in none of its collectives);
    groups: the process group of each axis that this rank belongs to (the
    ranks sharing its other index), and under ``AXES`` the group of the
    whole mesh; None where the group has one rank (no collective)."""
    ranks: np.ndarray
    rank: int
    coords: Optional[tuple[int, int]]
    groups: dict

    axis_names = AXES

    @property
    def shape(self) -> dict:
        return dict(zip(AXES, self.ranks.shape))

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    @property
    def active(self) -> bool:
        """This rank is one of the mesh's."""
        return self.coords is not None

    def index(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self.coords[AXES.index(axis)]

    def group(self, axis=AXES):
        """The process group along ``axis`` (an axis name, or ``AXES`` for
        the whole mesh): None when it has one rank."""
        return self.groups[axis]


def check_mesh(mesh) -> Optional[Mesh]:
    """``mesh`` itself: None or a ``Mesh`` (anything else raises)."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh, not "
                        f"{type(mesh).__name__}")
    return mesh


def world() -> tuple[int, int]:
    """(rank, world size) of the initialized process group, else (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def default_dp(n: int) -> int:
    """The JAX package's dp rule: the largest power-of-two split that
    keeps at least two point shards when more than 2 ranks are present."""
    dp = 1
    while n // dp > 2 and dp * 2 <= n and n % (dp * 2) == 0:
        dp *= 2
    return dp


def _new_group(ranks: Sequence[int], world_size: int):
    """A process group of ``ranks`` (every rank of the world must call
    this, in the same order); the default group when it spans the world."""
    ranks = [int(r) for r in ranks]
    if len(ranks) == world_size:
        return dist.group.WORLD
    return dist.new_group(ranks)


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              devices: Optional[Sequence[int]] = None) -> Mesh:
    """Build a (data, points) mesh over the world's ranks (``devices``: a
    list of ranks, default all; ``n_devices`` keeps the first n).

    ``dp`` defaults to the JAX package's rule (``default_dp``). A world of
    one rank needs no process group; a larger one needs an initialized
    group, and every rank of it must call ``make_mesh`` with the same
    arguments (the axes' groups are created collectively)."""
    rank, world_size = world()
    if devices is None and n_devices is not None and n_devices > world_size:
        raise RuntimeError(
            f"a mesh of {n_devices} ranks needs an initialized process "
            f"group of at least that many; the world has {world_size} "
            f"(torch.distributed.init_process_group)")
    ranks = list(range(world_size)) if devices is None else list(devices)
    if n_devices is not None:
        ranks = ranks[:n_devices]
    if any(not 0 <= r < world_size for r in ranks) or not ranks:
        raise RuntimeError(
            f"mesh ranks {ranks} are not ranks of a world of {world_size} "
            f"(torch.distributed.init_process_group)")
    n = len(ranks)
    if dp is None:
        dp = default_dp(n)
    if n % dp:
        raise ValueError(f"{n} ranks do not split into dp={dp}")
    arr = np.asarray(ranks, np.int64).reshape(dp, n // dp)
    where = np.argwhere(arr == rank)
    coords = tuple(int(i) for i in where[0]) if len(where) else None
    groups: dict = {AXES: None, DATA_AXIS: None, POINT_AXIS: None}
    if world_size > 1:
        # every rank creates every group, in one order
        if n > 1:
            g = _new_group(arr.ravel(), world_size)
            groups[AXES] = g if coords is not None else None
        for axis, lines in ((DATA_AXIS, arr.T), (POINT_AXIS, arr)):
            if lines.shape[1] == 1:
                continue
            for line in lines:
                g = _new_group(line, world_size)
                if rank in line:
                    groups[axis] = g
    return Mesh(ranks=arr, rank=rank, coords=coords, groups=groups)


def replicated(mesh: Mesh) -> Spec:
    """The spec of a tensor every rank holds whole."""
    return ()


def batch_sharding(mesh: Mesh) -> dict:
    """Specs of a training batch dict: images, calibs and 'feat_prior' are
    split over ``data``; points and labels over ``data`` and ``points``.
    Another key is split over ``data`` (``shard_batch``)."""
    return {
        "images": (DATA_AXIS,),
        "points": (DATA_AXIS, POINT_AXIS),
        "calibs": (DATA_AXIS,),
        "labels": (DATA_AXIS, POINT_AXIS),
        "feat_prior": (DATA_AXIS,),
    }


def shard(mesh: Mesh, x: torch.Tensor, spec: Spec) -> torch.Tensor:
    """This rank's piece of the global tensor ``x``: dimension i split
    evenly over ``spec[i]`` (an axis name or None). Raises when an axis
    does not divide its dimension."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = mesh.shape[axis]
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does "
                             f"not split evenly over {n} '{axis}' ranks")
        k = x.shape[dim] // n
        x = x.narrow(dim, mesh.index(axis) * k, k)
    return x


def shard_batch(mesh: Mesh, batch: dict) -> dict:
    """This rank's piece of a global batch (``batch_sharding``)."""
    specs = batch_sharding(mesh)
    return {k: shard(mesh, v, specs.get(k, (DATA_AXIS,)))
            for k, v in batch.items()}


def rank_device(device: torch.device) -> torch.device:
    """``cuda`` in a world of several ranks is this rank's card,
    ``cuda:LOCAL_RANK`` (torchrun sets it); any other device as given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and world()[1] > 1:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return device

"""Hierarchical surface localization (port of
``monoport_tpu/recon/hierarchy.py``).

Evaluate a dense coarse grid, then at each finer 2^k+1 level trilinearly
upsample the occupancy and re-evaluate only the voxels near the
``balance_value`` iso-surface (plus dilation), writing the results into the
dense volume.

Every level has a static shape: the candidate voxels are compacted into a
padded index buffer of the level's budget (``ops/compaction.select_k``) and
written back through their rank field, so the per-level query is one batch
of ``budget`` points and no count reaches the host (``counts`` are device
scalars). Upsampling is the separable matrix interpolation of
``ops/resize.interpolate_3d``, exact on the nested grids.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from ..ops.compaction import dilate_mask, rank_writeback, select_k
from ..ops.resize import interpolate_3d
from .dense import QueryFn, dense_eval, flat_to_world, grid_points


@dataclasses.dataclass(frozen=True)
class HierarchicalRecon:
    """Coarse-to-fine occupancy reconstruction with static shapes.

    select: 'uncertain' = two-tier priority by |occ - balance| so that a
    budget overflow drops the most confident voxels first; 'first' = the
    first K candidates in scan order (an overflow then never refines the
    far side of the volume)."""
    resolutions: Sequence[int] = (17, 33, 65, 129, 257)
    b_min: tuple = (-1.0, -1.0, -1.0)
    b_max: tuple = (1.0, 1.0, 1.0)
    balance_value: float = 0.5
    budgets: Sequence[int] = (0, 16384, 65536, 131072, 262144)
    boundary_tau: float = 0.2
    dilate: int = 1
    select: str = "uncertain"

    def __post_init__(self):
        if len(self.budgets) != len(self.resolutions):
            raise ValueError("one budget per resolution")
        for coarse, fine in zip(self.resolutions[:-1], self.resolutions[1:]):
            if fine != 2 * coarse - 1:
                raise ValueError("resolutions must be nested 2^k+1 grids")

    def __call__(self, query_fn: QueryFn, return_counts: bool = False,
                 device=None):
        """-> vol [R, R, R] on ``device`` (optionally with the candidate
        count of each refine level, 0-d device tensors)."""
        res0 = self.resolutions[0]
        pts0 = grid_points(res0, self.b_min, self.b_max, device=device)
        occ = query_fn(pts0[None])[0, :, 0].float().reshape(res0, res0, res0)
        counts: list = []
        for res, budget in zip(self.resolutions[1:], self.budgets[1:]):
            occ = self._refine_level(query_fn, occ, res, budget, counts)
        if return_counts:
            return occ, counts
        return occ

    def _refine_level(self, query_fn: QueryFn, occ_coarse: torch.Tensor,
                      res: int, budget: int, counts: list) -> torch.Tensor:
        occ_up = interpolate_3d(occ_coarse, (res, res, res))
        dist = torch.abs(occ_up - self.balance_value)
        band = dilate_mask(dist < self.boundary_tau, self.dilate)
        # points on the coarse lattice (all-even indices) are already exact
        even = torch.arange(res, device=occ_up.device) % 2 == 0
        coarse_pt = (even[:, None, None] & even[None, :, None]
                     & even[None, None, :])
        cand = band & ~coarse_pt
        counts.append(cand.sum())

        if self.select == "uncertain":
            # two tiers: all of the most uncertain voxels, then the rest,
            # so those survive a budget overflow
            close = dist < self.boundary_tau * 0.5
            hi = cand & close
            lo = cand & ~close
            idx_hi, rank_hi, total_hi = select_k(hi, budget)
            idx_lo, rank_lo, _ = select_k(lo, budget)
            ks = torch.arange(budget, device=occ_up.device)
            from_lo = torch.clamp(ks - total_hi, 0, budget - 1)
            idx = torch.where(ks >= total_hi, idx_lo[from_lo], idx_hi)
            rank = torch.where(hi, rank_hi, rank_lo + total_hi)
        else:
            idx, rank, _ = select_k(cand, budget)
        n_vox = res ** 3
        picked = idx < n_vox
        safe = torch.where(picked, idx, torch.zeros_like(idx))
        pts = flat_to_world(safe, res, self.b_min, self.b_max)
        preds = query_fn(pts[None])[0, :, 0].float()
        preds = torch.where(picked, preds,
                            torch.full_like(preds, self.balance_value))
        return rank_writeback(occ_up, cand, rank, preds)

    def dense(self, query_fn: QueryFn, resolution: int | None = None,
              chunk: int = 262144, device=None) -> torch.Tensor:
        """Exhaustive evaluation at the final resolution (the oracle of
        the hierarchy)."""
        resolution = resolution or self.resolutions[-1]
        return dense_eval(query_fn, resolution, self.b_min, self.b_max,
                          chunk=chunk, device=device)

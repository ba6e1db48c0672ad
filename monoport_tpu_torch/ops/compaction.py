"""Static-shape stream compaction (port of ``monoport_tpu/ops/compaction.py``).

The hierarchical evaluator and the mesh extractor need one primitive:
"the first K true positions of a boolean volume, and later write values
back at those positions". ``select_k`` ranks the true elements with one
cumulative sum over the flat mask and finds the K positions by a binary
search over it (``budget`` x log2(n) reads, no scatter, deterministic);
``rank_writeback`` gathers per-rank values back through the
rank field. Shapes are static and nothing synchronises the stream: no
``nonzero``, and the count stays a device scalar.

The JAX package's ``batched_cumsum`` and its binary-search selection work
around the TPU's slow flat scans and have no counterpart here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def select_k(mask: torch.Tensor, budget: int):
    """First-K true positions of a boolean tensor (any shape).

    Returns (idx [budget] int64: flat positions, ascending, == n for
    padding lanes; rank [mask.shape] int32: 0-based rank of each true
    element (the exclusive prefix sum); total [] int32: number of true
    elements)."""
    flat = mask.reshape(-1).to(torch.int32)
    n = flat.shape[0]
    cum = torch.cumsum(flat, dim=0, dtype=torch.int32)          # inclusive
    total = cum[-1]
    # the k-th (0-based) true element sits at the first i with cum[i] > k
    ks = torch.arange(budget, dtype=torch.int32, device=flat.device)
    idx = torch.searchsorted(cum, ks, right=True)
    idx = torch.where(ks < total, idx, torch.full_like(idx, n))
    return idx, (cum - flat).reshape(mask.shape), total


def rank_writeback(base: torch.Tensor, mask: torch.Tensor,
                   rank: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """base[i] <- values[rank[i]] where mask[i] and rank[i] < len(values):
    one clipped gather from the small ``values`` table."""
    budget = values.shape[0]
    safe = torch.clamp(rank, 0, budget - 1).long()
    take = mask & (rank < budget)
    return torch.where(take, values[safe].to(base.dtype), base)


def dilate_mask(mask: torch.Tensor, times: int = 1) -> torch.Tensor:
    """Separable 3x3x3 (3^ndim) boolean dilation by shift-ors."""
    for _ in range(times):
        for ax in range(mask.ndim):
            n = mask.shape[ax]
            # F.pad counts dimensions from the last
            pad = [0, 0] * (mask.ndim - 1 - ax) + [1, 1]
            padded = F.pad(mask, pad)
            mask = (mask | padded.narrow(ax, 0, n) | padded.narrow(ax, 2, n))
    return mask

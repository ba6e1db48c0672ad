"""Hierarchical reconstruction config (port of the ``HierarchicalRecon``
dataclass of ``monoport_tpu/recon/hierarchy.py``).

The frontal frame reads only ``b_min``, ``b_max`` and ``balance_value``
from it; the coarse-to-fine volume evaluator itself comes with the
dense/hierarchy slice.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class HierarchicalRecon:
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

    def __call__(self, query_fn, return_counts: bool = False):
        raise NotImplementedError(
            "the hierarchical volume evaluator is not ported yet (ROADMAP "
            "queue 1 item 8: dense/hierarchy slice)")

"""PyTorch port, compaction ops: ``select_k``, ``rank_writeback`` and
``dilate_mask`` against monoport_tpu/ops/compaction.py on the same numpy
masks. Integer outputs (``idx``, ``rank``, ``total``) must be equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from monoport_tpu.ops import compaction as jcomp
from monoport_tpu_torch.ops import compaction as tcomp

torch.set_num_threads(2)


def _mask(seed, shape, density):
    return np.random.RandomState(seed).rand(*shape) < density


# fewer and more true elements than the budget; none; all. (Sizes are not
# powers of two: there the JAX binary search is one round short, and the
# volumes, odd cubes, never are.)
CASES = [("fewer", (7, 9, 11), 0.05, 64), ("more", (7, 9, 11), 0.5, 64),
         ("none", (5, 6, 7), 0.0, 16), ("all", (4, 4, 5), 1.1, 16),
         ("flat_long", (5000,), 0.3, 256)]


@pytest.mark.parametrize("name,shape,density,budget", CASES,
                         ids=[c[0] for c in CASES])
def test_select_k_equals_jax(name, shape, density, budget):
    mask = _mask(0, shape, density)
    want = jcomp.select_k(jnp.asarray(mask), budget)
    got = tcomp.select_k(torch.from_numpy(mask), budget)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                      np.asarray(w).astype(np.int64))
    assert got[1].shape == mask.shape and got[2].ndim == 0


def test_select_k_exactly_the_budget():
    mask = np.zeros((6, 50), bool)
    mask.reshape(-1)[np.random.RandomState(1).permutation(300)[:40]] = True
    want = jcomp.select_k(jnp.asarray(mask), 40)
    idx, rank, total = tcomp.select_k(torch.from_numpy(mask), 40)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(idx.numpy(), np.flatnonzero(mask))
    np.testing.assert_array_equal(rank.numpy(), np.asarray(want[1]))
    assert int(total) == int(want[2]) == 40


@pytest.mark.parametrize("density", [0.1, 0.6])
def test_rank_writeback_equals_jax(density):
    rng = np.random.RandomState(2)
    mask = _mask(3, (6, 7, 8), density)
    base = rng.randn(6, 7, 8).astype(np.float32)
    budget = 48
    values = rng.randn(budget).astype(np.float32)
    _, jrank, _ = jcomp.select_k(jnp.asarray(mask), budget)
    want = jcomp.rank_writeback(jnp.asarray(base), jnp.asarray(mask), jrank,
                                jnp.asarray(values))
    _, rank, _ = tcomp.select_k(torch.from_numpy(mask), budget)
    got = tcomp.rank_writeback(torch.from_numpy(base), torch.from_numpy(mask),
                               rank, torch.from_numpy(values))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # elements past the budget keep the base
    flat = np.flatnonzero(mask)
    if len(flat) > budget:
        np.testing.assert_array_equal(got.numpy().reshape(-1)[flat[budget:]],
                                      base.reshape(-1)[flat[budget:]])


@pytest.mark.parametrize("shape,times", [((9, 9, 9), 1), ((6, 8, 10), 2),
                                         ((12, 12), 1), ((5, 1, 7), 1)])
def test_dilate_mask_equals_jax(shape, times):
    mask = _mask(4, shape, 0.04)
    want = jcomp.dilate_mask(jnp.asarray(mask), times)
    got = tcomp.dilate_mask(torch.from_numpy(mask), times)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.sum() > mask.sum()

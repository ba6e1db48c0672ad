"""The comparison's numbers on hand-made frames: the knife edges of the
silhouette and the volume left out by the reference's margins, a share
with nothing to count, and the sample's keep block."""

import gc
import math
import types

import numpy as np
import pytest
import torch

from cardbench.harness import cell, compare

TOLS = {"depth": 1.0, "valid": 1e-3, "sdf": 1e-3}


def _frame(valid, sdf=None):
    out = {"valid": torch.tensor(valid), "depth": torch.zeros(len(valid))}
    if sdf is not None:
        out["sdf"] = torch.tensor(sdf)
    return out


def test_valid_bad_leaves_out_the_knife_edges():
    got = _frame([True, True, False, False])
    want = _frame([True, False, True, False])
    want["valid_margin"] = torch.tensor([0.3, 1e-4, 0.2, 0.4])
    c = compare.frame_counts(got, want, TOLS)
    assert c["valid_disagree"] == [2, 3]
    assert c["valid_bad"] == [1, 3]             # the 1e-4 margin is left out
    assert c["valid_flip"] == pytest.approx(0.2)


def test_sdf_bad_counts_the_kept_inside_against_the_volume():
    want = _frame([True], [0.9, 0.5004, 0.1, 0.2, 0.7])
    got = _frame([True], [0.9, 0.4999, 0.6, 0.2, 0.1])
    c = compare.frame_counts(got, want, TOLS, level=0.5)
    # flipped: 0.5004 (a knife edge), 0.1 -> 0.6 and 0.7 -> 0.1
    assert c["sdf_bad"] == [2, 4]
    assert c["sdf_flip"] == pytest.approx(0.4)
    kept = {"valid": got["valid"], "depth": got["depth"],
            "inside": got["sdf"] > 0.5}
    assert compare.frame_counts(kept, want, TOLS, level=0.5)["sdf_bad"] == \
        [2, 4]
    assert "sdf_bad" not in compare.frame_counts(got, want, TOLS)


def test_nothing_to_count_reads_one():
    empty = _frame([False, False])
    want = _frame([True, True])
    frames = [compare.frame_counts(empty, want, TOLS)]
    shares = compare.pooled(frames)
    assert frames[0]["depth_bad"] == [0, 0]
    assert shares["depth_bad"] == 1.0 and shares["valid_disagree"] == 1.0
    ok, checks = compare.judge(shares, {"depth_bad": 0.5})
    assert not ok and checks["depth_bad"]["value"] == 1.0


@pytest.mark.parametrize("seconds,rate,frames,block", [
    (51, 43.0, 12, 32), (51, 85.0, 12, 32), (51, 5.8, 12, 19),
    (8, 5.8, 12, 3), (8, 60.0, 12, 32), (1.5, 2.0, 12, 1)])
def test_keep_block(seconds, rate, frames, block):
    b = cell.keep_block(seconds, rate, frames)
    assert b == block
    # a window at the rate keeps at least 1.25 x the frames checked, or
    # every frame
    assert b == 1 or math.floor(seconds * rate / b) >= 1.25 * frames


@pytest.mark.parametrize("rate", [30.0, 60.0, 90.0])
def test_real_time_windows_keep_their_frames(rate):
    """At the cells' 51 s and a real-time rate, the sample keeps one frame
    a block of 32 at the offsets the seed drew before the keep block was
    derived, and leaves the seed's generator where it left it."""
    seed = 2_147_483_659
    ns = types.SimpleNamespace(seed=seed, warm_rate=rate,
                               device=torch.device("cpu"),
                               limits={"frames": 12},
                               out_shapes={"valid": ((2,), torch.bool)})
    cell.Cell.prepare_sample(ns, 51.0)
    gc.unfreeze()
    rng = np.random.default_rng([seed, 1])
    blocks = math.ceil(51.0 * cell.MAX_FPS / 32) + 1
    before = {j * 32 + int(r): j for j, r in
              enumerate(rng.integers(32, size=blocks))}
    reached = 51.0 * 2 * rate
    slots = len(ns.slots)
    assert ns.keep == {i: j for i, j in before.items() if j < slots}
    assert all(i in ns.keep for i in before if i < reached)
    assert ns.check_rng.integers(1 << 30) == rng.integers(1 << 30)

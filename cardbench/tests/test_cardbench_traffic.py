"""The traffic generator: the same inputs from the same seed, others from
another; every seed runs the same poses."""

import numpy as np
import torch

from cardbench.harness import traffic
from cardbench.harness.manifest import Manifest

SEED = 2 ** 33 + 17


def _spec(name):
    spec = dict(Manifest.traffic(name))
    spec["bodies"] = 3
    return spec


def test_same_seed_same_inputs():
    for name in ("frontal", "orbit"):
        a = traffic.generate(_spec(name), SEED, 32, "cpu")
        b = traffic.generate(_spec(name), SEED, 32, "cpu")
        assert torch.equal(a.images, b.images)
        assert a.start == b.start
        assert all(np.array_equal(x, y) for x, y in zip(a.calibs, b.calibs))
        assert [a.frame(i) for i in range(300)] == [b.frame(i)
                                                   for i in range(300)]


def test_other_seed_other_bodies():
    a = traffic.generate(_spec("orbit"), SEED, 32, "cpu")
    b = traffic.generate(_spec("orbit"), SEED + 1, 32, "cpu")
    assert not torch.equal(a.images, b.images)
    # the same set of poses, in another order
    assert all(np.array_equal(x, y) for x, y in zip(a.calibs, b.calibs))


def test_bodies_are_subjects():
    t = traffic.generate(_spec("frontal"), SEED, 64, "cpu")
    share = (t.images.abs().sum(-1) > 0).float().mean(dim=(1, 2))
    assert bool(((share > 0.03) & (share < 0.6)).all()), share
    assert float(t.images.min()) >= -1.0 and float(t.images.max()) <= 1.0


def test_orbit_matches_the_demo_camera():
    from monoport_tpu_torch.pipeline.scene import load_intrinsic
    from monoport_tpu_torch.recon.calib import pifu_calib
    from monoport_tpu_torch.render.camera import orbit_extrinsic

    spec = _spec("orbit")
    t = traffic.generate(spec, SEED, 32, "cpu")
    cam = spec["camera"]
    assert len(t.calibs) == cam["poses"] == 120
    for k in (0, 1, 37, 119):
        want = pifu_calib(orbit_extrinsic(cam["yaw"], cam["pitch_step"] * k),
                          load_intrinsic())
        np.testing.assert_allclose(t.calibs[k], want, atol=1e-6)
    assert t.frame(0) == (0, t.start)
    assert t.frame(121) == (121 % 3, (t.start + 1) % 120)

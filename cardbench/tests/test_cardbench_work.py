"""The work counters against counts made by hand."""

import numpy as np
import pytest

from cardbench.harness import work
from cardbench.harness.manifest import Manifest


def _cfg(name):
    return Manifest().config(name)


def _conv(cin, cout, k, hw):
    return 2.0 * cin * cout * k * k * hw * hw


def _convblock(cin, cout, hw, project):
    f = (_conv(cin, cout // 2, 3, hw) + _conv(cout // 2, cout // 4, 3, hw)
         + _conv(cout // 4, cout // 4, 3, hw))
    return f + (_conv(cin, cout, 1, hw) if project else 0.0)


def hourglass_by_hand(size=512, stacks=4):
    f = _conv(3, 64, 7, size // 2)
    f += _convblock(64, 128, size // 2, True)
    q = size // 4
    f += _convblock(128, 128, q, False) + _convblock(128, 256, q, True)
    block = lambda hw: _convblock(256, 256, hw, False)  # noqa: E731
    for i in range(stacks):
        # depth 2: b1_2 at q; b2_2, b1_1, b3_2 at q/2; b2_1, b2_plus_1,
        # b3_1 at q/4; then top_m, conv_last, l (and bl, al between stacks)
        f += block(q) + 3 * block(q // 2) + 3 * block(q // 4)
        f += block(q) + 2 * _conv(256, 256, 1, q)
        if i < stacks - 1:
            f += 2 * _conv(256, 256, 1, q)
    return f


def resnet_by_hand(size=512):
    return (_conv(3, 64, 7, size) + _conv(64, 128, 3, size // 2)
            + _conv(128, 256, 3, size // 4) + 12 * _conv(256, 256, 3, size // 4))


def hrnet_small_v2_by_hand(size=512):
    hw = [size // 4, size // 8, size // 16, size // 32]
    f = _conv(3, 64, 3, size // 2) + _conv(64, 64, 3, size // 4)
    q = hw[0]
    # layer1: two bottlenecks (64 -> 256), the first with a projection
    f += (_conv(64, 64, 1, q) + _conv(64, 64, 3, q) + _conv(64, 256, 1, q)
          + _conv(64, 256, 1, q))
    f += _conv(256, 64, 1, q) + _conv(64, 64, 3, q) + _conv(64, 256, 1, q)
    chans = [18, 36, 72, 144]
    # transitions: stage 2 adapts branch 0 and spawns 1; stages 3, 4
    # spawn one each from the last branch
    f += _conv(256, 18, 3, q) + _conv(256, 36, 3, hw[1])
    f += _conv(36, 72, 3, hw[2]) + _conv(72, 144, 3, hw[3])
    for n, modules in ((2, 1), (3, 3), (4, 2)):
        for _ in range(modules):
            for i in range(n):          # two basic blocks a branch
                f += 4 * _conv(chans[i], chans[i], 3, hw[i])
            for i in range(n):
                for j in range(n):
                    if j > i:
                        f += _conv(chans[j], chans[i], 1, hw[j])
                    for k in range(i - j):
                        c_out = chans[i] if k == i - j - 1 else chans[j]
                        f += _conv(chans[j], c_out, 3, hw[j + k + 1])
    return f


@pytest.mark.parametrize("name,key,by_hand", [
    ("monoport-hg4-resnet", "netG", hourglass_by_hand),
    ("monoport-hg4-resnet", "netC", resnet_by_hand),
    ("monoport-hrnet-w18-small-v2", "netG", hrnet_small_v2_by_hand)])
def test_backbone_flops(name, key, by_hand):
    got = work.backbone_flops(_cfg(name)[key]["backbone"], 512)
    assert got == pytest.approx(by_hand(), rel=1e-12)


@pytest.mark.parametrize("name,bound_ms", [
    ("monoport-hg4-resnet", None), ("monoport-hrnet-w18-small-v2", None)])
def test_kernel1_bound(name, bound_ms):
    cfg = _cfg(name)
    launches = work.frontal_ray_launches(cfg)
    g = cfg["netG"]["head"]["widths"]
    # by hand: march 33^2 rays x 33 taps, 65^2 x 6, the 192^2 window x 6,
    # and netC's colour 192^2 x 1; each operations-bound at bf16
    want = [(g, 33 * 33, 33), (g, 65 * 65, 6), (g, 192 * 192, 6)]
    if "netC" in cfg:
        want.append(([513, 1024, 512, 256, 128, 3], 192 * 192, 1))
    assert launches == want
    total = 0.0
    for widths, rays, taps in want:
        c_f, outs = widths[0] - 1, widths[1:]
        macs = rays * c_f * sum(outs) + rays * taps * sum(
            a * b for a, b in zip(outs[:-1], outs[1:]))
        total += 2.0 * macs / 989e12
    got = sum(work.bound_s(work.ray_mlp_work(*x)) for x in launches)
    assert got == pytest.approx(total, rel=1e-12)
    if name == "monoport-hg4-resnet":
        # the frontal frame's kernel-1 bound of the kernel table in PERF.md
        assert got * 1e3 == pytest.approx(0.560, abs=5e-4)


def test_rotated_rows_follow_plan_and_hint():
    from cardbench.harness.traffic import orbit_calib

    cfg = _cfg("monoport-hg4-resnet")
    calib = orbit_calib(20.0, 0.0)
    low = work.frame_head_works(cfg, calib, 0.1)
    high = work.frame_head_works(cfg, calib, 0.6)
    assert len(low) == len(high) == 4   # march, two refines, colour
    # the march is per point over the 33^3 lattice, whatever the hint
    assert low[0] == high[0] == work.point_mlp_work(
        cfg["netG"]["head"]["widths"], 33 ** 3)
    # a hint of 0.1 snaps to the 0.25 rung, 0.6 to 0.625 (capped at 0.5)
    assert low[-1] == work.point_mlp_work(cfg["netC"]["head"]["widths"],
                                          int(np.ceil(192 * 192 * 0.25 / 256))
                                          * 256)
    assert high[-1][0] > low[-1][0]

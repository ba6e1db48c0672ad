"""PyTorch port, the f32 route's weight ring on the CPU: the tile streams
the packer keeps beside ``wf`` / ``wh`` (``fused_ray_mlp.f32_tiles``, the
order the block GEMM of ``csrc/mlp_tiles.cuh`` reads a pass's [K, width]
block in) invert to them, the column passes follow the kernel's rule, and
the shared-memory budget keeps every published head's activations in
shared memory. The kernels themselves run only on the card
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from monoport_tpu_torch.models.heads import SurfaceClassifier
from monoport_tpu_torch.ops.cuda import fused_mlp as tmlp
from monoport_tpu_torch.ops.cuda import fused_ray_mlp as tray

torch.set_num_threads(2)

# the netG and netC heads of the benchmark's four configurations: hg4 and
# hg4-quality (257 / 513 wide), Yolov4 (257 wide on out2), HRNet (271 wide,
# no netC)
PUBLISHED = {"netG": (257, 1024, 512, 256, 128, 1),
             "netC": (513, 1024, 512, 256, 128, 3),
             "hrnet": (271, 1024, 512, 256, 128, 1)}
HEADS = {**PUBLISHED,
         "wide": (257, 2048, 1024, 768, 128, 1),
         "wide_c": (97, 1536, 640, 64, 3),
         "narrow": (65, 96, 64, 48, 1)}
PACKS = {"ray": tray.pack_ray_mlp_params, "point": tmlp.pack_mlp_params}


def _head(chans) -> SurfaceClassifier:
    head = SurfaceClassifier(chans, last_op="sigmoid")
    rng = np.random.RandomState(len(chans) + chans[1])
    with torch.no_grad():
        for lin in head.layers():
            lin.weight.copy_(torch.from_numpy(
                rng.randn(*lin.weight.shape).astype(np.float32)))
    return head


@pytest.mark.parametrize("form", sorted(PACKS))
@pytest.mark.parametrize("name", sorted(HEADS))
def test_tile_streams_invert_to_wf_and_wh(name, form):
    """``wf_tiles`` is ``wf`` and ``wh_tiles`` every layer's W_h^T, layer
    after layer at ``wh``'s offsets, cut into passes and back: nothing
    missing, nothing added."""
    p = PACKS[form](_head(HEADS[name]), dtype=torch.float32)
    ntot = sum(p.widths[1:])
    assert p.wf_tiles.shape == (p.wf.numel(),)
    assert torch.equal(tray.f32_untile(p.wf_tiles, ntot, p.widths[0]), p.wf)
    assert p.wh_tiles.numel() == p.wh.numel()
    pos = 0
    for i in range(1, len(p.widths) - 1):
        n, k = p.widths[i + 1], p.widths[i]
        assert torch.equal(
            tray.f32_untile(p.wh_tiles[pos:pos + n * k], n, k),
            p.wh_layer(i))
        pos += n * k
    # a pass's block is k-major: its first k-row is the pass's columns at
    # k = 0, what one ring stage starts with
    (n0, nt), = tray.f32_passes(ntot)[:1]
    assert torch.equal(p.wf_tiles[:nt], p.wf[n0:n0 + nt, 0])


def test_bf16_packs_keep_no_tile_stream():
    p = tray.pack_ray_mlp_params(_head(PUBLISHED["netG"]))
    assert p.wf_tiles is None and p.wh_tiles is None
    assert p.anchor.wf_tiles is None
    assert tmlp.pack_mlp_params(_head(PUBLISHED["netG"])).wf_tiles is None


@pytest.mark.parametrize("n, passes", [
    (32, [32]), (96, [32, 32, 32]), (128, [128]), (288, [256, 32]),
    (512, [512]), (1024, [512, 512]), (1952, [512, 512, 512, 256, 128, 32]),
    (2272, [512] * 4 + [128, 32, 32, 32])])
def test_passes_take_the_widest_width_that_fits(n, passes):
    got = tray.f32_passes(n)
    assert [w for _, w in got] == passes
    assert [c for c, _ in got] == list(np.cumsum([0] + passes[:-1]))


@pytest.mark.parametrize("name", sorted(HEADS))
def test_published_heads_keep_activations_in_shared_memory(name):
    """Under the retiled core's budget (the 32,832-byte ring, both
    activation buffers, the row terms at 8 anchors) every netG and netC
    head of the benchmark's configurations fits the 232,448 bytes a block
    may opt into; a 2048-1024 head does not and keeps its activations in
    device memory."""
    for form, pack in PACKS.items():
        p = pack(_head(HEADS[name]), dtype=torch.float32)
        assert p.f32_scratch == (name in ("wide", "wide_c")), (name, form)
    if name in PUBLISHED:
        p = tray.pack_ray_mlp_params(_head(HEADS[name]), dtype=torch.float32)
        assert tray.f32_layer_smem(p.widths) == 230_720
        assert tray.f32_layer_smem(p.widths) <= tray.SMEM_OPTIN

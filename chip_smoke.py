"""Card check of the PyTorch port: build, kernel parity, full-width frame.

    python3 chip_smoke.py

Needs one CUDA card and the repository checkout around this file; exits
non-zero, printing no result, without either. Phases (one JSON line each):

1. device: the card's name and power limit (nvidia-smi) and versions;
2. build: compiles every kernel source of the checkout, one compiler a
   source, all started together, each timed;
3. kernel: each of the four kernels against its plain version on the
   card, at every shape a frame of phases 4-8 or the gather A/B launches
   it on (the hierarchy levels' come from ``frame_check``'s budgets), in
   bf16 and f32, with the device code's route, the maximum and the 99.9th
   percentile of the error, times (CUDA events) and the bound (the larger
   of operations over the card's peak for their type and bytes over its
   memory rate, H100 SXM data-sheet peaks); every bf16 row runs the one
   wgmma kernel (csrc/wgmma_mlp.cuh) and also times its ring alone
   (``stream_*wgmma``: the L2 floor of its tiling) and gives the L2 read
   rate that implies; the ray, anchored and gathering rows give the
   operations the kernel does over those of the bound (``recompute``: the
   ray kernel projects the feature again for every tap, the anchored route
   each tap's mixed row); the bf16 anchored and gathering rows also time
   their weighted-row pass (csrc/mix_rows.cuh) beside its byte bound and
   the wgmma launch alone, and hold the pass to ``mix_rows_plain`` (equal
   or one bf16 ulp apart, the differing elements counted); the last rows
   run kernel 2's view-pooled form (``fused_mlp.apply_mlp_views``, f32
   only) on the committed netG's head at phase 21's levels, 4 views a
   point, against ``apply_mlp_views_plain``;
4. frame: the committed netG + netC at full width through ReconEngine at
   the real-time operating point, bf16, a few frontal frames timed; the
   launch counts are zeroed just before and read just after, and must be
   exactly 4 ray-MLP launches a frame and no other; no stream sync inside
   a frame; the profile; the last bf16 frame and then one f32 frame are
   held to the JAX golden (f32) at ``frame_check``'s limits;
5. rotated frame: the same engines on the orbit camera's calib
   (``frame_check.rotated_calib``): the counts zeroed and read again and
   held to what the pose's anchor plan implies (the per-point MLP once
   for the march and once for each per-point refine level, the anchored
   MLP once for each anchored level, the ray MLP never), no stream sync,
   a frame with a ``compact_hint`` held to the plain frame where nothing
   dropped, the profile (in bf16 one weighted-row pass and one wgmma
   launch of the anchored epilogue for each anchored level, no FMA-route
   kernel), and the bf16 and f32 frames held to the rotated JAX golden;
6. dense frame: the same nets under ``frame_check.quality_config``
   (``mode='dense'``, the 257^3 hierarchy), frontal calib, bf16 timed and
   f32 once: the per-point MLP once for every hierarchy level and the ray
   MLP once for the frontal colour, no stream sync, ``recon_counts``
   against the budgets (``band_report``), the profile (one wgmma kernel a
   per-point call and one for the ray MLP's colour call; in one profiled
   f32 frame the FMA route's projection and layer chunks), the frames held
   to the dense JAX golden, its subsampled ``sdf`` and ``recon_counts``
   included, and to the same frames run through the plain versions of the
   kernels on the card (f32: ``recon_counts`` equal);
7. mesh: ``extract_mesh`` of the f32 dense frame's ``sdf``: counts, and
   every edge away from the volume's border shared by two faces;
8. hierarchy frame: the rotated calib under the real-time engine with
   ``rotated.march=False`` (hierarchy 17, 33, 65, then ``ray_refine``):
   the per-point MLP once a level, the anchored MLP as the pose's plan
   says, no stream sync, the profile (as the rotated frame's, and no ray
   MLP), held to the same frame run through the plain
   versions of the kernels on the card, bf16 and f32 (f32:
   ``recon_counts`` and ``compact_dropped`` equal);
9. frames: a clip of two frontal frames and a rotated one through
   ``frames()``; each output equals the ``frame()`` of that input;
10. gather A/B: ``profile_gather.run``, the gathering kernel's entry
    point: ``index`` -> ray MLP, the gather inside the kernel, and the
    ``index_grid`` lattice -> ray MLP at two frame shapes;
11. serve: the demo server, ``apps/rtl_main`` at its default profile
    (committed netG + netC in bf16, MatteNet and DetectNet loaded, not the
    box prior), an MJPEG server on 127.0.0.1 (port 0), ``main_loop`` over
    ``SERVE_FRAMES`` copies of the serve golden's raw frame held in memory
    (the orbit camera's AUTO poses): the launch counts zeroed just before
    and read just after, held to what each served pose's anchor plan
    implies; no stream sync in the device stage; ``/`` and two
    ``/video_feed`` parts fetched with the standard library (SOI, EOI, a
    256x256 SOF0 each); the first served frame's packed display held to
    the serve golden at the rotated bf16 limits (one uint8 step wider) and
    the card's matte within 2e-2 of the golden's; served frames a second,
    the stages' ms, the JPEG encoder's ms; then ``apps/infer``'s
    ``reconstruct_image`` on the same frame: faces, closed share, seconds;
12. backbones: the committed netG and netC written as legacy PIFu files
    (reference key names, ``tests/torch_reference_state.py``) and read by
    ``rtl_main.load_networks``: every tensor equal to the committed nets',
    their bf16 frontal frame equal to phase 4's; then the alternative
    netGs (``ALT_NETGS``: HRNetV2_W18_small_v2_balance_last, the
    multi-level HRNetV2_W18_small_v2 with a 271-wide head, Yolov4Filters;
    BatchNorm, numpy-seeded weights) saved as reference-layout checkpoints
    and read with ``norm: batch`` (no netC, as the app loads none for
    them): the f32 backbone against the JAX golden
    (``frame_check.compare_backbone``), bf16 frontal frames timed (the
    counts zeroed and read again: the ray MLP for the march and each
    refine, no other kernel, no stream sync), the profile, the backbone's
    device ms beside the committed HGFilter's, and an f32 and the bf16
    frame held to the f32 frame through the plain kernels on the card.
    The kernel phase's rows after those of the frames run kernels 1-3 on a
    seeded 271-wide head, then kernel 2 on the seeded soft-onehot head
    (input 320) at phase 14's shapes, and last kernels 2 and 3 at phase
    17's rotated 129 profile and kernel 2 on a seeded copy of
    ``demo_synthetic``'s 129-wide head at its hierarchy's levels;
13. train (f32, TF32 off): one full-width train step of the committed
    netG (Adam on the capsule app's cosine schedule) and netC (netG's
    feature prior, the global-norm clip, Adam) on the batches of
    ``data/train_golden.npz``: the loss, each gradient leaf's norm and
    projection, and three steps' losses held to the JAX package's at
    ``TRAIN_LIMITS``; ``apps.train_capsule_netG`` for ``TRAIN_STEPS``
    steps from the committed netG at 512^2 (steps a second from CUDA
    events, the median of the chunks; peak memory; the chunks' losses,
    finite; the held-out IOU; none of our kernels launched), that
    checkpoint beside the committed netG (the app's held-out point IOU and
    ``apps.eval_netg``'s silhouette IOUs, bf16), one profiled
    step (device idle share, host syncs of the step and of the batch
    draw: none), the saved npz with the committed netC through
    ``ReconEngine`` (bf16 frontal frames: exactly 4 ray-MLP launches each,
    the counts zeroed and read as phase 4's, no sync), 5 steps of
    ``apps.train_capsule_netC --mixed 1``; ``apps.train`` (the Trainer) for
    one epoch, its checkpoint resumed with every optimizer tensor, the
    step, epoch and iteration equal to the saved ones, and one more epoch;
14. softonehot (run after phase 9): a numpy-seeded soft-onehot netG at
    full width (the committed netG's architecture, 64 soft-onehot z bins,
    head 320-1024-512-256-128-1; ``tests/torch_reference_state.py``) with
    the committed netC at the real-time operating point. A soft-onehot net
    takes no ray, grid or anchored query: the frontal frame runs the
    hierarchy and a per-point refine (the per-point MLP once a level and
    once for the refine, the ray MLP once for netC's colour), the rotated
    frame a per-point march and per-point refines (the per-point MLP once
    each); bf16 frames timed with the counts zeroed and read around them,
    no stream sync; the bf16 and f32 frames of each view held to the same
    frame through the plain kernels on the card; the f32 frontal frame
    held to the JAX golden (``data/frame_golden_softonehot.npz``,
    ``frame_check.F32_SOFT_LIMITS``, its volume and ``recon_counts``);
15. train_perception (f32, TF32 off, last): one step of the committed
    MatteNet (256^2, batch 8) and DetectNet (512^2, batch 2) with the
    apps' Adam on the golden's batches: the loss, each gradient leaf's
    norm and projection, three steps' losses against
    ``data/perception_train_golden.npz`` at ``PERCEPTION_LIMITS``; no host
    sync in a step or a draw of either; ``apps.train_matting`` and
    ``apps.train_detection`` at their defaults cut to
    ``PERCEPTION_STEPS`` steps: steps a second (CUDA events, the median of
    the chunks), peak memory, the chunks' losses (finite), the held-out
    alpha IOU / box IOU, precision and recall, none of our kernels
    launched.

16. sharded (run after phase 13, whose training apps have set cuDNN's
    timed algorithms: an f32 netG step on cuDNN's heuristic picks takes
    seconds, and a shape keeps its first pick): the engine's ``mesh=`` and
    the data-parallel step. (a) A world of one rank on NCCL (a file store in a
    temporary directory): the bf16 frontal and rotated frames of the
    real-time engine on ``make_mesh(1)``, timed with the counts zeroed and
    read around them (phases 4 and 5's launches), no stream sync,
    bit-equal to the frames without a mesh; one phase-13 netG step (SGD,
    f32) on that mesh against the step without one (bit-equal, or where
    two plain steps differ too, within the sharded step's tolerance). (b)
    Two ranks on the one card over gloo (``torch.multiprocessing``
    spawn), each with the committed nets in the bf16 real-time engine on a
    ``points`` mesh of 2: every kernel call of the unsharded frame, sharded
    over the mesh, bit-equal to the unsharded call; the frontal and
    rotated frames within ``frame_check.BF16_LIMITS`` of the single-card
    frame (the largest differences printed), ``compact_dropped`` equal;
    each rank's launches those of phases 4 and 5; then one f32 step
    (TF32 off) of the phase-13 netG on its batch and of a small
    ``batch_train`` netG on a ``data`` mesh of 2, held to the single-card
    step on the same global batch (loss 1e-6, parameters and running
    stats atol 5e-5 / rtol 5e-3, the JAX package's sharded-step
    tolerance), the ranks' parameters and running stats equal. The times
    (frame ms a rank, step ms) on a line of their own with the card: two
    gloo ranks sharing one card are a correctness run, no scaling figure.

17. quality (last; ``torch.backends.cudnn.benchmark`` pinned to True for
    the whole phase and printed): reconstruction quality against the
    ground truth through ``monoport_tpu_torch/evaluate.py`` on the
    committed nets and the JAX package's held-out bodies
    (``data/eval_golden.npz``), 512^2 renders, nothing cut. (a) The bench
    profile on body 31337: ``bench_real``'s four quality keys in bf16
    through the kernels (launches counted: the frame's 4 ray-MLP, the
    dense oracle's 5 per-point) and in f32 through the plain versions on
    the card; the f32 keys held to the JAX f32 golden (``QUALITY_LIMITS``:
    IOU 0.005, PSNR 0.2 dB, the depth median 2e-3 voxels, the silhouette
    within ``F32_LIMITS``'s disagreement), the bf16 keys to the f32 ones
    (IOU 0.01, PSNR 0.5 dB, depth 0.6 voxels); eval_netg's IOU and
    eval_netc's PSNR on seeds 31337, 4242 and 777 in bf16, held to the
    JAX f32 golden at the bf16 bounds. (b) Cross-family (seed 31337): at
    129 in f32 through the plain versions each family's IOU and PSNR
    within the f32 bounds of the golden, its silhouette within
    ``F32_LIMITS``; at 257 in bf16 the readings printed beside the JAX
    test's gates (set at 129: not enforced). (c) Rotated anchored: the
    four orbit poses in bf16 (launches held to each pose's anchor plan;
    no stream sync in a frame of each mode) and in f32 through the plain
    versions, each IOU key within 0.005 and each MAD key within 1e-3 of
    the golden, plans and dropped rays equal.
    (d) ``apps.demo_synthetic`` for 300 steps: finite losses, a non-empty
    mesh, the training scene's IOU at least the held-out one's, steps a
    second (the host's numpy scene draws included), the per-point MLP
    once a hierarchy level of its two frames (f32).

18. wide_head (after phase 14): a netG whose head the in-place bf16
    kernel cannot hold (``tests/torch_reference_state.wide_netg``: the
    committed HGFilter under a numpy-seeded ``WIDE_NETG_HEAD``
    257-2048-1024-768-128-1 head) with the committed netC: the bf16
    kernels in their scratch mode, the f32 route with its activations in
    device memory. Frontal, rotated and dense frames, bf16 timed with the
    counts zeroed and read around them (phases 4-6's launches), no stream
    sync, each frame in bf16 and f32 held to the same frame through the
    plain kernels on the card at the view's ``frame_check`` limits (f32:
    ``recon_counts`` / ``compact_dropped`` equal); then the committed
    netG's head forced into both scratch modes, bit-equal to in place. The
    kernel phase's rows after phase 17's run kernels 1-4 at this head at
    every shape its frames and the gather A/B launch (each row names its
    mode), and the gather A/B runs it too. Its outputs sit on the
    sigmoid's tails, so the rows after those run kernels 1-4 on a head of
    the same widths whose seeded weights keep at least half the outputs
    off the tails (``unsaturated_share``), at the bf16 tolerance. Every
    bf16 row of the published heads on the frames' path is also timed
    forced into the scratch mode and then in place again
    (``scratch_ms``, ``in_place_ms_after``; outputs bit-equal).
19. train_ppl (after phase 13): ``apps.train_ppl --recipe r5`` cut to 2
    subjects x 4 rotations, 3 + 12 epochs with phase C resumed after its
    sixth, in a process of its own session with a time limit (a hung
    loader worker fails the phase): losses finite and falling, the resume
    exact, none of our kernels launched in a step, the trained nets' bf16
    frame exactly 4 ray-MLP launches.
20. graphs (after phase 5): the backbone calls and the march pyramid's
    stages replayed from CUDA graphs (``frame_graphs``), on the committed
    hg4 nets and the seeded multi-level HRNet netG of phase 12, each in a
    bf16 real-time engine of its own (``frame_check.replay_check``):
    frontal frames of the golden image, its mirror and the image again,
    each graphed call (netG; netC over the prior it was given; each stage
    over the maps and calib it was given) bit-equal to the eager call on
    its inputs; then twice over, the golden image and its mirror at each
    march path (the frontal grid, the in-plane ray taps, the rotated pose
    at each rung under the 0.5 ceiling), each frame bit-equal to the same
    frame with the graphs off, each returned depth and valid unchanged
    after the next frame; one capture a signature; no stream sync in a
    replaying frame. Phase 11 also holds the served engine's backbone
    calls to one capture a signature and replays after, and its stages to
    one a key (the capture runs in the device stage's thread).
21. views (after phase 6): PIFu's multi-view netG (``num_views`` 4: the
    committed netG's weights under the view pooling, the benchmark's
    hg4-mv4-dense deployment) on the f32 dense frame (TF32 off,
    ``frame_check.quality_config``, no netC), one capsule body
    (``evaluate.BENCH_SEED``) rendered at 512^2 by a ring of four
    orthographic cameras at yaw 0, 90, 180 and 270 degrees (view 0 the
    identity): frames timed with the counts zeroed just before and read
    just after (the per-point MLP once a hierarchy level, no other
    kernel), no stream sync, ``recon_counts`` within the budgets, peak
    memory, the profile (a projection and a view-pooled layer launch a
    chunk of every level; no other MLP kernel), the frame held to the same
    frame through the plain kernels on the card (``recon_counts`` equal,
    the volume within 2e-3), and a line summing the kernel phase's
    view-pooled rows over the frame's levels (ms, plain ms, bound ms).

Then the kernels line (four kernels), the card line, and last the result
line. Any failed check raises, and the script exits non-zero.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join("monoport_tpu_torch", "csrc")
F32_FMA_PEAK = 67e12
# anchors a ray of the hierarchy frame's refine (65 -> 257 at the rotated
# pose): the kernel phase measures the anchored MLP there, and the hierarchy
# phase fails if the pose's plan says otherwise
HIERARCHY_ANCHORS = 3

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, f32 without them,
# HBM3 bandwidth
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
PEAK_BYTES = 3.35e12
TOL = {"f32": {"atol": 2e-5, "rtol": 1e-4}, "bf16": {"atol": 2e-2, "rtol": 0.0}}
FRAMES = 5
# the device code behind each kernel and dtype: the bf16 routes of the ray
# and per-point MLPs are the wgmma kernel (csrc/wgmma_mlp.cuh), those of the
# anchored and gathering MLPs the weighted-row pass (csrc/mix_rows.cuh) and
# the wgmma kernel; every f32 row runs csrc/mlp_tiles.cuh (plain FMA)
ROUTES = {("fused_ray_mlp", "bf16"): "sm90_wgmma",
          ("fused_mlp", "bf16"): "sm90_wgmma",
          ("fused_anchor_mlp", "bf16"): "sm90_mix_wgmma",
          ("fused_gather_mlp", "bf16"): "sm90_mix_wgmma"}
# frames the serve phase streams through the demo's pipeline
SERVE_FRAMES = 8
# PIFu's multi-view netG of phase 21 (the hg4-mv4-dense cell's): its views
# a subject and the ring's camera yaws, degrees about the vertical axis
VIEWS = 4
RING_YAWS = (0.0, 90.0, 180.0, 270.0)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _head_dims(head):
    layers = head.layers()
    outs = [lin.weight.shape[0] for lin in layers]
    return layers[0].weight.shape[1], outs, sum(
        lin.weight.numel() for lin in layers)


def ray_mlp_work(head, rays: int, taps: int, dtype: str, anchors: int = 1,
                 mixed: bool = False):
    """(seconds of operations at the card's peaks, bytes) the ray MLP
    (``anchors`` = 1) or the anchored MLP (``mixed``) must do for rays x
    taps at the head's unpadded widths: W_f once per ray and anchor, the
    hidden products per tap, and the K-term hat mix per tap and column as
    f32 multiply-adds."""
    c_in, outs, n_params = _head_dims(head)
    c_f = c_in - 1
    mac_ray = anchors * c_f * sum(outs)
    mac_tap = sum(a * b for a, b in zip(outs[:-1], outs[1:]))
    flops = 2.0 * (rays * mac_ray + rays * taps * mac_tap)
    mix = 2.0 * rays * taps * anchors * sum(outs) if mixed else 0.0
    op = 2 if dtype == "bf16" else 4
    nbytes = (rays * anchors * c_f * op + rays * taps * 4
              + (rays * taps * anchors * 4 if mixed else 0) + n_params * op
              + rays * taps * outs[-1] * 4)
    return flops + mix, flops / PEAK_FLOPS[dtype] + mix / F32_FMA_PEAK, nbytes


def ray_recompute(head, taps: int) -> float:
    """The multiply-adds the ray MLP's wgmma kernel does over those of
    ``ray_mlp_work``: it projects the feature again for every tap."""
    c_in, outs, _ = _head_dims(head)
    mac_ray = (c_in - 1) * sum(outs)
    mac_tap = sum(a * b for a, b in zip(outs[:-1], outs[1:]))
    return taps * (mac_ray + mac_tap) / (mac_ray + taps * mac_tap)


def anchor_recompute(head, taps: int, anchors: int) -> float:
    """The multiply-adds the anchored MLP's bf16 route does over those of
    ``ray_mlp_work``: T (2 c_f sum(O) + M_tap) against K c_f sum(O) + T
    M_tap (each tap's mixed row is projected, as hi and lo halves, not
    each anchor once)."""
    c_in, outs, _ = _head_dims(head)
    mac_ray = (c_in - 1) * sum(outs)
    mac_tap = sum(a * b for a, b in zip(outs[:-1], outs[1:]))
    return taps * (2 * mac_ray + mac_tap) / (anchors * mac_ray
                                             + taps * mac_tap)


def bf16_ulps(a, b):
    """Distance of two bf16 tensors in units in the last place (+0 and -0
    equal)."""
    import torch

    def key(t):
        bits = t.contiguous().view(torch.int16).int()
        mag = bits & 0x7FFF
        return torch.where(bits < 0, -mag, mag)
    return (key(a) - key(b)).abs()


def mix_phase(kernel, p, args, reps: int) -> dict:
    """The bf16 anchored or gathering route's pieces at one row's inputs:
    the weighted-row pass against ``mix_rows_plain`` on the card (bf16 ulps
    apart, the differing elements counted), its time and byte bound (the
    table rows a non-zero weight touches, the weights, the indices and its
    output, each once), the wgmma launch alone and its ring alone."""
    import torch

    from monoport_tpu_torch.ops.cuda import fused_gather_mlp as tgather
    from monoport_tpu_torch.ops.cuda import fused_ray_mlp as tray
    from monoport_tpu_torch.ops.cuda import mix_rows, wgmma

    if kernel == "fused_anchor_mlp":
        feat_k, w, z = args
        _, rays, taps, k = w.shape
        table = tray.anchor_table(p, feat_k)
        wk = w.reshape(-1, k).contiguous()
        zr = z.reshape(-1, 1).contiguous()
        idx = None
        mix = lambda: tray.mix_anchor_rows(p, table, wk, taps)
        mlp = lambda x: tray.launch_anchor_wgmma(p, x, zr)
        stream = lambda x: tray.stream_anchor_wgmma(p, x, zr)
        rows_read = int((w[0] != 0).any(dim=1).sum().item())
        streamed = wgmma.streamed_bytes(p.anchor, rays * taps, 1)
    else:
        fmap, uv, z = args
        _, h, wd, _ = fmap.shape
        rays, taps = z.shape[1:]
        table = tgather._table(p, fmap)[0]
        idx, wk = tgather.bilinear_taps(uv, h, wd)
        idx, wk = idx.reshape(rays, 4).contiguous(), wk.reshape(
            rays, 4).contiguous()
        zr = z.reshape(rays, taps).contiguous()
        mix = lambda: tgather.mix_gather_rows(p, table, idx, wk)
        mlp = lambda x: tray.launch_ray_wgmma(p, x, zr)
        stream = lambda x: tray.stream_ray_wgmma(p, x, zr)
        rows_read = int(torch.unique(idx[wk != 0]).numel())
        streamed = wgmma.streamed_bytes(p, rays, taps)
    x = mix()
    want = mix_rows.mix_rows_plain(table, wk, idx=idx, taps=taps,
                                   c_pad=p.widths[0], split=idx is None)
    torch.cuda.synchronize()
    ulps = bf16_ulps(x, want)
    nbytes = (rows_read * table.shape[1] * 2 + wk.numel() * 4
              + (idx.numel() * 4 if idx is not None else 0) + x.numel() * 2)
    ms_stream = cuda_ms(lambda: stream(x), reps)
    return {"mix_ms": cuda_ms(mix, reps), "mix_bytes": nbytes,
            "mix_bound_ms": nbytes / PEAK_BYTES * 1e3,
            "mix_max_ulps": int(ulps.max().item()),
            "mix_elements_differing": int((ulps > 0).sum().item()),
            "mix_elements": ulps.numel(),
            "mixed_rows_mb": x.numel() * 2 / 1e6,
            "wgmma_ms": cuda_ms(lambda: mlp(x), reps),
            "l2_floor_ms": ms_stream,
            "l2_read_tb_s": streamed / ms_stream / 1e9}


def point_mlp_work(head, points: int, dtype: str):
    """The same for the per-point MLP: every layer's W_x x and W_h h per
    point."""
    c_in, outs, n_params = _head_dims(head)
    mac = c_in * outs[0] + sum((a + c_in) * b
                               for a, b in zip(outs[:-1], outs[1:]))
    flops = 2.0 * points * mac
    op = 2 if dtype == "bf16" else 4
    nbytes = points * c_in * op + n_params * op + points * outs[-1] * 4
    return flops, flops / PEAK_FLOPS[dtype], nbytes


def views_mlp_work(head, points: int, views: int):
    """The same for the view-pooled per-point MLP (f32): the layers up to
    the pool (``n_layers // 2``) once a view, the later layers once a
    point; the bytes are every view's input row, the weights and the
    output, each once."""
    c_in, outs, n_params = _head_dims(head)
    ins = [c_in] + [o + c_in for o in outs[:-1]]
    pool = len(outs) // 2
    per_view = sum(i * o for i, o in zip(ins[:pool + 1], outs[:pool + 1]))
    pooled = sum(i * o for i, o in zip(ins[pool + 1:], outs[pool + 1:]))
    flops = 2.0 * points * (views * per_view + pooled)
    nbytes = points * views * c_in * 4 + n_params * 4 + points * outs[-1] * 4
    return flops, flops / PEAK_FLOPS["f32"], nbytes


def views_recompute(head, views: int) -> float:
    """The view-pooled kernel's operations over those of its bound: it
    projects every view's row for every layer (the later layers take the
    views' mean projection), the bound each pooled layer's once."""
    c_in, outs, _ = _head_dims(head)
    pool = len(outs) // 2
    hidden = [a * b for a, b in zip(outs[:-1], outs[1:])]
    done = (views * c_in * sum(outs) + views * sum(hidden[:pool])
            + sum(hidden[pool:]))
    return 2.0 * done / views_mlp_work(head, 1, views)[0]


def gather_mlp_work(head, rays: int, taps: int, dtype: str, map_shape):
    """The same for the gathering ray MLP: the ray MLP's operations plus
    the 4-tap f32 combine of every ray's feature row; the bytes are the
    f32 map, uv, z, the weights and the output, each once (the gathered
    rows never reach device memory)."""
    c_in, outs, n_params = _head_dims(head)
    flops, t_ops, _ = ray_mlp_work(head, rays, taps, dtype)
    combine = 2.0 * rays * 4 * (c_in - 1)
    op = 2 if dtype == "bf16" else 4
    nbytes = (4 * map_shape[1] * map_shape[2] * (c_in - 1) + rays * 2 * 4
              + rays * taps * 4 + n_params * op + rays * taps * outs[-1] * 4)
    return flops + combine, t_ops + combine / F32_FMA_PEAK, nbytes


def hat_weights(rng, rays: int, taps: int, anchors: int):
    """Real hat weights [1, rays, taps, anchors]: each tap's two
    neighbouring anchors, summing to 1."""
    import numpy as np

    alpha = np.sort(rng.rand(1, rays, taps).astype(np.float32), axis=-1)
    pos = alpha[..., None] * (anchors - 1) - np.arange(anchors,
                                                       dtype=np.float32)
    return np.maximum(0.0, 1.0 - np.abs(pos)).astype(np.float32)


def reference_helper():
    """``tests/torch_reference_state.py`` of the checkout: seeded weights
    and reference-layout (PIFu) checkpoints, without JAX."""
    tests = os.path.join(ROOT, "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_reference_state
    return torch_reference_state


def wide_head_net():
    """The multi-level HRNet netG's numpy-seeded 271-1024-512-256-128-1
    occupancy head (phase 12's, ``alt_netg_state``) on the card, as a net
    the kernel phase packs."""
    import types

    from monoport_tpu_torch.models.heads.surface_classifier import (
        SurfaceClassifier)

    state = reference_helper().alt_netg_state("HRNetV2_W18_small_v2")
    head = SurfaceClassifier((271, 1024, 512, 256, 128, 1), "sigmoid")
    head.load_state_dict({k.split(".", 1)[1]: v for k, v in state.items()
                          if k.startswith("surface_classifier.")})
    return types.SimpleNamespace(surface_classifier=head.cuda().eval())


def seeded_head_net(chans, seed: int, bias_sd: float = 0.0):
    """A sigmoid occupancy head of widths ``chans`` with numpy-seeded
    weights (a normal scaled by the fan-in's root; biases a normal times
    ``bias_sd``, zero at 0) on the card, as a net the kernel phase packs."""
    import types

    import numpy as np
    import torch

    from monoport_tpu_torch.models.heads.surface_classifier import (
        SurfaceClassifier)

    head = SurfaceClassifier(chans, "sigmoid")
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for lin in head.layers():
            fan_in = lin.weight.shape[1]
            lin.weight.copy_(torch.from_numpy(rng.randn(
                *lin.weight.shape).astype(np.float32) / np.sqrt(fan_in)))
            if bias_sd:
                lin.bias.copy_(torch.from_numpy(rng.randn(
                    *lin.bias.shape).astype(np.float32) * bias_sd))
            else:
                lin.bias.zero_()
    return types.SimpleNamespace(surface_classifier=head.cuda().eval())


@contextlib.contextmanager
def forced_scratch():
    """Every head into the scratch modes, as a wide head runs: the bf16
    wgmma kernel's device-memory h and the f32 kernel's device-memory
    activations."""
    from monoport_tpu_torch.ops.cuda import fused_ray_mlp as tray
    from monoport_tpu_torch.ops.cuda import wgmma

    real = (wgmma.needs_scratch, tray.RayMlpPacked.f32_scratch)
    try:
        wgmma.needs_scratch = lambda widths: True
        tray.RayMlpPacked.f32_scratch = property(lambda self: True)
        yield
    finally:
        wgmma.needs_scratch, tray.RayMlpPacked.f32_scratch = real


def soft_rows(rng, rays: int):
    """Inputs of the soft-onehot head [1, rays, 320]: 256 normal feature
    channels and the soft-onehot bins of a depth uniform in [-0.4, 0.4]
    (where the seeded head's logit is not saturated)."""
    import numpy as np
    import torch

    from monoport_tpu_torch.models.normalizers.depth_normalizer import (
        DepthNormalizer)

    z = torch.from_numpy(rng.uniform(-0.4, 0.4, (1, rays, 1)).astype(
        np.float32))
    bins = DepthNormalizer(soft_onehot=True,
                           soft_dim=reference_helper().SOFT_DIM)(z)
    feat = torch.from_numpy(rng.randn(1, rays, 256).astype(np.float32))
    return torch.cat([feat, bins], dim=-1).cuda()


def kernel_phase(netG, netC, soft, tray, tmlp, tgather):
    """Every kernel vs its plain version at the shapes of the frames, the
    hierarchy levels and the gather A/B."""
    import numpy as np
    import torch

    from monoport_tpu_torch import frame_check, profile_gather
    from monoport_tpu_torch.ops.cuda import wgmma

    # a hierarchy queries its coarsest lattice whole, then a budget a level
    levels = set()
    for recon in (frame_check.rtl_config()[0],
                  frame_check.quality_config()[0]):
        levels |= {recon.resolutions[0] ** 3, *recon.budgets[1:]}
    fine = frame_check.QUALITY_RESOLUTIONS[-1]
    # (kernel, shape name, net, rays or points, taps, anchors)
    shapes = [("fused_ray_mlp", "march", netG, 33 * 33, 33, 1),
              ("fused_ray_mlp", "refine65", netG, 65 * 65, 6, 1),
              ("fused_ray_mlp", "refine257", netG, 192 * 192, 6, 1),
              ("fused_ray_mlp", "colour", netC, 192 * 192, 1, 1),
              ("fused_mlp", "march", netG, 33 ** 3, 1, 1),
              ("fused_mlp", "refine65_points", netG, 2304 * 6, 1, 1),
              ("fused_mlp", "colour_points", netC, 18432, 1, 1),
              ("fused_anchor_mlp", "refine65", netG, 2304, 6, 5),
              ("fused_anchor_mlp", "refine257", netG, 18432, 6, 3),
              ("fused_mlp", "coarse_4913", netG, 17 ** 3, 1, 1),
              ("fused_mlp", "level_16384", netG, 16384, 1, 1),
              ("fused_mlp", "level_262144", netG, 262144, 1, 1)]
    shapes += [("fused_gather_mlp", name, netG, rays, taps, 1)
               for name, rays, taps in profile_gather.SHAPES]
    # a row's inputs are seeded by its place in the list: new rows go at the
    # end, so that earlier rows keep their inputs and their errors compare
    # from run to run. Every hierarchy level not yet in the list gets a row.
    shapes += [("fused_ray_mlp", "colour_dense", netC, fine * fine, 1, 1),
               ("fused_anchor_mlp", "refine257_window", netG, 192 * 192, 6,
                HIERARCHY_ANCHORS)]
    have = {s[3] for s in shapes if s[0] == "fused_mlp" and s[2] is netG}
    shapes += [("fused_mlp", f"level_{n}", netG, n, 1, 1)
               for n in sorted(levels - have)]
    # the multi-level HRNet netG's head (input 271: 270 feature channels,
    # padded to 288 in the kernels) at the frontal refine 257 and the
    # hierarchy's anchored refine 257
    wide = wide_head_net()
    shapes += [("fused_ray_mlp", "refine257_c271", wide, 192 * 192, 6, 1),
               ("fused_mlp", "refine257_points_c271", wide, 192 * 192 * 6,
                1, 1),
               ("fused_anchor_mlp", "refine257_window_c271", wide, 192 * 192,
                6, HIERARCHY_ANCHORS)]
    # the soft-onehot netG's head (input 320: 256 feature channels and 64
    # z bins), per point, as its frames launch it (phase softonehot): the
    # real-time hierarchy's largest level, the rotated march and the
    # frontal per-point refine over the 192^2 window
    shapes += [("fused_mlp", "level_16384_c320", soft, 16384, 1, 1),
               ("fused_mlp", "march_c320", soft, 33 ** 3, 1, 1),
               ("fused_mlp", "refine257_points_c320", soft, 192 * 192 * 6,
                1, 1)]
    # phase 17 (quality): eval_rotated_anchored's 129 profile (its refines
    # of 768 and 5,888 compacted rays, per point or with 3 anchors) and
    # demo_synthetic's 129-256-128-1 head (numpy-seeded here) at its
    # hierarchy's levels
    shapes += [("fused_mlp", "rot129_refine33_points", netG, 768 * 6, 1, 1),
               ("fused_mlp", "rot129_refine129_points", netG, 5888 * 6, 1,
                1),
               ("fused_anchor_mlp", "rot129_refine33", netG, 768, 6, 3),
               ("fused_anchor_mlp", "rot129_refine129", netG, 5888, 6, 3)]
    from monoport_tpu_torch.apps.demo_synthetic import DEMO_HEAD
    demo = seeded_head_net(DEMO_HEAD, 129)
    shapes += [("fused_mlp", f"demo_level_{n}", demo, n, 1, 1)
               for n in (17 ** 3, 8192, 32768)]
    # the wide netG (phase wide_head: WIDE_NETG_HEAD, which the in-place
    # bf16 kernel cannot hold; its scratch mode and the f32 route's
    # activation scratch) at every shape its frames launch: the frontal
    # march and refines, the rotated march and anchored refines (plan
    # (5, 3)), every level of the dense hierarchy; kernel 4 at the gather
    # A/B's shapes
    wide_g = reference_helper().wide_netg("cuda")
    shapes += [("fused_ray_mlp", "march_w2048", wide_g, 33 * 33, 33, 1),
               ("fused_ray_mlp", "refine65_w2048", wide_g, 65 * 65, 6, 1),
               ("fused_ray_mlp", "refine257_w2048", wide_g, 192 * 192, 6,
                1),
               ("fused_mlp", "march_w2048", wide_g, 33 ** 3, 1, 1),
               ("fused_anchor_mlp", "refine65_w2048", wide_g, 2304, 6, 5),
               ("fused_anchor_mlp", "refine257_w2048", wide_g, 18432, 6,
                3)]
    dense_levels = frame_check.quality_config()[0]
    shapes += [("fused_mlp", f"level_{n}_w2048", wide_g, n, 1, 1)
               for n in (dense_levels.resolutions[0] ** 3,
                         *dense_levels.budgets[1:])]
    shapes += [("fused_gather_mlp", f"{name}_w2048", wide_g, rays, taps, 1)
               for name, rays, taps in profile_gather.SHAPES]
    # WIDE_NETG_HEAD's widths under seeded weights that keep the outputs
    # off the sigmoid's tails (wide_g's sit on them, driven by its z
    # column): an error in the scratch modes' hidden layers reaches the
    # output at the bf16 tolerance
    unsat = seeded_head_net(reference_helper().WIDE_NETG_HEAD, 2048, 0.1)
    shapes += [("fused_ray_mlp", "march_w2048u", unsat, 33 * 33, 33, 1),
               ("fused_ray_mlp", "refine257_w2048u", unsat, 192 * 192, 6,
                1),
               ("fused_mlp", "march_w2048u", unsat, 33 ** 3, 1, 1),
               ("fused_mlp", "level_65536_w2048u", unsat, 65536, 1, 1),
               ("fused_anchor_mlp", "refine257_w2048u", unsat, 18432, 6,
                3),
               ("fused_gather_mlp", "fine_192x6_w2048u", unsat, 36864, 6,
                1)]
    # kernel 2's view-pooled form (f32 only) on the committed netG's head at
    # phase 21's levels: the dense hierarchy's coarse lattice and budgets,
    # VIEWS rows a point
    shapes += [("fused_mlp_views", f"views_level_{n}", netG, n, 1, 1)
               for n in (dense_levels.resolutions[0] ** 3,
                         *dense_levels.budgets[1:])]
    on_path = {k[0]: k[3] for k in KERNELS}
    rows = []
    for dname, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        # a head's packing for the kernels that take it (a soft-onehot head
        # has no scalar z column: only the per-point kernel takes it)
        packs = {}
        for kernel, _, n, *_ in shapes:
            kind = ("point" if kernel in ("fused_mlp", "fused_mlp_views")
                    else "ray")
            if (id(n), kind) not in packs:
                pack = (tmlp.pack_mlp_params if kind == "point"
                        else tray.pack_ray_mlp_params)
                packs[id(n), kind] = pack(n.surface_classifier, dtype=dtype,
                                          device="cuda")
        for i, (kernel, name, net, rays, taps, k) in enumerate(shapes):
            if kernel == "fused_mlp_views" and dname == "bf16":
                continue                            # no bf16 form
            head = net.surface_classifier
            rng = np.random.RandomState(100 + i)
            cuda = lambda a: torch.from_numpy(a.astype(np.float32)).cuda()
            if kernel == "fused_gather_mlp":
                p = packs[id(net), "ray"]
                fmap = cuda(rng.randn(*profile_gather.MAP))
                args = (fmap, cuda(rng.uniform(-0.74, 0.74, (1, rays, 2))),
                        cuda(rng.randn(1, rays, taps) * 0.3))
                fn = tgather.apply_gather_ray
                plain = tgather.apply_gather_plain
                work = gather_mlp_work(head, rays, taps, dname, fmap.shape)
            elif kernel == "fused_mlp":
                p = packs[id(net), "point"]
                args = ((soft_rows(rng, rays),) if net is soft
                        else (cuda(rng.randn(1, rays, p.c_f)),))
                fn, plain = tmlp.apply_mlp, tmlp.apply_mlp_plain
                work = point_mlp_work(head, rays, dname)
            elif kernel == "fused_mlp_views":
                p = packs[id(net), "point"]
                args = (cuda(rng.randn(1, rays, VIEWS, p.c_f)),)
                fn = lambda p, x: tmlp.apply_mlp_views(p, x, VIEWS)
                plain = lambda p, x: tmlp.apply_mlp_views_plain(p, x, VIEWS)
                work = views_mlp_work(head, rays, VIEWS)
            else:
                p = packs[id(net), "ray"]
                z = cuda(rng.uniform(-1.3, 1.3, (1, rays, taps)))
                if kernel == "fused_ray_mlp":
                    args = (cuda(rng.randn(1, rays, p.c_f)), z)
                    fn, plain = tray.apply_ray, tray.apply_ray_plain
                    work = ray_mlp_work(head, rays, taps, dname)
                else:
                    args = (cuda(rng.randn(1, rays, k, p.c_f)),
                            cuda(hat_weights(rng, rays, taps, k)), z)
                    fn, plain = tray.apply_anchor, tray.apply_anchor_plain
                    work = ray_mlp_work(head, rays, taps, dname, anchors=k,
                                        mixed=True)
            got = fn(p, *args)
            want = plain(p, *args)
            torch.cuda.synchronize()
            err = (got - want).abs()
            p999 = float(torch.quantile(err.flatten().float(), 0.999).item())
            tol = TOL[dname]
            ok = bool(torch.all(err <= tol["atol"] + tol["rtol"]
                                * want.abs()).item()
                      and torch.isfinite(got).all().item())
            flops, t_ops, nbytes = work
            t_byte = nbytes / PEAK_BYTES
            reps = 20 if dname == "bf16" else 5
            row = {"phase": "kernel", "kernel": kernel, "shape": name,
                   "dtype": dname, "rays": rays, "taps": taps, "anchors": k,
                   "c_in": p.c_f,
                   "route": ROUTES.get((kernel, dname), "tiles_fma"),
                   "mode": kernel_mode(p, dname),
                   "max_abs_err": float(err.max().item()),
                   "p999_abs_err": p999,
                   "atol": tol["atol"], "rtol": tol["rtol"], "ok": ok,
                   "ms": cuda_ms(lambda: fn(p, *args), reps),
                   "plain_ms": cuda_ms(lambda: plain(p, *args), reps),
                   "gflop": flops / 1e9,
                   "bound_ms": max(t_ops, t_byte) * 1e3,
                   "bound_by": "operations" if t_ops >= t_byte else "bytes",
                   "library_ms": None}
            # the share of its roofline (the f32 rows' bound is the 67
            # TFLOP/s FMA peak)
            row["roofline"] = row["bound_ms"] / row["ms"]
            if kernel == "fused_mlp_views":
                row["views"] = VIEWS
                row["recompute"] = views_recompute(head, VIEWS)
            if net is wide_g or net is unsat:
                row["unsaturated_share"] = float(
                    ((want > 0.02) & (want < 0.98)).float().mean().item())
            if net is unsat and row["unsaturated_share"] < 0.5:
                fail(f"{kernel} {name}: the seeded head's outputs sit on "
                     f"the sigmoid's tails: {row['unsaturated_share']}")
            if (dname == "bf16" and (net is netG or net is netC)
                    and name in on_path[kernel]):
                # the published head forced into the scratch mode (the
                # same products in the same order: bit-equal), timed
                # between two in-place timings
                with forced_scratch():
                    forced = fn(p, *args)
                    row["scratch_ms"] = cuda_ms(lambda: fn(p, *args), reps)
                row["in_place_ms_after"] = cuda_ms(lambda: fn(p, *args),
                                                   reps)
                if not torch.equal(forced, got):
                    fail(f"{kernel} {name}: the scratch mode changes the "
                         f"published head's outputs")
            if row["route"] == "sm90_mix_wgmma":
                row.update(mix_phase(kernel, p, args, reps))
                row["recompute"] = (
                    anchor_recompute(head, taps, k)
                    if kernel == "fused_anchor_mlp"
                    else ray_recompute(head, taps))
            elif row["route"] == "sm90_wgmma":
                xr = tmlp.pad_feat(p, args[0]).reshape(rays, -1).contiguous()
                if kernel == "fused_ray_mlp":
                    zr = args[1].reshape(rays, taps).contiguous()
                    stream = lambda: tray.stream_ray_wgmma(p, xr, zr)
                    row["recompute"] = ray_recompute(head, taps)
                else:
                    stream = lambda: tmlp.stream_wgmma(p, xr)
                row["l2_floor_ms"] = cuda_ms(stream, reps)
                row["l2_read_tb_s"] = (wgmma.streamed_bytes(p, rays, taps)
                                       / row["l2_floor_ms"] / 1e9)
            emit(row)
            if not ok:
                fail(f"{kernel} {name} {dname}: the kernel disagrees with "
                     f"its plain version (max abs err {row['max_abs_err']})")
            if row.get("mix_max_ulps", 0) > 1:
                fail(f"{kernel} {name}: the weighted-row pass is "
                     f"{row['mix_max_ulps']} bf16 ulps from mix_rows_plain")
            rows.append(row)
    return rows


def kernel_mode(p, dname: str) -> str:
    """The mode a pack runs in: the bf16 wgmma kernel in place or with its
    device-memory scratch; the f32 layer kernel's activations in shared
    memory or in device memory."""
    from monoport_tpu_torch.ops.cuda import wgmma

    if dname == "bf16":
        return ("scratch" if wgmma.needs_scratch(p.tile_widths)
                else "in_place")
    return "activation_scratch" if p.f32_scratch else "shared"


def ray_chunks(net, rays: int, taps: int, block_rows: int,
               views: int = 1) -> int:
    """The chunks one f32 ray-MLP or per-point MLP call of ``net``'s head
    walks (one ``xproj_kernel`` and one ``mlp_kernel`` launch each): the
    launcher's rule in ``csrc/mlp_tiles.cuh`` (``launch``) for its bounded
    scratch, whole waves of ``block_rows``-row blocks where one fits; a
    view-pooled call's ``rays`` are its rows, whole points a chunk."""
    import torch

    from monoport_tpu_torch.ops.cuda.fused_ray_mlp import XP_SCRATCH_BYTES

    ntot = sum(-(-lin.weight.shape[0] // 32) * 32
               for lin in net.surface_classifier.layers())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chunk = max(1, XP_SCRATCH_BYTES // (4 * ntot))
    wave = sms * block_rows // taps
    if chunk >= rays:
        return 1
    if wave >= 1 and chunk >= wave:
        chunk -= chunk % wave
    chunk -= chunk % views
    return -(-rays // chunk)


def find_syncs(fn) -> list[str]:
    """The Python stacks at which ``fn`` synchronises the stream (torch's
    sync debug mode)."""
    import traceback
    import warnings

    import torch

    found = []

    def hook(message, *args, **kwargs):
        if "synchroniz" in str(message):
            found.append("".join(traceback.format_stack(limit=6)[:-1]))

    # (setting the mode warns once by itself: set it before listening)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = hook
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return found


def profile_phase(eng, image, calib, card: str, frame_ms: float,
                  view: str, frames: int = 2, dtype: str = "bf16") -> list:
    """Device time by kernel over a few frames (torch.profiler), and
    the device's idle share of the unprofiled median frame time. -> [(kernel
    name, ms a frame, calls a frame)]."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            eng.frame(image, image, calib)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / frames
    kernels = [(e.key, e.self_device_time_total / 1e3 / frames,
                e.count // frames) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    kernels.sort(key=lambda k: -k[1])
    busy = sum(k[1] for k in kernels)
    emit({"phase": "profile", "view": view, "dtype": dtype,
          "frames": frames,
          "wall_ms_per_frame": wall_ms, "device_ms_per_frame": busy,
          "device_idle_share": 1.0 - busy / frame_ms,
          "device_idle_share_profiled": 1.0 - busy / wall_ms,
          "kernel_launches_per_frame": sum(k[2] for k in kernels),
          "top": [{"kernel": k[0][:90], "ms": k[1], "calls": k[2]}
                  for k in kernels[:20]], "card": card})
    return kernels


FRAME_SHAPES = {"depth": (257, 257), "valid": (257, 257),
                "render_norm": (256, 256, 3), "render_tex": (256, 256, 3),
                "mask": (256, 256, 1)}


def timed_frames(eng, image, calib, counters: dict, expect: dict,
                 view: str, card: str, shapes: dict = FRAME_SHAPES,
                 depth_on_valid: bool = False):
    """Warm up, check for stream syncs, then time FRAMES bf16 frames with
    the launch counts zeroed just before and read just after; ``expect``
    is the launches a frame of each kernel, ``shapes`` the outputs'.
    ``depth_on_valid``: a frame whose depth is peeled from a volume carries
    none (0/0) on a ray with no hit, and is held finite on valid pixels
    only. -> (last output, median ms, launches by kernel)."""
    import torch

    eng.frame(image, image, calib)                       # warm-up
    torch.cuda.synchronize()
    syncs = find_syncs(lambda: eng.frame(image, image, calib))
    if syncs:
        fail(f"a {view} frame synchronised the stream at {syncs}")
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    times = []
    for _ in range(FRAMES):
        t0 = time.perf_counter()
        out = eng.frame(image, image, calib)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {name: fn.launches for name, fn in counters.items()}
    want = {name: n * FRAMES for name, n in expect.items()}
    if launches != want:
        fail(f"{view} frames launched {launches} in {FRAMES} frames, "
             f"expected {want}")
    got = {k: tuple(v.shape) for k, v in out.items()
           if k != "compact_dropped"}
    if got != shapes:
        fail(f"{view} frame output shapes {got}")
    depth = out["depth"][out["valid"]] if depth_on_valid else out["depth"]
    finite = {"depth": depth,
              **{k: out[k] for k in ("render_norm", "render_tex")
                 if k in out}}
    for k, v in finite.items():
        if not torch.isfinite(v).all():
            fail(f"bf16 {view} frame: non-finite {k}")
    med = statistics.median(times)
    emit({"phase": "frame", "view": view, "dtype": "bf16", "frames": FRAMES,
          "frame_ms_median": med, "fps": 1e3 / med, "frame_ms": times,
          "launches": launches,
          "launches_per_frame": {k: v / FRAMES for k, v in launches.items()},
          "host_syncs_per_frame": len(syncs), "card": card})
    return out, med, launches


def golden_phase(eng32, out16, image, golden, limits16, view: str,
                 card: str):
    """The last bf16 frame and one f32 frame against a JAX golden."""
    import torch

    from monoport_tpu_torch import frame_check

    res16 = frame_check.compare_to_golden(out16, golden, limits16)
    emit({"phase": "golden", "view": view, "dtype": "bf16", **res16,
          "limits": limits16._asdict(), "card": card})
    t0 = time.perf_counter()
    out32 = eng32.frame(image, image, golden["calib"])
    torch.cuda.synchronize()
    ms32 = (time.perf_counter() - t0) * 1e3
    res = frame_check.compare_to_golden(out32, golden)
    emit({"phase": "golden", "view": view, "dtype": "f32", "frame_ms": ms32,
          **res, "limits": frame_check.F32_LIMITS._asdict(), "card": card})
    for dname, r in (("bf16", res16), ("f32", res)):
        if not r["ok"]:
            fail(f"{dname} {view} frame disagrees with the JAX golden: {r}")
    return out32


# the launches of a bf16 frame at the real-time operating point
FRONTAL_EXPECT = {"fused_ray_mlp": 4, "fused_mlp": 0, "fused_anchor_mlp": 0,
                  "fused_gather_mlp": 0, "mix_rows": 0}


def rotated_expect(plan: tuple) -> dict:
    """A rotated frame's launches from its anchor plan: the per-point MLP
    for the march and each per-point refine level, the anchored MLP (and
    in bf16 its weighted-row pass) for each anchored level."""
    anchored = sum(1 for k in plan if k)
    return {"fused_ray_mlp": 0, "fused_gather_mlp": 0,
            "fused_mlp": 1 + sum(1 for k in plan if not k),
            "fused_anchor_mlp": anchored, "mix_rows": anchored}


def graphs_phase(netG, netC, card: str) -> None:
    """Phase 20: the backbone and pyramid-stage graphs against the eager
    calls, hg4 and the multi-level HRNet netG."""
    import torch

    from monoport_tpu_torch import frame_check
    from monoport_tpu_torch.config import CN
    from monoport_tpu_torch.engine import ReconEngine
    from monoport_tpu_torch.weights import build_net

    helper = reference_helper()
    imf = "HRNetV2_W18_small_v2"
    hrnet = build_net(CN(helper.alt_netg_opts(imf)),
                      helper.alt_netg_state(imf), "cuda")
    image = torch.from_numpy(frame_check.load_golden()["image"]).cuda()
    mirror = torch.flip(image, dims=(2,))
    calib = frame_check.rotated_calib()
    for name, g, c in (("hg4", netG, netC), (imf, hrnet, None)):
        recon, cfg = frame_check.rtl_config(torch.bfloat16)
        eng = ReconEngine(g, c, recon=recon, config=cfg)
        res = frame_check.replay_check(eng, [image, mirror, image],
                                       frame_check.replay_cases())
        syncs = find_syncs(lambda: eng.frame(image, image, calib))
        torch.cuda.synchronize()
        nets = ["netG"] if c is None else ["netG", "netC"]
        emit({"phase": "graphs", "nets": name, **res,
              "replay_syncs": len(syncs), "card": card})
        if not res["ok"]:
            fail(f"{name}: a replayed call or frame differs from the eager "
                 f"one, or a frame's output changed after the next: {res}")
        if any(res["keys"].get(n) != 1 for n in nets) or any(
                res["counts"][n]["capture"] != res["keys"][n]
                for n in res["keys"]):
            fail(f"{name}: captures {res['counts']} over the keys "
                 f"{res['keys']}, expected one a key and one a net")
        if syncs:
            fail(f"{name}: a replaying frame synchronised the stream at "
                 f"{syncs}")
        del eng
    del hrnet
    torch.cuda.empty_cache()


def frame_phases(netG, netC, counters: dict, card: str) -> dict:
    """The frontal and the rotated frame. -> launches by kernel, each
    from the run of the path that launches it."""
    import numpy as np
    import torch

    from monoport_tpu_torch import frame_check
    from monoport_tpu_torch.engine import ReconEngine

    golden = frame_check.load_golden()
    rotated = frame_check.load_golden(frame_check.GOLDEN_ROTATED)
    image = torch.from_numpy(golden["image"]).cuda()
    if not np.array_equal(rotated["calib"], frame_check.rotated_calib()):
        fail("the rotated golden was written for another pose")

    recon, cfg = frame_check.rtl_config(torch.bfloat16)
    eng = ReconEngine(netG, netC, recon=recon, config=cfg)
    recon, cfg = frame_check.rtl_config(torch.float32)
    eng32 = ReconEngine(netG, netC, recon=recon, config=cfg)
    if not find_syncs(lambda: torch.zeros(1, device="cuda").item()):
        fail("the sync detector misses a known sync")

    # frontal: 4 ray-MLP launches a frame and no other
    out, med, launches = timed_frames(
        eng, image, golden["calib"], counters, FRONTAL_EXPECT, "frontal",
        card)
    total = {"fused_ray_mlp": launches["fused_ray_mlp"]}
    frontal = out
    profile_phase(eng, image, golden["calib"], card, med, "frontal")
    golden_phase(eng32, out, image, golden, frame_check.BF16_LIMITS,
                 "frontal", card)

    # rotated: the counts follow the pose's anchor plan
    calib = rotated["calib"]
    plan = eng._rot_anchor_plan(calib, image.shape[1])
    if [k or 0 for k in plan] != rotated["anchor_plan"].tolist():
        fail(f"anchor plan {plan} != the golden's {rotated['anchor_plan']}")
    expect = rotated_expect(plan)
    out, med, launches = timed_frames(eng, image, calib, counters, expect,
                                      "rotated", card)
    total.update({k: launches[k] for k in ("fused_mlp", "fused_anchor_mlp")})
    dropped = out["compact_dropped"].tolist()
    emit({"phase": "rotated", "anchor_plan": [k or 0 for k in plan],
          "launches_per_frame_expected": expect, "compact_dropped": dropped,
          "compact_report": eng.compact_report(out)})

    # a smaller budget from the measured valid fraction: the same frame
    # where nothing dropped (the per-point colour head is a library GEMM,
    # whose sums may split otherwise at another batch: held to 1e-5)
    hint = eng.compact_hint_from_valid(float(out["valid"].float().mean()))
    hinted = eng.frame(image, image, calib, compact_hint=hint)
    torch.cuda.synchronize()
    dropped_h = hinted["compact_dropped"].tolist()
    same = {k: bool(torch.equal(hinted[k], out[k])) for k in FRAME_SHAPES}
    tex_diff = float((hinted["render_tex"] - out["render_tex"]).abs().max())
    emit({"phase": "compact_hint", "hint": hint, "compact_dropped": dropped_h,
          "bit_identical": same, "render_tex_max_diff": tex_diff})
    if not any(dropped) and not any(dropped_h):
        if not all(same[k] for k in ("depth", "valid", "render_norm")):
            fail(f"the hinted frame's geometry differs: {same}")
        if tex_diff > 1e-5:
            fail(f"the hinted frame's texture differs by {tex_diff}")
    anchored_calls_check(
        profile_phase(eng, image, calib, card, med, "rotated"), expect,
        "rotated")
    out32 = golden_phase(eng32, out, image, rotated,
                         frame_check.BF16_ROTATED_LIMITS, "rotated", card)
    dropped32 = out32["compact_dropped"].tolist()
    if dropped32 != rotated["compact_dropped"].tolist():
        fail(f"f32 rotated frame dropped {dropped32}, the golden "
             f"{rotated['compact_dropped'].tolist()}")
    return total, frontal


@contextlib.contextmanager
def plain_kernels():
    """Inside, the engine's MLPs take their plain versions on the card, and
    every graphed call runs eagerly (a graph replays the kernels it
    captured)."""
    from monoport_tpu_torch import engine, frame_graphs
    from monoport_tpu_torch.ops.cuda import fused_mlp as tmlp
    from monoport_tpu_torch.ops.cuda import fused_ray_mlp as tray

    kept = (engine.apply_ray, engine.apply_anchor, engine.apply_mlp,
            engine.apply_mlp_views)
    run = frame_graphs.FrameGraphs.run

    def eager(self, name, fn, inputs, dtypes=None, extra=None,
              capture=True):
        return run(self, name, fn, inputs, dtypes, extra, capture=False)

    engine.apply_ray = tray.apply_ray_plain
    engine.apply_anchor = tray.apply_anchor_plain
    engine.apply_mlp = tmlp.apply_mlp_plain
    engine.apply_mlp_views = tmlp.apply_mlp_views_plain
    frame_graphs.FrameGraphs.run = eager
    try:
        yield
    finally:
        (engine.apply_ray, engine.apply_anchor, engine.apply_mlp,
         engine.apply_mlp_views) = kept
        frame_graphs.FrameGraphs.run = run


def mlp_calls(kernels: list) -> dict:
    """Launches of our MLP device kernels among profiled (name, ms, calls):
    the wgmma kernel by its epilogue (per-point, ray or anchored), the
    weighted-row pass, and the layer and projection kernels of
    csrc/mlp_tiles.cuh."""
    calls = {"wgmma_point": 0, "wgmma_ray": 0, "wgmma_anchor": 0,
             "mix_rows": 0, "mlp_kernel": 0, "xproj_kernel": 0}
    for name, _, n in kernels:
        if "wgmma_mlp_kernel" in name and "RayEpilogue" in name:
            calls["wgmma_ray"] += n
        elif "wgmma_mlp_kernel" in name and "PointEpilogue" in name:
            calls["wgmma_point"] += n
        elif "wgmma_mlp_kernel" in name and "AnchorEpilogue" in name:
            calls["wgmma_anchor"] += n
        elif "mix_rows_kernel" in name:
            calls["mix_rows"] += n
        elif "mlp_kernel<" in name:
            calls["mlp_kernel"] += n
        elif "xproj_kernel" in name:
            calls["xproj_kernel"] += n
    return calls


def anchored_calls_check(kernels: list, expect: dict, view: str) -> None:
    """A bf16 frame's profiled device kernels against its launch counts: one
    wgmma launch a per-point call and, for each anchored call, one
    weighted-row pass and one wgmma launch of the anchored epilogue; no ray
    MLP and no kernel of the FMA route."""
    calls = mlp_calls(kernels)
    want = {"wgmma_point": expect["fused_mlp"], "wgmma_ray": 0,
            "wgmma_anchor": expect["fused_anchor_mlp"],
            "mix_rows": expect["fused_anchor_mlp"], "mlp_kernel": 0,
            "xproj_kernel": 0}
    emit({"phase": f"{view}_kernel_calls", "dtype": "bf16",
          "per_frame": calls, "expected": want})
    if calls != want:
        fail(f"the bf16 {view} frame's device kernels a frame {calls}: "
             f"expected {want}")


def as_golden(out: dict) -> dict:
    """A frame's outputs as the numpy arrays ``compare_to_golden`` takes."""
    return {k: (v if k == "valid" else v.float()).cpu().numpy()
            for k, v in out.items()}


def closed_share(verts, faces, res: int) -> tuple[int, int, float]:
    """(edges, edges away from the volume's border, the share of those
    shared by exactly two faces) of a mesh from a res^3 volume over
    [-1, 1]^3."""
    import numpy as np

    edges = np.sort(np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                                    faces[:, [2, 0]]]), axis=1)
    uniq, n_shared = np.unique(edges, axis=0, return_counts=True)
    step = 2.0 / (res - 1)
    inner = (np.abs(verts) < 1.0 - 1.5 * step).all(axis=1)
    away = inner[uniq[:, 0]] & inner[uniq[:, 1]]
    closed = float((n_shared[away] == 2).mean()) if away.any() else 0.0
    return int(len(uniq)), int(away.sum()), closed


def dense_phases(netG, netC, counters: dict, card: str) -> dict:
    """The dense frame, its mesh, the hierarchy frame and a clip. ->
    launches by kernel over the dense and hierarchy runs."""
    import dataclasses

    import numpy as np
    import torch

    from monoport_tpu_torch import frame_check
    from monoport_tpu_torch.engine import ReconEngine, RotatedCfg
    from monoport_tpu_torch.ops.cuda import fused_ray_mlp as tray
    from monoport_tpu_torch.recon.marching import extract_mesh

    golden = frame_check.load_golden(frame_check.GOLDEN_DENSE)
    image = torch.from_numpy(frame_check.load_golden()["image"]).cuda()
    eye = golden["calib"]
    res = frame_check.QUALITY_RESOLUTIONS[-1]
    levels = len(frame_check.QUALITY_RESOLUTIONS)

    # dense: the per-point MLP once a level, the ray MLP for the colour
    recon, cfg = frame_check.quality_config(torch.bfloat16)
    eng = ReconEngine(netG, netC, recon=recon, config=cfg)
    shapes = {"depth": (res, res), "valid": (res, res),
              "render_norm": (256, 256, 3), "render_tex": (256, 256, 3),
              "mask": (256, 256, 1), "sdf": (res, res, res),
              "recon_counts": (levels - 1,)}
    expect = {"fused_ray_mlp": 1, "fused_mlp": levels, "fused_anchor_mlp": 0,
              "fused_gather_mlp": 0, "mix_rows": 0}
    torch.cuda.reset_peak_memory_stats()
    out, med, launches = timed_frames(eng, image, eye, counters, expect,
                                      "dense", card, shapes,
                                      depth_on_valid=True)
    total = dict(launches)
    counts = out["recon_counts"].tolist()
    emit({"phase": "dense", "dtype": "bf16", "recon_counts": counts,
          "golden_recon_counts": golden["recon_counts"].tolist(),
          "budgets": list(recon.budgets[1:]),
          "band_report": eng.band_report(out),
          "peak_memory_mb": torch.cuda.max_memory_allocated() / 2 ** 20})
    if any(c > b for c, b in zip(counts, recon.budgets[1:])):
        fail(f"the dense frame overflowed its budgets: {counts}")
    calls = mlp_calls(profile_phase(eng, image, eye, card, med, "dense"))
    want = {"wgmma_point": levels, "wgmma_ray": 1, "wgmma_anchor": 0,
            "mix_rows": 0, "mlp_kernel": 0, "xproj_kernel": 0}
    emit({"phase": "dense_kernel_calls", "dtype": "bf16", "per_frame": calls,
          "expected": want})
    if calls != want:
        fail(f"the bf16 dense frame's device kernels a frame {calls}: "
             f"expected one wgmma kernel a per-point call and one for the "
             f"ray MLP's colour call, {want}")
    res16 = frame_check.compare_to_golden(out, golden,
                                          frame_check.BF16_DENSE_LIMITS)
    emit({"phase": "golden", "view": "dense", "dtype": "bf16", **res16,
          "limits": frame_check.BF16_DENSE_LIMITS._asdict(), "card": card})
    recon32, cfg32 = frame_check.quality_config(torch.float32)
    eng32 = ReconEngine(netG, netC, recon=recon32, config=cfg32)
    t0 = time.perf_counter()
    out32 = eng32.frame(image, image, eye)
    torch.cuda.synchronize()
    ms32 = (time.perf_counter() - t0) * 1e3
    # f32 keeps the FMA route: a projection and a layer launch a chunk of
    # every per-point level and of the colour query
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        eng32.frame(image, image, eye)
        torch.cuda.synchronize()
    calls32 = mlp_calls([(e.key, 0.0, e.count) for e in prof.key_averages()
                         if e.device_type == torch.autograd.DeviceType.CUDA])
    chunks = ray_chunks(netC, res * res, 1, tray.F32_BM) + sum(
        ray_chunks(netG, n, 1, tray.F32_BM) for n in (
            recon32.resolutions[0] ** 3, *recon32.budgets[1:]))
    want32 = {"wgmma_point": 0, "wgmma_ray": 0, "wgmma_anchor": 0,
              "mix_rows": 0, "mlp_kernel": chunks, "xproj_kernel": chunks}
    emit({"phase": "dense_kernel_calls", "dtype": "f32", "per_frame": calls32,
          "expected": want32})
    if calls32 != want32:
        fail(f"the f32 dense frame's device kernels {calls32}: expected the "
             f"FMA route's projection + layer chunks, {want32}")
    res32 = frame_check.compare_to_golden(out32, golden)
    sdf32 = frame_check.compare_sdf(out32, golden)
    counts32 = out32["recon_counts"].tolist()
    drift = max(abs(a - b) / max(b, 1) for a, b in
                zip(counts32, golden["recon_counts"].tolist()))
    emit({"phase": "golden", "view": "dense", "dtype": "f32",
          "frame_ms": ms32, **res32,
          **{k: v for k, v in sdf32.items() if k != "ok"},
          "sdf_ok": sdf32["ok"], "recon_counts": counts32,
          "golden_recon_counts": golden["recon_counts"].tolist(),
          "recon_counts_max_rel_diff": drift,
          "limits": frame_check.F32_LIMITS._asdict(), "card": card})
    if not res16["ok"]:
        fail(f"bf16 dense frame disagrees with the JAX golden: {res16}")
    if not (res32["ok"] and sdf32["ok"]):
        fail(f"f32 dense frame disagrees with the JAX golden: {res32} "
             f"{sdf32}")
    if drift > 2e-3:
        fail(f"f32 dense recon_counts {counts32} against the golden's "
             f"{golden['recon_counts'].tolist()}")

    # the same frames through the plain versions of the kernels on the card
    for dname, e, got, limits in (
            ("bf16", eng, out, frame_check.BF16_DENSE_LIMITS),
            ("f32", eng32, out32, frame_check.F32_LIMITS)):
        with plain_kernels():
            want = e.frame(image, image, eye)
        torch.cuda.synchronize()
        cmp = frame_check.compare_to_golden(got, as_golden(want), limits)
        sdf_diff = float((got["sdf"].float() - want["sdf"].float())
                         .abs().max())
        same_counts = got["recon_counts"].tolist() == \
            want["recon_counts"].tolist()
        emit({"phase": "dense_vs_plain", "dtype": dname, **cmp,
              "sdf_max_diff": sdf_diff, "recon_counts_equal": same_counts,
              "limits": limits._asdict(), "card": card})
        if not cmp["ok"]:
            fail(f"{dname} dense frame disagrees with its plain-kernel "
                 f"run: {cmp}")
        if dname == "f32" and not (same_counts and sdf_diff <= 2e-3):
            fail(f"f32 dense frame against its plain-kernel run: sdf differs "
                 f"by {sdf_diff}, recon_counts {got['recon_counts'].tolist()}"
                 f" / {want['recon_counts'].tolist()}")
        del want

    # mesh of the f32 volume: closed away from the volume's border
    t0 = time.perf_counter()
    verts, faces = extract_mesh(out32["sdf"], recon32.balance_value,
                                b_min=recon32.b_min, b_max=recon32.b_max)
    mesh_ms = (time.perf_counter() - t0) * 1e3
    n_edges, n_away, closed = closed_share(verts, faces, res)
    emit({"phase": "mesh", "vertices": int(len(verts)),
          "faces": int(len(faces)), "edges": n_edges,
          "edges_away_from_border": n_away,
          "edges_shared_by_two_faces": closed, "extract_ms": mesh_ms})
    if len(faces) < 1000 or closed < 0.999:
        fail(f"the mesh is not closed: {len(faces)} faces, {closed} of the "
             "inner edges shared by two faces")

    # hierarchy: a rotated calib with the march off, against the plain
    # versions of the kernels on the card
    calib = frame_check.rotated_calib()
    off = RotatedCfg(march=False)
    engines = {}
    for dname, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        recon_h, cfg_h = frame_check.rtl_config(dtype)
        engines[dname] = ReconEngine(
            netG, netC, recon=recon_h,
            config=dataclasses.replace(cfg_h, rotated=off))
    eng_h = engines["bf16"]
    plan = eng_h._rot_anchor_plan(calib, image.shape[1])
    n_levels = len(eng_h.recon.resolutions)
    expect = {"fused_ray_mlp": 0, "fused_gather_mlp": 0,
              "fused_mlp": n_levels + sum(1 for k in plan if not k),
              "fused_anchor_mlp": sum(1 for k in plan if k)}
    expect["mix_rows"] = expect["fused_anchor_mlp"]
    rc = eng_h.recon.resolutions[-1]
    shapes = {**FRAME_SHAPES, "sdf": (rc, rc, rc),
              "recon_counts": (n_levels - 1,)}
    if tuple(plan) != (HIERARCHY_ANCHORS,):
        fail(f"the kernel phase measured the hierarchy frame's anchored MLP "
             f"at plan ({HIERARCHY_ANCHORS},), the pose gives {plan}")
    out_h, med_h, launches = timed_frames(eng_h, image, calib, counters,
                                          expect, "hierarchy", card, shapes,
                                          depth_on_valid=True)
    for k, v in launches.items():
        total[k] += v
    anchored_calls_check(
        profile_phase(eng_h, image, calib, card, med_h, "hierarchy"), expect,
        "hierarchy")
    emit({"phase": "hierarchy", "anchor_plan": [k or 0 for k in plan],
          "launches_per_frame_expected": expect,
          "recon_counts": out_h["recon_counts"].tolist(),
          "budgets": list(eng_h.recon.budgets[1:]),
          "band_report": eng_h.band_report(out_h),
          "compact_dropped": out_h["compact_dropped"].tolist(),
          "compact_report": eng_h.compact_report(out_h)})
    for dname, limits in (("bf16", frame_check.BF16_ROTATED_LIMITS),
                          ("f32", frame_check.F32_LIMITS)):
        e = engines[dname]
        got = out_h if dname == "bf16" else e.frame(image, image, calib)
        with plain_kernels():
            want = e.frame(image, image, calib)
        torch.cuda.synchronize()
        cmp = frame_check.compare_to_golden(got, as_golden(want), limits)
        same = {k: got[k].tolist() == want[k].tolist()
                for k in ("recon_counts", "compact_dropped")}
        emit({"phase": "hierarchy_vs_plain", "dtype": dname, **cmp,
              "recon_counts_equal": same["recon_counts"],
              "compact_dropped_equal": same["compact_dropped"],
              "limits": limits._asdict(), "card": card})
        if not cmp["ok"]:
            fail(f"{dname} hierarchy frame disagrees with its plain-kernel "
                 f"run: {cmp}")
        if dname == "f32" and not all(same.values()):
            fail(f"f32 hierarchy frame against its plain-kernel run: "
                 f"recon_counts {got['recon_counts'].tolist()} / "
                 f"{want['recon_counts'].tolist()}, compact_dropped "
                 f"{got['compact_dropped'].tolist()} / "
                 f"{want['compact_dropped'].tolist()}")

    # a clip: two frontal frames and a rotated one, each its own path
    recon_r, cfg_r = frame_check.rtl_config(torch.bfloat16)
    eng_r = ReconEngine(netG, netC, recon=recon_r, config=cfg_r)
    flipped = torch.flip(image, dims=(2,))
    images = torch.cat([image, image, flipped])
    calibs = np.concatenate([eye, calib, eye])
    clip = eng_r.frames(images, images, calibs)
    torch.cuda.synchronize()
    syncs = find_syncs(lambda: eng_r.frames(images, images, calibs))
    if syncs:
        fail(f"frames() synchronised the stream at {syncs}")
    t0 = time.perf_counter()
    clip = eng_r.frames(images, images, calibs)
    torch.cuda.synchronize()
    clip_ms = (time.perf_counter() - t0) * 1e3
    diffs = {}
    for i in range(3):
        one = eng_r.frame(images[i:i + 1], images[i:i + 1], calibs[i:i + 1])
        for k in clip:
            d = float((clip[k][i].float() - one[k].float()).abs().max())
            diffs[k] = max(diffs.get(k, 0.0), d)
    emit({"phase": "frames", "dtype": "bf16", "clip": 3,
          "keys": sorted(clip), "clip_ms": clip_ms,
          "max_diff_vs_frame": diffs, "host_syncs": len(syncs)})
    if set(clip) != set(FRAME_SHAPES):
        fail(f"frames() keys {sorted(clip)}")
    if any(diffs[k] > 0 for k in ("depth", "valid", "render_norm", "mask")) \
            or diffs["render_tex"] > 1e-5:
        fail(f"frames() differs from frame(): {diffs}")
    return total


def ring_calibs(yaws) -> "np.ndarray":
    """[V, 4, 4] calibs of orthographic cameras at ``yaws`` degrees about
    the vertical (y) axis, pitch 0: view v maps X to R_y(yaw_v) X, so a
    ring starting at yaw 0 has the identity for view 0."""
    import numpy as np

    out = np.tile(np.eye(4, dtype=np.float32), (len(yaws), 1, 1))
    for v, yaw in enumerate(yaws):
        c, s = np.cos(np.radians(yaw)), np.sin(np.radians(yaw))
        out[v, :3, :3] = [[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]]
    return out


def views_phase(counters: dict, rows: list, card: str) -> dict:
    """Phase 21: PIFu's multi-view netG on the f32 dense frame (module
    docstring). -> launches by kernel."""
    import numpy as np
    import torch

    from monoport_tpu_torch import evaluate, frame_check
    from monoport_tpu_torch.config import get_cfg_defaults
    from monoport_tpu_torch.engine import ReconEngine
    from monoport_tpu_torch.ops.cuda import fused_ray_mlp as tray
    from monoport_tpu_torch.training.datasets.capsule import render_front
    from monoport_tpu_torch.weights import DATA, build_net, load_params

    opt = get_cfg_defaults().netG.clone()
    opt.num_views = VIEWS
    params, _ = load_params(os.path.join(DATA, "netg_capsule.npz"))
    net = build_net(opt, params, "cuda")
    calibs = ring_calibs(RING_YAWS)
    a, b, r = evaluate.capsule_body(evaluate.BENCH_SEED, "cuda")
    images = []
    for c in calibs:
        rot = torch.as_tensor(c[:3, :3], device="cuda")
        images.append(render_front((a @ rot.T, b @ rot.T, r), 512)[0])
    images = torch.stack(images)
    recon, cfg = frame_check.quality_config(torch.float32)
    levels = len(recon.resolutions)
    res = recon.resolutions[-1]
    torch.cuda.reset_peak_memory_stats()
    eng = ReconEngine(net, None, recon=recon, config=cfg)
    run = lambda: eng.frame(images, None, calibs)
    run()                                  # warm-up: captures netG's graph
    torch.cuda.synchronize()
    syncs = find_syncs(run)
    if syncs:
        fail(f"a multi-view dense frame synchronised the stream at {syncs}")
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    times = []
    for _ in range(FRAMES):
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {name: fn.launches for name, fn in counters.items()}
    want = dict.fromkeys(counters, 0)
    want["fused_mlp"] = levels * FRAMES
    if launches != want:
        fail(f"multi-view dense frames launched {launches} in {FRAMES} "
             f"frames, expected the per-point MLP once a level, {want}")
    shapes = {"depth": (res, res), "valid": (res, res),
              "render_norm": (256, 256, 3), "mask": (256, 256, 1),
              "sdf": (res, res, res), "recon_counts": (levels - 1,)}
    got = {k: tuple(v.shape) for k, v in out.items()
           if k != "compact_dropped"}
    if got != shapes:
        fail(f"multi-view dense frame output shapes {got}")
    for k, v in (("depth", out["depth"][out["valid"]]),
                 ("render_norm", out["render_norm"])):
        if not torch.isfinite(v).all():
            fail(f"multi-view dense frame: non-finite {k}")
    counts = out["recon_counts"].tolist()
    med = statistics.median(times)
    emit({"phase": "views", "dtype": "f32", "views": VIEWS,
          "yaws": list(RING_YAWS), "frames": FRAMES,
          "frame_ms_median": med, "fps": 1e3 / med, "frame_ms": times,
          "launches_per_frame": {k: v / FRAMES for k, v in launches.items()},
          "host_syncs_per_frame": len(syncs), "recon_counts": counts,
          "budgets": list(recon.budgets[1:]),
          "valid_fraction": float(out["valid"].float().mean()),
          "peak_memory_mb": torch.cuda.max_memory_allocated() / 2 ** 20,
          "card": card})
    if any(c > b for c, b in zip(counts, recon.budgets[1:])):
        fail(f"the multi-view dense frame overflowed its budgets: {counts}")
    if not out["valid"].any():
        fail("the multi-view dense frame found no surface in view 0")

    # a projection and a view-pooled layer launch a chunk of every level
    kernels = profile_phase(eng, images, calibs, card, med, "views",
                            dtype="f32")
    calls = mlp_calls(kernels)
    pooled = sum(n for name, _, n in kernels if "views_mlp_kernel" in name)
    chunks = sum(ray_chunks(net, n * VIEWS, 1, tray.F32_BM, VIEWS)
                 for n in (recon.resolutions[0] ** 3, *recon.budgets[1:]))
    want_calls = {"wgmma_point": 0, "wgmma_ray": 0, "wgmma_anchor": 0,
                  "mix_rows": 0, "mlp_kernel": chunks,
                  "xproj_kernel": chunks}
    mlp_ms = sum(ms for name, ms, _ in kernels
                 if "views_mlp_kernel" in name or "xproj_kernel" in name)
    emit({"phase": "views_kernel_calls", "dtype": "f32", "per_frame": calls,
          "views_mlp_kernel": pooled, "expected": want_calls,
          "device_ms_per_frame": mlp_ms})
    if calls != want_calls or pooled != chunks:
        fail(f"the multi-view dense frame's device kernels a frame {calls} "
             f"({pooled} view-pooled): expected a projection and a "
             f"view-pooled layer launch a chunk, {want_calls}")

    # the same frame through the plain versions of the kernels on the card
    with plain_kernels():
        plain = run()
    torch.cuda.synchronize()
    both = out["valid"] & plain["valid"]
    cmp = {"sdf_max_diff": float((out["sdf"] - plain["sdf"]).abs().max()),
           "recon_counts_equal": counts == plain["recon_counts"].tolist(),
           "valid_disagree": float((out["valid"] != plain["valid"])
                                   .float().mean()),
           "depth_max_diff": float((out["depth"] - plain["depth"])[both]
                                   .abs().max()) if both.any() else 0.0}
    emit({"phase": "views_vs_plain", "dtype": "f32", **cmp, "card": card})
    if not (cmp["recon_counts_equal"] and cmp["sdf_max_diff"] <= 2e-3):
        fail(f"the multi-view dense frame against its plain-kernel run: "
             f"{cmp}")
    del plain

    # the kernel phase's view-pooled rows summed over the frame's levels
    mine = [r for r in rows if r["kernel"] == "fused_mlp_views"]
    entry = {"phase": "views_kernel", "name": "fused_mlp_views",
             "route": "cuda", "source": os.path.join(CSRC, "fused_mlp.cu"),
             "dtype": "f32", "views": VIEWS, "launches_per_frame": levels,
             "ms": sum(r["ms"] for r in mine),
             "plain_ms": sum(r["plain_ms"] for r in mine),
             "bound_ms": sum(r["bound_ms"] for r in mine),
             "bound_by": "operations" if all(
                 r["bound_by"] == "operations" for r in mine) else "bytes",
             "library_ms": None,
             "max_abs_err": max(r["max_abs_err"] for r in mine),
             "recompute": mine[0]["recompute"],
             "frame_device_ms": mlp_ms, "card": card}
    entry["roofline"] = entry["bound_ms"] / entry["ms"]
    emit(entry)
    del eng, net, out
    torch.cuda.empty_cache()
    return launches


# phase 16: the engine's mesh and the data-parallel step. The two ranks
# share the one card over gloo, which carries CUDA tensors through the
# host: a run of the sharded paths for correctness, no scaling figure.
SHARDED_FRAMES = 2
# SGD (its update is linear in the gradient: Adam's first update is about
# lr * sign(g), which a rounding-noise gradient flips) with momentum
SHARDED_TX = dict(optim="sgd", learning_rate=0.5, momentum=0.9)
# the JAX package's tolerance for its sharded step (tests/test_sharding.py)
SHARDED_STEP_LIMITS = {"loss_atol": 1e-6, "atol": 5e-5, "rtol": 5e-3}


def _step_close(got: dict, want: dict) -> dict:
    """The largest |difference| over every tensor of two state dicts, and
    whether all are within SHARDED_STEP_LIMITS."""
    import torch

    worst, ok = 0.0, True
    for k, w in want.items():
        g, w = got[k].double(), w.double()
        d = (g - w).abs()
        worst = max(worst, float(d.max()) if d.numel() else 0.0)
        ok &= bool((d <= SHARDED_STEP_LIMITS["atol"]
                    + SHARDED_STEP_LIMITS["rtol"] * w.abs()).all())
    return {"max_abs_diff": worst, "within": ok}


def _small_bn_netg():
    """A small netG with train-mode BatchNorm (1-stack HGFilter at 32
    channels), weights seeded on the CPU."""
    import torch

    from monoport_tpu_torch.config import CN
    from monoport_tpu_torch.models.monoport_net import (MonoPortNet,
                                                        head_channels_for)
    from monoport_tpu_torch.parallel import train_step as ts

    opts = CN({"projection": "orthogonal",
               "normalizer": {"IMF": "PIFuNomalizer"},
               "backbone": {"IMF": "PIFuHGFilters", "num_stack": 1,
                            "num_hourglass": 1, "hourglass_dim": 32,
                            "norm": "batch_train", "hg_down": "ave_pool"},
               "head": {"IMF": "PIFuNetGMLP"}, "loss": {"IMF": "MSE"}})
    net = MonoPortNet(opts, head_channels_for(opts))
    return ts.init_params(net, torch.Generator().manual_seed(0)).cuda()


def _small_bn_batch() -> dict:
    """4 images at 128^2 and 2048 points an image, numpy-seeded."""
    import numpy as np
    import torch

    rng = np.random.RandomState(0)
    batch = {"images": rng.rand(4, 128, 128, 3) * 2 - 1,
             "points": rng.uniform(-1.0, 1.0, (4, 2048, 3)),
             "calibs": np.tile(np.eye(4), (4, 1, 1)),
             "labels": (rng.rand(4, 2048, 1) > 0.5) * 1.0}
    return {k: torch.from_numpy(v.astype(np.float32)).cuda()
            for k, v in batch.items()}


def _one_step(make_net, batch: dict, mesh) -> dict:
    """One step of a fresh ``make_net()`` on ``batch`` (under ``mesh``, or
    none). -> its loss, its state dict on the host, its ms."""
    import torch

    from monoport_tpu_torch.parallel import train_step as ts

    net = make_net()
    state = ts.create_train_state(net, ts.make_optimizer(**SHARDED_TX),
                                  mesh=mesh)
    step = ts.make_train_step(net, mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, loss = step(state, batch)
    torch.cuda.synchronize()
    out = {"ms": (time.perf_counter() - t0) * 1e3, "loss": float(loss),
           "state": {k: v.detach().cpu() for k, v in
                     net.state_dict().items()}}
    del net, state, step
    torch.cuda.empty_cache()
    return out


def _committed_netg():
    """-> a maker of fresh copies of the committed netG (on the card)."""
    from monoport_tpu_torch import weights
    from monoport_tpu_torch.config import get_cfg_defaults

    params = weights.load_params(os.path.join(weights.DATA,
                                              "netg_capsule.npz"))[0]
    return lambda: weights.build_net(get_cfg_defaults().netG, params, "cuda")


def _record_heads(fn):
    """The kernel calls (name, kernel, packed, inputs) that ``fn()``
    makes through the engine's three MLP wrappers."""
    from monoport_tpu_torch import engine

    calls = []
    kept = {k: getattr(engine, k)
            for k in ("apply_ray", "apply_anchor", "apply_mlp")}

    def recorder(name, kernel):
        def record(packed, *args):
            calls.append((name, kernel, packed, args))
            return kernel(packed, *args)
        return record

    for name, kernel in kept.items():
        setattr(engine, name, recorder(name, kernel))
    try:
        fn()
    finally:
        for name, kernel in kept.items():
            setattr(engine, name, kernel)
    return calls


def sharded_rank(rank: int, tmp: str) -> None:
    """Phase 16b, one of two gloo ranks on the one card: the committed nets
    through the bf16 real-time engine on a ``points`` mesh of 2, frontal
    and rotated; the phase-13 netG's and a small BatchNorm netG's step on
    a ``data`` mesh of 2 (f32, TF32 off). Writes its readings to
    ``tmp/rank<r>.pt``."""
    import functools

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=2)
    try:
        from monoport_tpu_torch import frame_check, weights
        from monoport_tpu_torch.engine import ReconEngine
        from monoport_tpu_torch.ops.cuda import fused_gather_mlp as tgather
        from monoport_tpu_torch.ops.cuda import fused_mlp as tmlp
        from monoport_tpu_torch.ops.cuda import fused_ray_mlp as tray
        from monoport_tpu_torch.ops.cuda import mix_rows
        from monoport_tpu_torch.parallel.mesh import make_mesh
        from monoport_tpu_torch.parallel.train_step import timed_convolutions

        counters = {"fused_ray_mlp": tray.apply_ray,
                    "fused_mlp": tmlp.apply_mlp,
                    "fused_anchor_mlp": tray.apply_anchor,
                    "fused_gather_mlp": tgather.apply_gather_ray,
                    "mix_rows": mix_rows.launch_mix_rows}
        netG, netC = weights.load_default_networks()
        recon, cfg = frame_check.rtl_config(torch.bfloat16)
        single = ReconEngine(netG, netC, recon=recon, config=cfg)
        sharded = ReconEngine(netG, netC, recon=recon, config=cfg,
                              mesh=make_mesh(2))
        golden = frame_check.load_golden()
        image = torch.from_numpy(golden["image"]).cuda()
        views = {"frontal": (golden["calib"], FRONTAL_EXPECT),
                 "rotated": (frame_check.rotated_calib(), None)}
        res = {"frames": {}}
        for view, (calib, expect) in views.items():
            if expect is None:
                expect = rotated_expect(single._rot_anchor_plan(
                    calib, image.shape[1]))
            calls = _record_heads(lambda: single.frame(image, image, calib))
            heads = []
            for name, kernel, packed, args in calls:
                full = kernel(packed, *args)
                part = sharded._shard_rows(
                    functools.partial(kernel, packed))(*args)
                heads.append({"kernel": name, "rows": int(args[0].shape[1]),
                              "bit_equal": bool(torch.equal(full, part))})
            ref = single.frame(image, image, calib)
            sharded.frame(image, image, calib)                # warm-up
            torch.cuda.synchronize()
            for fn in counters.values():
                fn.launches = 0
            times = []
            for _ in range(SHARDED_FRAMES):
                t0 = time.perf_counter()
                out = sharded.frame(image, image, calib)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            launches = {k: fn.launches for k, fn in counters.items()}
            want = {k: expect[k] * SHARDED_FRAMES for k in launches}
            diffs = {k: float((out[k].float() - ref[k].float()).abs().max())
                     for k in ref if k != "compact_dropped"}
            res["frames"][view] = {
                "heads": heads, "launches": launches,
                "launches_expected": want, "frame_ms": times,
                "max_abs_diff": diffs,
                "vs_single": frame_check.compare_to_golden(
                    out, as_golden(ref), frame_check.BF16_LIMITS),
                "compact_dropped_equal": bool(torch.equal(
                    out["compact_dropped"], ref["compact_dropped"]))
                if "compact_dropped" in ref else None}
        del single, sharded
        torch.cuda.empty_cache()

        # the steps on cuDNN's timed algorithms, as phase 13's; not the
        # frames: each process times its own picks, and a frame whose ranks
        # sample features through different convolution algorithms gathers
        # rows computed from other features than its own
        timed_convolutions("cuda")
        # rank 0 also runs the single-card step on the global batch
        data = make_mesh(2, dp=2)
        golden = dict(np.load(frame_check.GOLDEN_TRAIN))
        res["train"] = {}
        for name, make, batch in (
                ("netG", _committed_netg(), _train_batch(golden, "g")),
                ("bn_netG", _small_bn_netg, _small_bn_batch())):
            res["train"][name] = {
                "plain": _one_step(make, batch, None) if rank == 0
                else None, "mesh": _one_step(make, batch, data)}
        torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def sharded_world1(netG, netC, counters: dict, card: str) -> dict:
    """Phase 16a: a world of one rank on NCCL (a file store under a
    temporary directory): the bf16 frontal and rotated frames of engines
    on ``make_mesh(1)`` bit-equal to the unmeshed engine's, with the
    launches of phases 4 and 5 and no stream sync; one phase-13 netG step
    on that mesh against the step without one. -> the frames' launches."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from monoport_tpu_torch import frame_check
    from monoport_tpu_torch.engine import ReconEngine
    from monoport_tpu_torch.parallel.mesh import make_mesh

    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        total: dict = {}
        try:
            mesh = make_mesh(1)
            recon, cfg = frame_check.rtl_config(torch.bfloat16)
            single = ReconEngine(netG, netC, recon=recon, config=cfg)
            eng = ReconEngine(netG, netC, recon=recon, config=cfg, mesh=mesh)
            golden = frame_check.load_golden()
            image = torch.from_numpy(golden["image"]).cuda()
            calib = frame_check.rotated_calib()
            for view, c, expect in (
                    ("frontal", golden["calib"], FRONTAL_EXPECT),
                    ("rotated", calib, rotated_expect(
                        single._rot_anchor_plan(calib, image.shape[1])))):
                ref = single.frame(image, image, c)
                out, _, launches = timed_frames(eng, image, c, counters,
                                                expect, f"{view}_mesh1", card)
                for k, n in launches.items():
                    total[k] = total.get(k, 0) + n
                same = {k: bool(torch.equal(out[k], ref[k])) for k in ref}
                emit({"phase": "sharded_world1", "view": view,
                      "backend": dist.get_backend(), "mesh": mesh.shape,
                      "bit_equal": same, "card": card})
                if not all(same.values()):
                    fail(f"the {view} frame on a world-1 mesh differs from "
                         f"the unmeshed frame: {same}")
            make = _committed_netg()
            batch = _train_batch(dict(np.load(frame_check.GOLDEN_TRAIN)),
                                 "g")
            plain = _one_step(make, batch, None)
            meshed = _one_step(make, batch, mesh)
            rerun = _one_step(make, batch, None)
            same = all(torch.equal(meshed["state"][k], v)
                       for k, v in plain["state"].items())
            rerun_same = all(torch.equal(rerun["state"][k], v)
                             for k, v in plain["state"].items())
            close = _step_close(meshed["state"], plain["state"])
            emit({"phase": "sharded_world1", "view": "train_step",
                  "loss": meshed["loss"], "plain_loss": plain["loss"],
                  "bit_equal": same, "plain_rerun_bit_equal": rerun_same,
                  "max_abs_diff": close["max_abs_diff"],
                  "plain_rerun_max_abs_diff": _step_close(
                      rerun["state"], plain["state"])["max_abs_diff"],
                  "step_ms": meshed["ms"], "card": card})
            if meshed["loss"] != plain["loss"]:
                fail("the world-1 mesh step's loss differs from the plain "
                     "step's")
            # the mesh step of a world of one runs the plain step's code;
            # where two plain steps differ too (atomic adds in a backward),
            # it is held to the sharded step's tolerance instead
            if not same and (rerun_same or not close["within"]):
                fail(f"the world-1 mesh step differs from the plain step "
                     f"(plain rerun bit-equal: {rerun_same}): {close}")
        finally:
            dist.destroy_process_group()
    return total


def sharded_phase(netG, netC, counters: dict, card: str) -> dict:
    """Phase 16 (module docstring). -> launches by kernel: this process's
    world-1 frames and both ranks' sharded frames."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    total = sharded_world1(netG, netC, counters, card)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mp.spawn(sharded_rank, args=(tmp,), nprocs=2, join=True)
        wall = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False) for r in range(2)]
    timing = {"wall_s": wall, "card": card}
    for r, res in enumerate(ranks):
        for view, v in res["frames"].items():
            heads = v["heads"]
            emit({"phase": "sharded", "rank": r, "view": view,
                  "backend": "gloo", "head_calls": len(heads),
                  "heads_bit_equal": sum(h["bit_equal"] for h in heads),
                  "head_rows": [h["rows"] for h in heads],
                  "launches": v["launches"],
                  "launches_expected": v["launches_expected"],
                  "max_abs_diff": v["max_abs_diff"],
                  "vs_single": v["vs_single"],
                  "compact_dropped_equal": v["compact_dropped_equal"]})
            timing[f"rank{r}_{view}_frame_ms"] = v["frame_ms"]
            for k, n in v["launches"].items():
                total[k] = total.get(k, 0) + n
            if not heads or not all(h["bit_equal"] for h in heads):
                fail(f"rank {r}: a sharded {view} head call differs from "
                     f"the unsharded call: {heads}")
            if v["launches"] != v["launches_expected"]:
                fail(f"rank {r}: sharded {view} frames launched "
                     f"{v['launches']}, expected {v['launches_expected']}")
            if not v["vs_single"]["ok"] or v["compact_dropped_equal"] is \
                    False:
                fail(f"rank {r}: the sharded {view} frame is off the "
                     f"single-card frame: {v['vs_single']}")
        for name, t in res["train"].items():
            plain = ranks[0]["train"][name]["plain"]
            mine = t["mesh"]
            close = _step_close(mine["state"], plain["state"])
            peer = ranks[0]["train"][name]["mesh"]["state"]
            equal = all(torch.equal(mine["state"][k], v)
                        for k, v in peer.items())
            loss_diff = abs(mine["loss"] - plain["loss"])
            emit({"phase": "sharded_train", "rank": r, "net": name,
                  "mesh": {"data": 2, "points": 1}, "loss": mine["loss"],
                  "plain_loss": plain["loss"], "loss_abs_diff": loss_diff,
                  **close, "ranks_equal": equal,
                  "limits": SHARDED_STEP_LIMITS})
            timing[f"rank{r}_{name}_step_ms"] = mine["ms"]
            if r == 0:
                timing[f"{name}_single_step_ms"] = plain["ms"]
            if loss_diff > SHARDED_STEP_LIMITS["loss_atol"] or \
                    not close["within"] or not equal:
                fail(f"rank {r}: the dp=2 {name} step is off the "
                     f"single-card step: loss {loss_diff}, {close}, "
                     f"ranks equal {equal}")
    emit({"phase": "sharded_times", **timing,
          "note": "two gloo ranks sharing one card: no scaling figure"})
    return total


def softonehot_phase(netC, counters: dict, card: str) -> dict:
    """The seeded soft-onehot netG (``tests/torch_reference_state``'s
    ``soft_netg``) with the committed netC
    at the real-time operating point: no ray, grid or anchored query for
    netG. A frontal frame takes the hierarchy, then ``ray_refine`` per
    point (the per-point MLP once a level and once for the refine, the ray
    MLP once for netC's grid colour query); a rotated frame marches and
    refines per point (the per-point MLP for the march and each refine
    level, no other kernel). bf16 frames timed, the counts zeroed and read
    around them, no stream sync; the bf16 and the f32 frame of each view
    held to the same frame through the plain kernels on the card; the f32
    frontal frame held to the JAX golden
    (``data/frame_golden_softonehot.npz``, ``F32_SOFT_LIMITS``; its volume
    and ``recon_counts`` too). -> launches by kernel."""
    import torch

    from monoport_tpu_torch import frame_check
    from monoport_tpu_torch.engine import ReconEngine

    net = reference_helper().soft_netg("cuda")
    golden = frame_check.load_golden(frame_check.GOLDEN_SOFTONEHOT)
    image = torch.from_numpy(frame_check.load_golden()["image"]).cuda()
    engines = {}
    for dname, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        recon, cfg = frame_check.rtl_config(dtype)
        engines[dname] = ReconEngine(net, netC, recon=recon, config=cfg)
    eng = engines["bf16"]
    if eng.head_g is not None or eng.anchor_g is not None \
            or eng.head_c is None:
        fail("the soft-onehot netG was given a ray-structured head")
    rc = eng.recon.resolutions[-1]
    n_levels = len(eng.recon.resolutions)
    views = {
        "frontal": (golden["calib"],
                    {"fused_mlp": n_levels + 1, "fused_ray_mlp": 1},
                    {**FRAME_SHAPES, "sdf": (rc, rc, rc),
                     "recon_counts": (n_levels - 1,)}),
        "rotated": (frame_check.rotated_calib(),
                    {"fused_mlp": 1 + len(eng._refine_pairs())},
                    FRAME_SHAPES)}
    total = dict.fromkeys(counters, 0)
    for view, (calib, launched, shapes) in views.items():
        expect = {**dict.fromkeys(counters, 0), **launched}
        out, _, launches = timed_frames(eng, image, calib, counters, expect,
                                        f"softonehot_{view}", card, shapes,
                                        depth_on_valid=True)
        for k, n in launches.items():
            total[k] += n
        emit({"phase": "softonehot", "view": view,
              "launches_per_frame_expected": expect,
              "valid_fraction": float(out["valid"].float().mean()),
              **({"band_report": eng.band_report(out)}
                 if "recon_counts" in out else {}),
              **({"compact_report": eng.compact_report(out)}
                 if "compact_dropped" in out else {})})
        for dname, limits in (("bf16", frame_check.BF16_LIMITS),
                              ("f32", frame_check.F32_LIMITS)):
            e = engines[dname]
            got = out if dname == "bf16" else e.frame(image, image, calib)
            with plain_kernels():
                want = e.frame(image, image, calib)
            torch.cuda.synchronize()
            cmp = frame_check.compare_to_golden(got, as_golden(want), limits)
            emit({"phase": "softonehot_vs_plain", "view": view,
                  "dtype": dname, **cmp, "limits": limits._asdict(),
                  "note": "random-weight net: not a quality result",
                  "card": card})
            if not cmp["ok"]:
                fail(f"{dname} soft-onehot {view} frame disagrees with its "
                     f"plain-kernel run: {cmp}")
            if view == "frontal" and dname == "f32":
                limits = frame_check.F32_SOFT_LIMITS
                res = frame_check.compare_to_golden(got, golden, limits)
                sdf = frame_check.compare_sdf(got, golden)
                counts = got["recon_counts"].tolist()
                drift = max(abs(a - b) / max(b, 1) for a, b in
                            zip(counts, golden["recon_counts"].tolist()))
                emit({"phase": "golden", "view": "softonehot_frontal",
                      "dtype": "f32", **res,
                      **{k: v for k, v in sdf.items() if k != "ok"},
                      "sdf_ok": sdf["ok"], "recon_counts": counts,
                      "golden_recon_counts":
                      golden["recon_counts"].tolist(),
                      "limits": limits._asdict(), "card": card})
                if not (res["ok"] and sdf["ok"] and drift <= 2e-3):
                    fail(f"f32 soft-onehot frontal frame disagrees with the "
                         f"JAX golden: {res} {sdf} {counts}")
            del want
    del engines, eng, net
    torch.cuda.empty_cache()
    return total


def wide_head_phase(netG, netC, counters: dict, card: str) -> dict:
    """The wide netG (``tests/torch_reference_state.wide_netg``: the
    committed HGFilter under a seeded ``WIDE_NETG_HEAD`` head, which the
    in-place bf16 kernel cannot hold) with the committed netC: the
    frontal, rotated and dense frames at full width, bf16 timed with the
    counts zeroed and read around them (the launches of phases 4-6: the
    pose's plan), no stream sync; each frame in bf16 and f32 held to the
    same frame through the plain kernels on the card at the view's
    ``frame_check`` limits (f32: ``recon_counts`` equal). Then the
    committed netG's head forced into both scratch modes at the frontal
    refine's and the dense level's shapes: bit-equal to the in-place
    kernels. -> launches by kernel."""
    import numpy as np
    import torch

    from monoport_tpu_torch import frame_check
    from monoport_tpu_torch.engine import ReconEngine
    from monoport_tpu_torch.ops.cuda import fused_mlp as tmlp
    from monoport_tpu_torch.ops.cuda import fused_ray_mlp as tray

    net = reference_helper().wide_netg("cuda")
    head = net.surface_classifier
    modes = {"bf16_ray": kernel_mode(tray.pack_ray_mlp_params(head), "bf16"),
             "bf16_point": kernel_mode(tmlp.pack_mlp_params(head), "bf16"),
             "f32": kernel_mode(tray.pack_ray_mlp_params(
                 head, torch.float32), "f32")}
    if set(modes.values()) != {"scratch", "activation_scratch"}:
        fail(f"the wide head does not run the scratch modes: {modes}")
    image = torch.from_numpy(frame_check.load_golden()["image"]).cuda()
    eye = frame_check.load_golden()["calib"]
    zero = dict.fromkeys(counters, 0)
    total = dict(zero)
    dense_recon = frame_check.quality_config()[0]
    levels = len(dense_recon.resolutions)
    rd = frame_check.QUALITY_RESOLUTIONS[-1]
    views = {"frontal": (frame_check.rtl_config, eye,
                         frame_check.BF16_LIMITS),
             "rotated": (frame_check.rtl_config, frame_check.rotated_calib(),
                         frame_check.BF16_ROTATED_LIMITS),
             "dense": (frame_check.quality_config, eye,
                       frame_check.BF16_DENSE_LIMITS)}
    for view, (config, calib, limits16) in views.items():
        engines = {}
        for dname, dtype in (("bf16", torch.bfloat16),
                             ("f32", torch.float32)):
            recon, cfg = config(dtype)
            engines[dname] = ReconEngine(net, netC, recon=recon, config=cfg)
        eng = engines["bf16"]
        shapes, expect = FRAME_SHAPES, dict(FRONTAL_EXPECT)
        if view == "rotated":
            plan = eng._rot_anchor_plan(calib, image.shape[1])
            expect = rotated_expect(plan)
        elif view == "dense":
            expect = {**zero, "fused_ray_mlp": 1, "fused_mlp": levels}
            shapes = {**FRAME_SHAPES, "sdf": (rd, rd, rd),
                      "recon_counts": (levels - 1,)}
        out, med, launches = timed_frames(
            eng, image, calib, counters, expect, f"wide_{view}", card,
            shapes, depth_on_valid=view == "dense")
        for k, n in launches.items():
            total[k] += n
        emit({"phase": "wide_head", "view": view, "head": list(
            reference_helper().WIDE_NETG_HEAD), "modes": modes,
              "launches_per_frame_expected": expect,
              "valid_fraction": float(out["valid"].float().mean()),
              **({"recon_counts": out["recon_counts"].tolist(),
                  "budgets": list(eng.recon.budgets[1:])}
                 if "recon_counts" in out else {}),
              **({"compact_dropped": out["compact_dropped"].tolist()}
                 if "compact_dropped" in out else {})})
        for dname, limits in (("bf16", limits16),
                              ("f32", frame_check.F32_LIMITS)):
            e = engines[dname]
            got = out if dname == "bf16" else e.frame(image, image, calib)
            with plain_kernels():
                want = e.frame(image, image, calib)
            torch.cuda.synchronize()
            cmp = frame_check.compare_to_golden(got, as_golden(want), limits)
            same = {k: got[k].tolist() == want[k].tolist()
                    for k in ("recon_counts", "compact_dropped") if k in got}
            emit({"phase": "wide_head_vs_plain", "view": view,
                  "dtype": dname, **cmp, "equal": same,
                  "limits": limits._asdict(),
                  "note": "random-weight head: not a quality result",
                  "card": card})
            if not cmp["ok"]:
                fail(f"{dname} wide-head {view} frame disagrees with its "
                     f"plain-kernel run: {cmp}")
            if dname == "f32" and not all(same.values()):
                fail(f"f32 wide-head {view} frame against its plain-kernel "
                     f"run: {same}")
            del want
        del engines, eng, out
        torch.cuda.empty_cache()

    # the published head forced through the scratch modes: the same
    # products in the same order as in place, so bit-equal
    rng = np.random.RandomState(14)
    feat = torch.from_numpy(rng.randn(1, 192 * 192, 256).astype(
        np.float32)).cuda()
    z = torch.from_numpy(rng.uniform(-1.3, 1.3, (1, 192 * 192, 6)).astype(
        np.float32)).cuda()
    x = torch.from_numpy(rng.randn(1, 65536, 257).astype(np.float32)).cuda()
    for dname, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        pr = tray.pack_ray_mlp_params(netG.surface_classifier, dtype,
                                      "cuda")
        pm = tmlp.pack_mlp_params(netG.surface_classifier, dtype, "cuda")
        run = lambda: (tray.apply_ray(pr, feat, z), tmlp.apply_mlp(pm, x))
        base = run()
        with forced_scratch():
            forced = run()
            torch.cuda.synchronize()
        equal = [bool(torch.equal(a, b)) for a, b in zip(base, forced)]
        emit({"phase": "wide_head_scratch_vs_in_place", "dtype": dname,
              "shapes": ["refine257 ray 36864 x 6", "level 65536 points"],
              "bit_equal": equal, "card": card})
        if not all(equal):
            fail(f"{dname}: the scratch modes change netG's outputs: "
                 f"{equal}")
    del net
    torch.cuda.empty_cache()
    return total


def gather_phase(counters: dict) -> int:
    """The gathering kernel's entry point, at the netG head and at the
    wide netG's (``WIDE_NETG_HEAD``: the scratch mode). -> its launches
    there."""
    from monoport_tpu_torch import profile_gather

    total = 0
    for chans in (profile_gather.CH, reference_helper().WIDE_NETG_HEAD):
        for fn in counters.values():
            fn.launches = 0
        res = profile_gather.run(chans=chans)
        launches = {name: fn.launches for name, fn in counters.items()}
        emit({"phase": "gather_ab", **res, "launches": launches})
        if launches["fused_gather_mlp"] < 1 or \
                launches["fused_ray_mlp"] < 1:
            fail(f"the gather A/B launched {launches}")
        total += launches["fused_gather_mlp"]
    return total


def read_part(res) -> bytes:
    """One JPEG part of a multipart MJPEG response (after the CRLF that
    ends the part before it)."""
    line = res.readline()
    if line == b"\r\n":
        line = res.readline()
    if line != b"--frame\r\n":
        fail(f"an MJPEG part starts with {line[:40]!r}, not its boundary")
    if not res.readline().lower().startswith(b"content-type: image/jpeg"):
        fail("an MJPEG part is not image/jpeg")
    res.readline()
    data = b""
    while not data.endswith(b"\xff\xd9"):
        byte = res.read(1)
        if not byte:
            fail("an MJPEG part ended before its EOI marker")
        data += byte
    return data


def jpeg_size(data: bytes) -> tuple[int, int]:
    """(height, width) of a JPEG's SOF0; fails on anything else."""
    if data[:2] != b"\xff\xd8" or data[-2:] != b"\xff\xd9":
        fail("a served part lacks its SOI / EOI markers")
    i = 2
    while i + 4 <= len(data):
        marker, n = data[i + 1], int.from_bytes(data[i + 2:i + 4], "big")
        if marker == 0xC0:
            return (int.from_bytes(data[i + 5:i + 7], "big"),
                    int.from_bytes(data[i + 7:i + 9], "big"))
        i += 2 + n
    fail("a served part has no SOF0 (baseline) header")


def serve_phase(counters: dict, card: str) -> dict:
    """The demo server on the card (phase 11). -> launches by kernel."""
    import http.client
    import threading

    import numpy as np
    import torch

    from monoport_tpu_torch import frame_check
    from monoport_tpu_torch.apps import infer, rtl_main

    golden = frame_check.load_golden(frame_check.GOLDEN_SERVE)
    frame = golden["frame"].astype(np.float32) / 255.0
    args, cfg = rtl_main.parse_args(["--camera"])
    if cfg.tpu.compute_dtype != "bfloat16":
        fail(f"the demo profile computes in {cfg.tpu.compute_dtype}")
    state = rtl_main.FrameState()
    server = rtl_main.make_server(state, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    served, stamps = [], []

    def on_frame(d):
        served.append(d)
        stamps.append(time.perf_counter())

    try:
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        n = rtl_main.main_loop(args, cfg, state,
                               stream=[frame] * SERVE_FRAMES,
                               on_frame=on_frame)
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        pipeline = state.pipeline
        seg, eng = pipeline.segmentation, pipeline.engine
        if seg.net is None or seg.detector is None:
            fail("the demo's segmenter fell back to the box prior")
        if n != SERVE_FRAMES:
            fail(f"the demo served {n} of {SERVE_FRAMES} frames")

        # every served pose's launches, from its anchor plan
        expect = dict.fromkeys(counters, 0)
        plans = []
        for d in served:
            if eng._calib_taps_ok(d["calib"]):
                fail("an AUTO pose took the ray-tap path")
            plan = eng._rot_anchor_plan(d["calib"], frame.shape[0])
            plans.append([k or 0 for k in plan])
            expect["fused_mlp"] += 1 + sum(1 for k in plan if not k)
            expect["fused_anchor_mlp"] += sum(1 for k in plan if k)
            expect["mix_rows"] += sum(1 for k in plan if k)
        if launches != expect:
            fail(f"the served frames launched {launches}, their poses' "
                 f"plans imply {expect}")
        # the backbones a call a frame, the march pyramid's stages one a
        # level and the march; none eager, one capture a signature
        graphs = {k: dict(v) for k, v in eng.graphs.counts.items()}
        calls = {k: n * (1 + len(eng.march_levels) if k == "recon" else 1)
                 for k in graphs}
        if any(v["eager"] or v["capture"] + v["replay"] != calls[k]
               for k, v in graphs.items()) or len(eng.graphs._graphs) != sum(
                   v["capture"] for v in graphs.values()):
            fail(f"the served engine's graphed calls by mode {graphs}, "
                 f"{len(eng.graphs._graphs)} signatures")
        segment, device_frame, _ = pipeline.processors
        d = segment(frame)
        # the next pose may take a stage key of its own, whose capture
        # synchronises: check its replay
        device_frame(dict(d))
        torch.cuda.synchronize()
        syncs = find_syncs(lambda: device_frame(d))
        if syncs:
            fail(f"the device stage synchronised the stream at {syncs}")

        # the server: the page and two stream parts
        port = server.server_address[1]
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("GET", "/")
        page = conn.getresponse()
        body = page.read()
        conn.close()
        if page.status != 200 or b"/video_feed" not in body:
            fail(f"'/' answered {page.status}")
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("GET", "/video_feed")
        res = conn.getresponse()
        parts = [read_part(res) for _ in range(2)]
        conn.close()
        sizes = [jpeg_size(p) for p in parts]
        if res.status != 200 or sizes != [(256, 256)] * 2:
            fail(f"/video_feed answered {res.status}, parts {sizes}")
    finally:
        server.shutdown()
        server.server_close()

    # the first served frame against the JAX app's (f32, CPU)
    first = served[0]
    if not np.array_equal(first["calib"], golden["calib"]):
        fail("the first served pose is not the serve golden's")
    limits = frame_check.BF16_ROTATED_LIMITS
    res = frame_check.compare_display(first, golden, limits)
    matte = float(np.abs(first["segm"][0, ..., 3].float().cpu().numpy()
                         - golden["segm_alpha"]).max())
    box = first["bboxes"][0].cpu().numpy().tolist()
    gaps = np.diff(stamps[1:])
    stages = {st.name: {"median_ms": st.median_ms, "ema_ms": st.ema_ms,
                        "ms": list(st.recent_ms), "frames": st.frames}
              for st in pipeline.stats}
    emit({"phase": "serve", "dtype": "bf16", "frames": n, "wall_s": wall,
          "served_fps": (len(stamps) - 2) / (stamps[-1] - stamps[1]),
          "frame_gap_ms_median": float(np.median(gaps)) * 1e3,
          "stages": stages,
          "jpeg_ms": [d["jpeg_ms"] for d in served],
          "jpeg_ms_median": statistics.median(d["jpeg_ms"] for d in served),
          "jpeg_bytes": len(parts[0]), "anchor_plans": plans,
          "launches": launches, "launches_expected": expect,
          "device_stage_syncs": len(syncs), "graphs": graphs,
          "matte_max_diff": matte, "bbox": box,
          "golden_bbox": golden["bbox"].tolist(), **res,
          "limits": limits._asdict(), "card": card})
    print(pipeline.report(), flush=True)
    if not res["ok"]:
        fail(f"the first served frame disagrees with the serve golden: {res}")
    if matte > 2e-2:
        fail(f"the card's matte is {matte} from the serve golden's")

    # single image -> mesh on the same frame (plain heads, f32)
    _, icfg = infer.parse_args(["--image", "in-memory"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    verts, faces, colors = infer.reconstruct_image(frame, icfg)
    seconds = time.perf_counter() - t0
    n_edges, n_away, closed = closed_share(verts, faces,
                                           icfg.recon.resolutions[-1])
    emit({"phase": "infer", "vertices": int(len(verts)),
          "faces": int(len(faces)), "edges_away_from_border": n_away,
          "edges_shared_by_two_faces": closed, "seconds": seconds,
          "colored": colors is not None, "card": card})
    if len(faces) < 1000 or closed < 0.999 or colors is None \
            or not np.isfinite(colors).all():
        fail(f"infer's mesh: {len(faces)} faces, {closed} closed, colours "
             f"{'absent' if colors is None else 'present'}")
    return launches


def legacy_phase(netG, netC, frontal: dict, card: str) -> None:
    """Phase 12, legacy checkpoints: the committed nets written as legacy
    PIFu files (reference key names) and read back through
    ``rtl_main.load_networks``: every tensor equal to the committed nets',
    and their bf16 frontal frame equal to phase 4's."""
    import tempfile

    import torch

    from monoport_tpu_torch import frame_check
    from monoport_tpu_torch.apps import rtl_main
    from monoport_tpu_torch.engine import ReconEngine

    helper = reference_helper()
    with tempfile.TemporaryDirectory() as tmp:
        opts = []
        for key, net in (("netG", netG), ("netC", netC)):
            path = os.path.join(tmp, f"{key}.pth")
            state = {k: v.cpu() for k, v in net.state_dict().items()}
            torch.save(helper.reference_state(
                state, net.opt_net.backbone.IMF), path)
            opts += [f"{key}.ckpt_path", path]
        _, cfg = rtl_main.parse_args(["--camera", "--"] + opts)
        t0 = time.perf_counter()
        loaded = rtl_main.load_networks(cfg)
        load_s = time.perf_counter() - t0
    if loaded[1] is None:
        fail("load_networks loaded no netC from its checkpoint")
    differ = [f"{key}.{k}" for key, net, got in zip(
        ("netG", "netC"), (netG, netC), loaded)
        for k, v in net.state_dict().items()
        if not torch.equal(got.state_dict()[k], v)]
    golden = frame_check.load_golden()
    image = torch.from_numpy(golden["image"]).cuda()
    recon, cfg_e = frame_check.rtl_config(torch.bfloat16)
    out = ReconEngine(*loaded, recon=recon, config=cfg_e).frame(
        image, image, golden["calib"])
    torch.cuda.synchronize()
    same = {k: bool(torch.equal(out[k], frontal[k])) for k in FRAME_SHAPES}
    emit({"phase": "legacy_checkpoint", "load_s": load_s,
          "tensors": sum(len(n.state_dict()) for n in loaded),
          "tensors_differing": differ, "frame_bit_equal_to_phase4": same,
          "card": card})
    if differ:
        fail(f"the legacy checkpoints loaded other tensors: {differ[:5]}")
    if not all(same.values()):
        fail(f"the legacy checkpoints' frame differs from phase 4's: {same}")


def device_ms(fn, reps: int) -> float:
    """Device time a call of ``fn`` (torch.profiler's kernel times summed
    over ``reps`` calls after a warm-up)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) \
        / 1e3 / reps


def backbones_phase(netG, counters: dict, card: str) -> dict:
    """Phase 12, the alternative backbones at full width: each netG of
    ``ALT_NETGS`` (HRNet / Yolov4, BatchNorm, numpy-seeded weights) saved
    as a reference-layout checkpoint and read by ``load_networks`` with
    ``norm: batch`` (no netC, as the app loads none for it); its f32
    backbone against the JAX golden; bf16 frontal frames timed (the ray
    MLP's launches counted, no other kernel of ours, no stream sync) and
    profiled; an f32 and the bf16 frame held to the f32 frame through the
    plain kernels on the card. The backbones' device time beside the
    committed HGFilter's. -> launches by kernel."""
    import copy
    import tempfile

    import torch

    from monoport_tpu_torch import frame_check
    from monoport_tpu_torch.apps import rtl_main
    from monoport_tpu_torch.engine import ReconEngine

    helper = reference_helper()
    golden = frame_check.load_golden()
    golden_bb = frame_check.load_golden(frame_check.GOLDEN_BACKBONE)
    image = torch.from_numpy(golden["image"]).cuda()
    calib = golden["calib"]
    shapes = {k: v for k, v in FRAME_SHAPES.items() if k != "render_tex"}
    recon, cfg_e = frame_check.rtl_config(torch.bfloat16)
    # the ray MLP: the 33^2 march, then the refines 33 -> 65 -> 257 (the
    # colour query needs netC)
    expect = dict.fromkeys(counters, 0)
    expect["fused_ray_mlp"] = len(cfg_e.ray.march_levels) + 1
    total = dict.fromkeys(counters, 0)
    with torch.inference_mode():
        hg = copy.deepcopy(netG.image_filter).to(torch.bfloat16)
        emit({"phase": "backbone_ms", "backbone": "PIFuHGFilters",
              "bf16_device_ms": device_ms(
                  lambda: hg(image.to(torch.bfloat16)), 5), "card": card})
        del hg
    for imf in helper.ALT_NETGS:
        state = helper.alt_netg_state(imf)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "net_G")
            torch.save(helper.reference_state(state, imf), path)
            _, cfg = rtl_main.parse_args(
                ["--camera", "--", "netG.backbone.IMF", imf,
                 "netG.backbone.norm", "batch", "netG.ckpt_path", path])
            net, net_c = rtl_main.load_networks(cfg)
        if net_c is not None:
            fail(f"load_networks loaded a netC beside the {imf} netG")
        differ = [k for k, v in state.items()
                  if not torch.equal(net.state_dict()[k].cpu(), v)]
        if differ:
            fail(f"{imf}: the checkpoint loaded other tensors {differ[:5]}")
        with torch.inference_mode():
            levels = frame_check.backbone_levels(net.image_filter(image))
        res = frame_check.compare_backbone(levels, golden_bb, imf)
        view = f"frontal_{imf}"
        emit({"phase": "backbone_golden", "backbone": imf, "dtype": "f32",
              **res, "head_input": net.surface_classifier.filter_channels[0],
              "card": card})
        if not res["ok"]:
            fail(f"{imf}'s f32 output disagrees with the JAX golden: {res}")

        eng = ReconEngine(net, None, recon=recon, config=cfg_e)
        out, med, launches = timed_frames(eng, image, calib, counters,
                                          expect, view, card, shapes)
        for k, n in launches.items():
            total[k] += n
        profile_phase(eng, image, calib, card, med, view)
        image16 = image.to(torch.bfloat16)
        with torch.inference_mode():
            bb_ms = {"bf16_device_ms": device_ms(
                lambda: eng.netG.image_filter(image16), 5),
                "f32_device_ms": device_ms(
                    lambda: net.image_filter(image), 3)}
        emit({"phase": "backbone_ms", "backbone": imf, **bb_ms,
              "card": card})

        recon32, cfg32 = frame_check.rtl_config(torch.float32)
        eng32 = ReconEngine(net, None, recon=recon32, config=cfg32)
        out32 = eng32.frame(image, None, calib)
        with plain_kernels():
            want = as_golden(eng32.frame(image, None, calib))
        torch.cuda.synchronize()
        for dname, got, limits in (("f32", out32, frame_check.F32_LIMITS),
                                   ("bf16", out, frame_check.BF16_LIMITS)):
            cmp = frame_check.compare_to_golden(got, want, limits)
            emit({"phase": "backbone_vs_plain", "backbone": imf,
                  "dtype": dname, **cmp, "limits": limits._asdict(),
                  "note": "random-weight net: not a quality result",
                  "card": card})
            if not cmp["ok"]:
                fail(f"{dname} {imf} frame disagrees with the f32 frame "
                     f"through the plain kernels: {cmp}")
        del eng, eng32, net, out, out32, want
        torch.cuda.empty_cache()
    return total


# phase 13: limits on the full-width train step against the JAX golden
# (loss and step losses relative; a gradient leaf's norm relative to the
# golden's, its projection's error relative to the golden's norm; "median"
# over the leaves, "max" over them): about twice the larger reading of the
# two nets on an H100 (netG's: 2.5e-7, 5.3e-4, 9.1e-5, 2.0e-3, 3.3e-4,
# 2.1e-2; the worst leaves are early GroupNorm ones, where the golden's
# f32 moments on the CPU are the weak side)
TRAIN_LIMITS = {"loss": 5e-7, "step_losses": 1.1e-3, "norm_median": 2e-4,
                "norm_max": 4e-3, "dot_median": 7e-4, "dot_max": 4.2e-2}
TRAIN_STEPS, TRAIN_CHUNK = 20, 10


def _train_batch(golden: dict, tag: str) -> dict:
    import torch

    return {"images": torch.from_numpy(
                golden[f"{tag}_images"].astype("float32")).cuda(),
            "points": torch.from_numpy(golden[f"{tag}_points"]).cuda(),
            "labels": torch.from_numpy(golden[f"{tag}_labels"]).cuda(),
            "calibs": torch.eye(4, device="cuda").expand(2, 4, 4)}


def parity_check(golden: dict, tag: str, name: str, grads: dict,
                 loss: float, losses: list, limits: dict, phase: str,
                 card: str) -> None:
    """A train step against a golden's (keys ``<tag>_...``): the loss and
    the step losses (relative), each gradient leaf's norm (relative) and
    projection (over the golden's norm), their median and largest over the
    leaves; emitted, and held to ``limits``. ``grads``: the port's
    gradients by parameter name."""
    import numpy as np

    from monoport_tpu_torch import frame_check, weights

    mine = frame_check.grad_summary(
        weights.flax_params_from_torch(grads)["params"])
    names = [str(n) for n in golden[f"{tag}_grad_names"]]
    if sorted(mine) != names:
        fail(f"{name}'s gradient leaves are not the golden's")
    norms = golden[f"{tag}_grad_norms"]
    norm_err = np.asarray([abs(mine[n][0] - w) / w
                           for n, w in zip(names, norms)])
    dot_err = np.asarray([abs(mine[n][1] - d) / w for n, d, w in zip(
        names, golden[f"{tag}_grad_dots"], norms)])
    want = golden[f"{tag}_step_losses"]
    golden_loss = float(golden[f"{tag}_loss"])
    res = {"loss": abs(loss - golden_loss) / golden_loss,
           "step_losses": float(np.max(np.abs(np.asarray(losses) - want)
                                       / want)),
           "norm_median": float(np.median(norm_err)),
           "norm_max": float(norm_err.max()),
           "dot_median": float(np.median(dot_err)),
           "dot_max": float(dot_err.max())}
    emit({"phase": phase, "net": name, "loss": loss,
          "golden_loss": golden_loss, "step_losses": losses,
          "golden_step_losses": want.tolist(), "errors": res,
          "limits": limits, "worst_norm_leaf": names[int(norm_err.argmax())],
          "worst_dot_leaf": names[int(dot_err.argmax())],
          "leaves": len(names), "card": card})
    over = {k: v for k, v in res.items() if not v <= limits[k]}
    if over:
        fail(f"{name}'s train step is off the JAX golden: {over}")


def train_parity_phase(netG, card: str) -> None:
    """Phase 13a: one full-width train step of the committed netG (Adam on
    the capsule app's cosine schedule) and netC (netG's feature prior, the
    global-norm clip, Adam) on the golden's batches, f32: the loss, each
    gradient leaf's norm and projection, then three steps' losses, against
    the JAX package's (``data/train_golden.npz``)."""
    import numpy as np
    import torch

    from monoport_tpu_torch import frame_check, weights
    from monoport_tpu_torch.config import get_cfg_defaults
    from monoport_tpu_torch.parallel import train_step as ts

    # the training apps' cuDNN policy (the step's own library call changes
    # nothing process-wide)
    ts.timed_convolutions("cuda")
    golden = dict(np.load(frame_check.GOLDEN_TRAIN))
    cfg = get_cfg_defaults()
    cosine = ts.cosine_decay_schedule
    runs = {"g": (cfg.netG, "netg_capsule.npz", ts.Optimizer(
                ts.ScaleByAdam(), ts.ScaleByLearningRate(
                    cosine(1e-3, 1500, alpha=0.05)))),
            "c": (cfg.netC, "netc_capsule.npz", ts.Optimizer(
                ts.ClipByGlobalNorm(1.0), ts.ScaleByAdam(),
                ts.ScaleByLearningRate(cosine(3e-4, 3000, alpha=0.05))))}
    for tag, (opt, fname, tx) in runs.items():
        net = weights.build_net(opt, weights.load_params(
            os.path.join(weights.DATA, fname))[0], "cuda")
        batch = _train_batch(golden, tag)
        if tag == "c":
            with torch.no_grad():
                batch["feat_prior"] = netG.filter(batch["images"])[-1][-1]
        state = ts.create_train_state(net, tx)
        _, loss = net(batch["images"], batch["points"], batch["calibs"],
                      labels=batch["labels"],
                      feat_prior=batch.get("feat_prior"), train=True)
        loss.backward()
        grads = {n: p.grad.clone() for n, p in net.named_parameters()}
        step = ts.make_train_step(net)
        losses = [float(step(state, batch)[1]) for _ in range(3)]
        parity_check(golden, tag, f"net{tag.upper()}", grads,
                     float(loss.detach()), losses, TRAIN_LIMITS,
                     "train_parity", card)
        del net, state, step, loss
        torch.cuda.empty_cache()


def train_profile(step, batch_fn, card: str, phase: str = "train_profile",
                  **fields) -> None:
    """One train step (``step(batch)``) after a warm-up: host syncs of the
    step and of the batch draw (torch's sync debug mode); ms (CUDA events)
    of a step with its batch draw (5, and their median), of a step on a
    fixed batch and of a draw alone; the profiler's device time and idle
    share of one step with its draw. ``fields`` go into the emitted line."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    batch = batch_fn()
    step(batch)
    torch.cuda.synchronize()
    syncs_step = find_syncs(lambda: step(batch))
    syncs_batch = find_syncs(batch_fn)
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        times.append(cuda_ms(lambda: step(batch_fn()), 1))
    step_ms = cuda_ms(lambda: step(batch), 3)
    draw_ms = cuda_ms(batch_fn, 3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch_fn())
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    kernels.sort(key=lambda k: -k[1])
    busy = sum(k[1] for k in kernels)
    med = statistics.median(times)
    emit({"phase": phase, **fields, "step_and_draw_ms": times,
          "step_and_draw_ms_median": med, "step_ms": step_ms,
          "draw_ms": draw_ms,
          "wall_ms_profiled": wall, "device_ms": busy,
          "device_idle_share": 1.0 - busy / med,
          "device_idle_share_profiled": 1.0 - busy / wall,
          "kernel_launches": sum(k[2] for k in kernels),
          "host_syncs_step": len(syncs_step),
          "host_syncs_batch": len(syncs_batch),
          "top": [{"kernel": k[0][:90], "ms": k[1], "calls": k[2]}
                  for k in kernels[:12]], "card": card})
    if syncs_step or syncs_batch:
        fail(f"a train step synchronised the stream: step {syncs_step}, "
             f"batch {syncs_batch}")


def capsule_app_phase(netC, counters: dict, card: str) -> dict:
    """Phase 13b: ``apps.train_capsule_netG`` on the card from the
    committed netG (20 steps, chunks of 10, batch 2 at 512^2, 4,096
    points), none of our kernels launched while it trains; one profiled
    step; the saved npz into ``ReconEngine`` with the committed netC:
    bf16 frontal frames with 4 ray-MLP launches each and no other, no
    sync; then 5 steps of ``apps.train_capsule_netC --mixed 1`` from the
    committed nets. -> launches by kernel."""
    import functools
    import math
    import tempfile

    import torch

    from monoport_tpu_torch import frame_check, weights
    from monoport_tpu_torch.apps import (eval_netg, train_capsule_netC,
                                         train_capsule_netG)
    from monoport_tpu_torch.config import get_cfg_defaults
    from monoport_tpu_torch.engine import ReconEngine
    from monoport_tpu_torch.parallel import train_step as ts
    from monoport_tpu_torch.training.datasets.capsule import synth_train_batch

    cfg = get_cfg_defaults()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "netg.npz")
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        res = train_capsule_netG.main([
            "--steps", str(TRAIN_STEPS), "--chunk", str(TRAIN_CHUNK),
            "--batch", "2", "--size", "512", "--points", "4096",
            "--init_from", os.path.join(weights.DATA, "netg_capsule.npz"),
            "--out", out])
        peak = torch.cuda.max_memory_allocated()
        during = {name: fn.launches for name, fn in counters.items()}
        rates = [n / s for n, s in zip(res["chunk_steps"],
                                       res["chunk_seconds"])]
        emit({"phase": "train_capsule_netG", "steps": TRAIN_STEPS,
              "chunk": TRAIN_CHUNK, "steps_per_s_median":
              statistics.median(rates), "steps_per_s": rates,
              "chunk_losses": res["chunk_losses"], "heldout_iou": res["iou"],
              "peak_memory_gib": peak / 2 ** 30, "our_kernel_launches":
              during, "params": res["params"], "card": card})
        if not all(math.isfinite(x) for x in res["chunk_losses"]):
            fail(f"netG training gave non-finite losses {res}")
        if any(during.values()):
            fail(f"a train step launched our kernels: {during}")

        # the fine-tuned checkpoint beside the committed one: the point
        # IOU the app reports, and eval_netg's silhouette IOUs (bf16)
        committed = os.path.join(weights.DATA, "netg_capsule.npz")
        quality = {}
        for name, path in (("trained", out), ("committed", committed)):
            net = weights.build_net(cfg.netG, weights.load_params(path)[0],
                                    "cuda")
            quality[name] = {
                "point_iou": train_capsule_netG.heldout_point_iou(
                    net, 512, 0, "cuda"),
                "silhouette_iou": eval_netg.eval_ckpt(
                    path, eval_netg.parse_args([]))}
            del net
        emit({"phase": "trained_netG_quality", **quality, "card": card})

        trained = weights.build_net(cfg.netG, weights.load_params(out)[0],
                                    "cuda")
        gen = torch.Generator(device="cuda").manual_seed(5)
        train_net = weights.build_net(cfg.netG, weights.load_params(out)[0],
                                      "cuda")
        state = ts.create_train_state(train_net,
                                      ts.make_optimizer("adam", 1e-4))
        step = ts.make_train_step(train_net)
        train_profile(lambda b: step(state, b), functools.partial(
            synth_train_batch, gen, 2, 512, 4096, hard=True), card)
        del train_net, state, step
        torch.cuda.empty_cache()

        golden = frame_check.load_golden()
        image = torch.from_numpy(golden["image"]).cuda()
        recon, cfg_e = frame_check.rtl_config(torch.bfloat16)
        eng = ReconEngine(trained, netC, recon=recon, config=cfg_e)
        expect = dict.fromkeys(counters, 0)
        expect["fused_ray_mlp"] = 4
        _, _, launches = timed_frames(eng, image, golden["calib"], counters,
                                      expect, "frontal_trained_netG", card)
        del eng, trained

        resc = train_capsule_netC.main([
            "--steps", "5", "--chunk", "5", "--batch", "2", "--size", "512",
            "--points", "4096", "--mixed", "1", "--init_from",
            os.path.join(weights.DATA, "netc_capsule.npz"),
            "--out", os.path.join(tmp, "netc.npz")])
        emit({"phase": "train_capsule_netC", "steps": 5, "mixed": 1,
              "chunk_losses": resc["chunk_losses"], "heldout_l1": resc["l1"],
              "heldout_psnr_db": resc["psnr"],
              "steps_per_s": [n / s for n, s in zip(resc["chunk_steps"],
                                                    resc["chunk_seconds"])],
              "card": card})
        if not all(math.isfinite(x) for x in resc["chunk_losses"]):
            fail(f"netC training gave non-finite losses {resc}")
    torch.cuda.empty_cache()
    return launches


# phase train_ppl: the r5 recipe cut to 2 subjects x 4 rotations (2 steps
# an epoch) and 3 netG epochs; phase C at the recipe's own 12 epochs,
# resumed after its sixth; in a process of its own with a time limit: a
# loader worker that hangs fails the phase instead of the run. Phase C
# needs the epochs: the recipe's Adam at lr 1e-3 first throws netC's tanh
# head off its small init (its loss rose from 0.44 to 1.21 over the first
# 4 steps on an H100, 0.44 to 0.94 on the CPU) and brings it back below
# that within ~12 steps; with 8 epochs, one H100 run's later half (2-step
# epochs just after the resume) averaged 0.4386 against a first epoch of
# 0.4333.
TRAIN_PPL_ARGS = ["--recipe", "r5", "--subjects", "2", "--rotation_step",
                  "90", "--epochs_g", "3", "--epochs_c", "12",
                  "--epochs_c_resume_at", "6"]
TRAIN_PPL_SECONDS = 240


def train_ppl_phase(card: str) -> None:
    """``apps.train_ppl`` (the fixture trees -> forked loader workers ->
    Trainer -> resume; netG, then netC on its prior) cut to size: losses
    finite and falling (each phase's later half of epochs below its first
    epoch on average: an epoch is 2 steps, so one epoch's mean is noisy),
    the resumed optimizer tensors, step and epoch equal to the saved ones,
    none of our kernels launched in a step, and the trained nets' bf16
    frame exactly 4 ray-MLP launches."""
    import math

    import signal

    cmd = [sys.executable, "-m", "monoport_tpu_torch.apps.train_ppl",
           *TRAIN_PPL_ARGS]
    t0 = time.perf_counter()
    # a session of its own: on a timeout the app and its loader workers go
    # together
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=TRAIN_PPL_SECONDS)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        _, stderr = proc.communicate()
        fail(f"train_ppl did not end within {TRAIN_PPL_SECONDS} s (a hung "
             f"loader worker?): {stderr[-2000:]}")
    seconds = time.perf_counter() - t0
    lines = [ln for ln in stdout.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or not lines:
        fail(f"train_ppl exited {proc.returncode}: {stderr[-3000:]}")
    res = json.loads(lines[-1])
    emit({"phase": "train_ppl", "args": TRAIN_PPL_ARGS,
          "wall_s": seconds, **res, "card": card})
    losses = res["netg_epoch_losses"], res["netc_epoch_losses"]
    frame = res["frame"]
    if not all(math.isfinite(v) for ladder in losses for v in ladder):
        fail(f"train_ppl losses not finite: {losses}")
    late = [statistics.mean(ladder[len(ladder) // 2:]) for ladder in losses]
    if not all(m < ladder[0] for m, ladder in zip(late, losses)):
        fail(f"train_ppl losses did not fall: {losses}")
    if not res["resume"]["exact"]:
        fail(f"train_ppl's resume: {res['resume']}")
    if any(res["training_kernel_launches"].values()):
        fail(f"a train step launched {res['training_kernel_launches']}")
    if frame["profile"] != "bench_bf16" or not frame["finite"] or \
            frame["launches"] != {**dict.fromkeys(frame["launches"], 0),
                                  "fused_ray_mlp": 4}:
        fail(f"the trained nets' frame: {frame}")


def trainer_phase(card: str) -> None:
    """Phase 13c: ``apps.train`` (the Trainer) on the synthetic blobs at
    the published netG width (256^2 images, batch 2, the config's
    RMSprop), one epoch; then ``--resume_from`` its checkpoint with
    ``resume True``: the optimizer state, step, epoch and iteration equal
    the saved ones tensor for tensor, and one more epoch runs."""
    import math
    import tempfile

    import torch

    from monoport_tpu_torch.apps import train

    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--dataset", "synthetic", "--image_size", "256"]
        opts = ["--", "batch_size", "2", "resume", "True", "freq_plot", "1",
                "freq_save", "100000",
                "checkpoints_path", os.path.join(tmp, "c"),
                "results_path", os.path.join(tmp, "r")]
        t0 = time.perf_counter()
        loss0, tr = train.main(argv + ["--epochs", "1"] + opts)
        epoch_s = time.perf_counter() - t0
        ckpt = os.path.join(tmp, "c", "default", "epoch_0")
        saved = torch.load(ckpt, map_location="cuda", weights_only=True)
        _, tr = train.main(argv + ["--epochs", "1", "--resume_from", ckpt]
                           + opts)
        names = [n for n, _ in tr.net.named_parameters()]
        differ = [f"{slot}/{n}" for slot, tensors in tr.state.opt_state.items()
                  for n, t in zip(names, tensors)
                  if not torch.equal(t, saved["opt_state"][slot][n])]
        differ += [k for k, v in tr.net.state_dict().items()
                   if not torch.equal(v, saved["params"][k])]
        restored = (tr.state.step, tr.epoch, tr.iteration)
        want = (saved["step"], saved["epoch"], saved["iteration"])
        loss1, tr = train.main(argv + ["--epochs", "2", "--resume_from",
                                       ckpt] + opts)
        emit({"phase": "trainer", "epoch_losses": [loss0, loss1],
              "epoch_0_s": epoch_s, "restored": list(restored),
              "saved": list(want), "tensors_differing": len(differ),
              "slots": sorted(saved["opt_state"]),
              "iterations_after_resume": tr.iteration, "card": card})
        if differ or restored != want:
            fail(f"resume restored {restored} (saved {want}); tensors "
                 f"differing: {differ[:5]}")
        if not (math.isfinite(loss0) and math.isfinite(loss1)
                and tr.iteration == 2 * saved["iteration"]):
            fail(f"the Trainer's epochs: {loss0}, {loss1}, {tr.iteration}")


# phase train_perception: limits on a step of the committed perception
# nets against the JAX golden, as TRAIN_LIMITS: about twice the larger
# reading of the two nets on an H100 (MatteNet / DetectNet: loss 1.1e-5 /
# 3.0e-6, step losses 1.1e-5 / 2.5e-5, norms median 2.8e-6 / 1.0e-5, worst
# 4.1e-5 / 3.7e-5, projections median 1.3e-5 / 3.4e-5, worst 1.3e-4 /
# 2.4e-4; the worst leaves are GroupNorm ones)
PERCEPTION_LIMITS = {"loss": 2.2e-5, "step_losses": 5e-5,
                     "norm_median": 2.1e-5, "norm_max": 8.3e-5,
                     "dot_median": 7e-5, "dot_max": 4.9e-4}
PERCEPTION_STEPS, PERCEPTION_CHUNK = 300, 50


def perception_parity(card: str) -> None:
    """One step of the committed MatteNet (256^2, batch 8) and DetectNet
    (512^2, batch 2) on the golden's batches with the apps' Adam (f32):
    the loss, each gradient leaf's norm and projection, three steps'
    losses, against ``data/perception_train_golden.npz`` (JAX on the
    CPU)."""
    import numpy as np
    import torch

    from monoport_tpu_torch import frame_check, weights
    from monoport_tpu_torch.parallel import train_step as ts
    from monoport_tpu_torch.pipeline.detection import DetectNet
    from monoport_tpu_torch.pipeline.segmentation import (MatteNet,
                                                          matting_loss)
    from monoport_tpu_torch.training.detection import detection_loss

    g = dict(np.load(frame_check.GOLDEN_PERCEPTION_TRAIN))

    def batch(tag, keys):
        out = []
        for k in keys:
            v = g[f"{tag}_{k}"]
            v = (v.astype(np.float32) / np.float32(255.0)
                 if v.dtype == np.uint8 else
                 v.astype(np.float32) if v.dtype == np.float16 else v)
            out.append(torch.from_numpy(v).cuda())
        return out

    mparams, mmeta = weights.load_params(os.path.join(weights.DATA,
                                                      "mattenet.npz"))
    dparams, dmeta = weights.load_params(os.path.join(weights.DATA,
                                                      "detectnet.npz"))
    runs = {"m": ("MatteNet", MatteNet(width=mmeta["width"]), mparams,
                  batch("m", ("images", "alpha")), matting_loss),
            "d": ("DetectNet", DetectNet(width=dmeta["width"],
                                         stride=dmeta["stride"]), dparams,
                  batch("d", ("images", "boxes", "valid")), detection_loss)}
    for tag, (name, net, params, b, loss_fn) in runs.items():
        net = weights.load_module(net, params, "cuda")
        state = ts.create_train_state(net, ts.make_optimizer("adam", 1e-3))
        loss = loss_fn(net, *b)
        loss.backward()
        grads = {n: p.grad.clone() for n, p in net.named_parameters()}
        losses = [float(ts.loss_step(state, loss_fn, *b))
                  for _ in range(3)]
        parity_check(g, tag, name, grads, float(loss.detach()), losses,
                     PERCEPTION_LIMITS, "perception_parity", card)
        del net, state
    torch.cuda.empty_cache()


def perception_steps(card: str) -> None:
    """``train_profile`` of each perception net at its app's default width
    and shapes (MatteNet 256^2 x 8, DetectNet 512^2 x 2)."""
    import torch

    from monoport_tpu_torch.parallel import train_step as ts
    from monoport_tpu_torch.pipeline.detection import DetectNet
    from monoport_tpu_torch.pipeline.segmentation import (MatteNet,
                                                          matting_loss)
    from monoport_tpu_torch.training import detection, matting

    gen = torch.Generator(device="cuda").manual_seed(3)
    for name, net, loss_fn, draw in (
            ("MatteNet", MatteNet(width=16), matting_loss,
             lambda: matting.synth_batch(gen, 8, 256)),
            ("DetectNet", DetectNet(width=16), detection.detection_loss,
             lambda: detection.synth_det_batch(gen, 2, 512))):
        state = ts.create_train_state(net.cuda(),
                                      ts.make_optimizer("adam", 1e-3),
                                      torch.Generator().manual_seed(0))
        train_profile(lambda b: ts.loss_step(state, loss_fn, *b), draw,
                      card, phase="perception_step", net=name)
        del net, state


def train_perception_phase(counters: dict, card: str) -> None:
    """The perception nets' training: the parity of a step against the JAX
    golden, no host sync in a step or a draw (and each step's device
    profile), then both apps at their
    defaults cut to ``PERCEPTION_STEPS`` steps (chunks of
    ``PERCEPTION_CHUNK``): steps a second (CUDA events, the median of the
    chunks), peak memory, the chunks' losses (finite), the held-out alpha
    IOU / box IOU, precision and recall; none of our kernels launched."""
    import math
    import tempfile

    import torch

    from monoport_tpu_torch.apps import train_detection, train_matting

    perception_parity(card)
    perception_steps(card)
    cut = ["--steps", str(PERCEPTION_STEPS), "--chunk",
           str(PERCEPTION_CHUNK)]
    with tempfile.TemporaryDirectory() as tmp:
        for name, app in (("train_matting", train_matting),
                          ("train_detection", train_detection)):
            for fn in counters.values():
                fn.launches = 0
            torch.cuda.reset_peak_memory_stats()
            res = app.main(cut + ["--out", os.path.join(tmp, f"{name}.npz")])
            peak = torch.cuda.max_memory_allocated()
            during = {k: fn.launches for k, fn in counters.items()}
            rates = [n / sec for n, sec in zip(res["chunk_steps"],
                                                res["chunk_seconds"])]
            emit({"phase": name, "steps": PERCEPTION_STEPS,
                  "chunk": PERCEPTION_CHUNK,
                  "steps_per_s_median": statistics.median(rates),
                  "steps_per_s": rates, "chunk_losses": res["chunk_losses"],
                  "heldout_iou": res["iou"],
                  **({"heldout": {str(k): v for k, v in
                                  res["heldout"].items()}}
                     if "heldout" in res else {}),
                  "peak_memory_gib": peak / 2 ** 30,
                  "our_kernel_launches": during, "params": res["params"],
                  "card": card})
            if not all(math.isfinite(x) for x in res["chunk_losses"]):
                fail(f"{name} gave non-finite losses {res['chunk_losses']}")
            if any(during.values()):
                fail(f"{name} launched our kernels: {during}")
    torch.cuda.empty_cache()


# phase 17's bounds: the f32 readings through the plain versions against
# the JAX package's f32 readings, the bf16 readings against the f32 ones
QUALITY_LIMITS = {"iou_f32": 0.005, "psnr_f32_db": 0.2, "depth_f32": 2e-3,
                  "iou_bf16": 0.01, "psnr_bf16_db": 0.5, "depth_bf16": 0.6,
                  "rotated_iou": 0.005, "rotated_mad": 1e-3}
DEMO_STEPS = 300
# tests/test_trained_pipeline.py's cross-family gates (set at 129)
CROSSFAM_GATES = {"sq_flat": {"iou": 0.90, "psnr": 32.2},
                  "sq": {"iou": 0.89, "psnr": 29.9},
                  "ellipsoid": {"iou": 0.87}}


def _within(got: float, want: float, tol: float) -> bool:
    return abs(got - want) <= tol


def _disagree(valid, want) -> float:
    got = valid.cpu().numpy()
    return float((got != want).sum() / max((got | want).sum(), 1))


def quality_bench(netG, netC, counters: dict, card: str, golden: dict,
                  image, caps) -> dict:
    """Phase 17a: ``bench_real``'s keys (bf16 kernels, f32 plain) and the
    held-out seeds. -> launches by kernel."""
    import torch

    from monoport_tpu_torch import evaluate, frame_check
    from monoport_tpu_torch.training.datasets.capsule import render_front

    lim = QUALITY_LIMITS
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    keys16, _ = evaluate.bench_quality(netG, netC, image, caps,
                                       torch.bfloat16, "cuda")
    s16 = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    want = dict.fromkeys(counters, 0)
    want.update({"fused_ray_mlp": 4, "fused_mlp": 5})
    t0 = time.perf_counter()
    with plain_kernels():
        keys32, out32 = evaluate.bench_quality(netG, netC, image, caps,
                                               torch.float32, "cuda")
    s32 = time.perf_counter() - t0
    jax32 = {k: float(golden[f"bench/{k}"]) for k in evaluate.BENCH_KEYS}
    disagree = _disagree(out32["valid"], golden["bench/valid"])
    emit({"phase": "quality_bench", "seed": evaluate.BENCH_SEED,
          "bf16": keys16, "f32_plain": keys32, "jax_f32": jax32,
          "f32_valid_disagree": disagree, "launches": launches,
          "seconds_bf16": s16, "seconds_f32_plain": s32,
          "limits": lim, "card": card})
    if launches != want:
        fail(f"the bench quality run launched {launches}, expected {want}")
    checks = [(k, keys32[k], jax32[k], lim["iou_f32"])
              for k in ("real_model_vs_gt_iou", "real_ray_vs_dense_iou")]
    checks += [("real_tex_psnr_db", keys32["real_tex_psnr_db"],
                jax32["real_tex_psnr_db"], lim["psnr_f32_db"]),
               ("real_depth_err_med_voxels",
                keys32["real_depth_err_med_voxels"],
                jax32["real_depth_err_med_voxels"], lim["depth_f32"])]
    for k, got, ref, tol in checks:
        if not _within(got, ref, tol):
            fail(f"f32 {k} {got} is more than {tol} from the JAX f32 "
                 f"golden's {ref}")
    if disagree >= frame_check.F32_LIMITS.valid_disagree_max:
        fail(f"the f32 bench frame's silhouette disagrees with the JAX "
             f"golden's on {disagree:.4%} of its union")
    for k, tol in (("real_model_vs_gt_iou", lim["iou_bf16"]),
                   ("real_ray_vs_dense_iou", lim["iou_bf16"]),
                   ("real_tex_psnr_db", lim["psnr_bf16_db"]),
                   ("real_depth_err_med_voxels", lim["depth_bf16"])):
        if not _within(keys16[k], keys32[k], tol):
            fail(f"bf16 {k} {keys16[k]} is more than {tol} from the card's "
                 f"f32 {keys32[k]}")

    # eval_netg / eval_netc on the held-out seeds, bf16
    engine = evaluate.bench_engine(netG, netC, torch.bfloat16, "cuda")
    for fn in counters.values():
        fn.launches = 0
    seeds = {}
    for seed in evaluate.HELD_OUT_SEEDS:
        body = evaluate.capsule_body(seed, "cuda", golden)
        r, _ = evaluate.frame_readings(engine, render_front(body, 512)[0],
                                       evaluate.capsule_occ(body))
        seeds[seed] = {"iou": r["iou"], "psnr": r["psnr"],
                       "jax_f32_iou": float(golden[f"netg/{seed}"]),
                       "jax_f32_psnr": float(golden[f"netc/{seed}"])}
    seed_launches = {name: fn.launches for name, fn in counters.items()}
    emit({"phase": "quality_seeds", "dtype": "bf16",
          "seeds": {str(k): v for k, v in seeds.items()},
          "mean_iou": statistics.mean(v["iou"] for v in seeds.values()),
          "mean_psnr": statistics.mean(v["psnr"] for v in seeds.values()),
          "launches": seed_launches, "card": card})
    if seed_launches["fused_ray_mlp"] != 4 * len(seeds):
        fail(f"the seeds' frames launched {seed_launches}")
    for seed, v in seeds.items():
        if not (_within(v["iou"], v["jax_f32_iou"], lim["iou_bf16"])
                and _within(v["psnr"], v["jax_f32_psnr"],
                            lim["psnr_bf16_db"])):
            fail(f"seed {seed}: bf16 readings {v} off the JAX f32 golden")
    for name, n in seed_launches.items():
        launches[name] += n
    return launches


def quality_crossfam(netG, netC, counters: dict, card: str,
                     golden: dict) -> dict:
    """Phase 17b: the cross-family families, f32 plain at 129 against the
    golden, bf16 at 257 beside the gates. -> launches by kernel."""
    import torch

    from monoport_tpu_torch import evaluate, frame_check
    from monoport_tpu_torch.apps import eval_crossfam

    lim = QUALITY_LIMITS
    seeds = [evaluate.BENCH_SEED]
    t0 = time.perf_counter()
    with plain_kernels():
        eng32 = evaluate.reduced_engine(netG, netC, torch.float32, "cuda")
        fams32 = eval_crossfam.family_readings(eng32, seeds, "cuda", golden)
    s32 = time.perf_counter() - t0
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    eng16 = evaluate.bench_engine(netG, netC, torch.bfloat16, "cuda")
    fams16 = eval_crossfam.family_readings(eng16, seeds, "cuda", golden)
    torch.cuda.synchronize()
    s16 = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    rows = {}
    for fam, ((r32, out32),) in fams32.items():
        ref = {"iou": float(golden[f"crossfam/{fam}/iou"]),
               "psnr": (float(golden[f"crossfam/{fam}/psnr"])
                        if f"crossfam/{fam}/psnr" in golden else None)}
        rows[fam] = {"f32_plain_129": {k: r32[k] for k in ("iou", "psnr")},
                     "jax_f32_129": ref, "f32_valid_disagree": _disagree(
                         out32["valid"], golden[f"crossfam/{fam}/valid"]),
                     "bf16_257": {k: fams16[fam][0][0][k]
                                  for k in ("iou", "psnr")},
                     "gates_at_129": CROSSFAM_GATES.get(fam)}
    emit({"phase": "quality_crossfam", "seed": evaluate.BENCH_SEED,
          "families": rows, "launches_bf16_257": launches,
          "seconds_f32_plain": s32, "seconds_bf16": s16, "card": card})
    if launches["fused_ray_mlp"] != 4 * 3 + 3:
        fail(f"the bf16 cross-family frames launched {launches}")
    for fam, row in rows.items():
        got, ref = row["f32_plain_129"], row["jax_f32_129"]
        if not _within(got["iou"], ref["iou"], lim["iou_f32"]):
            fail(f"{fam}: f32 IOU {got['iou']} off the JAX golden's "
                 f"{ref['iou']}")
        if ref["psnr"] is not None and not _within(
                got["psnr"], ref["psnr"], lim["psnr_f32_db"]):
            fail(f"{fam}: f32 PSNR {got['psnr']} off the JAX golden's "
                 f"{ref['psnr']}")
        if row["f32_valid_disagree"] >= \
                frame_check.F32_LIMITS.valid_disagree_max:
            fail(f"{fam}: the f32 silhouette disagrees with the JAX "
                 f"golden's: {row['f32_valid_disagree']}")
    return launches


def quality_rotated(netG, netC, counters: dict, card: str, golden: dict,
                    image, caps) -> dict:
    """Phase 17c: eval_rotated_anchored's keys, bf16 (launches held to the
    plans) and f32 plain against the golden. -> launches by kernel."""
    import numpy as np
    import torch

    from monoport_tpu_torch import evaluate

    lim = QUALITY_LIMITS
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out16, plans = evaluate.rotated_anchored(netG, netC, image, caps,
                                             torch.bfloat16, "cuda")
    s16 = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    want = dict.fromkeys(counters, 0)
    for plan in plans.values():
        for name, n in rotated_expect(plan).items():
            want[name] += n
    t0 = time.perf_counter()
    with plain_kernels():
        out32, plans32 = evaluate.rotated_anchored(netG, netC, image, caps,
                                                   torch.float32, "cuda")
    s32 = time.perf_counter() - t0
    # no stream sync inside a frame of the profile (each mode, the first
    # pose: its 'auto' plan anchors one level)
    calib = evaluate.pose_calib(*evaluate.POSES[0])
    img = image[None]
    syncs = {}
    for mode in evaluate.ROTATED_MODES:
        eng = evaluate.rotated_engine(netG, netC, mode, torch.bfloat16,
                                      "cuda")
        eng.frame(img, img, calib)
        torch.cuda.synchronize()
        syncs[str(mode)] = find_syncs(lambda: eng.frame(img, img, calib))
    diffs, bad = {}, []
    for key, got in out32.items():
        ref = golden[f"rotated/{key}"]
        if "_plan_" in key:
            ok = got == str(tuple(int(k) or None for k in ref))
        elif "_dropped_" in key:
            ok = got == ref.tolist()
        elif "_p95_" in key:
            continue
        else:
            diffs[key] = got - float(ref)
            tol = lim["rotated_mad"] if "_mad_" in key else lim["rotated_iou"]
            ok = abs(diffs[key]) <= tol
        if not ok:
            bad.append((key, got, ref.tolist()))
    emit({"phase": "quality_rotated", "bf16": {
        k: v for k, v in out16.items() if "_iou_" in k or "_plan_" in k},
          "bf16_all": out16, "f32_plain_minus_jax": diffs,
          "plans": {f"{t}/{m}": list(p) for (t, m), p in plans.items()},
          "launches": launches, "expected": want, "seconds_bf16": s16,
          "seconds_f32_plain": s32, "host_syncs_per_frame": {
              k: len(v) for k, v in syncs.items()}, "card": card})
    if launches != want:
        fail(f"rotated quality frames launched {launches}, the plans "
             f"imply {want}")
    if any(syncs.values()):
        fail(f"a rotated 129 frame synchronised the stream: {syncs}")
    if {k: tuple(v) for k, v in plans.items()} != \
            {k: tuple(v) for k, v in plans32.items()}:
        fail(f"bf16 and f32 plans differ: {plans} {plans32}")
    if bad:
        fail(f"rotated f32 readings off the JAX golden: {bad}")
    return launches


def quality_demo(counters: dict, card: str) -> dict:
    """Phase 17d: ``apps.demo_synthetic`` for ``DEMO_STEPS`` steps. ->
    launches by kernel."""
    import math
    import tempfile

    from monoport_tpu_torch.apps import demo_synthetic

    for fn in counters.values():
        fn.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        res = demo_synthetic.main(["--steps", str(DEMO_STEPS), "--out", tmp])
        seconds = time.perf_counter() - t0
        files = sorted(os.listdir(tmp))
    launches = {name: fn.launches for name, fn in counters.items()}
    emit({"phase": "quality_demo", "steps": DEMO_STEPS, **res,
          "files": files, "seconds": seconds, "launches": launches,
          "jax_reference_iou": 0.36, "card": card})
    want = dict.fromkeys(counters, 0)
    want["fused_mlp"] = 6
    if launches != want:
        fail(f"demo_synthetic launched {launches}, expected {want}")
    if not all(math.isfinite(x) for x in res["losses"]):
        fail(f"demo_synthetic gave non-finite losses {res['losses']}")
    if not (res["verts"] > 0 and res["faces"] > 0):
        fail(f"demo_synthetic's mesh is empty: {res}")
    if res["train_iou"] < res["iou"]:
        fail(f"demo_synthetic: the training scene's IOU {res['train_iou']}"
             f" is below the held-out scene's {res['iou']}")
    if files != ["mesh.obj", "metrics.json", "recon_norm.png"]:
        fail(f"demo_synthetic wrote {files}")
    return launches


def quality_phase(netG, netC, counters: dict, card: str) -> dict:
    """Phase 17: quality against the ground truth (module docstring). ->
    launches by kernel."""
    import torch

    from monoport_tpu_torch import evaluate
    from monoport_tpu_torch.training.datasets.capsule import render_front

    torch.backends.cudnn.benchmark = True
    t0 = time.perf_counter()
    golden = evaluate.load_golden()
    caps = evaluate.capsule_body(evaluate.BENCH_SEED, "cuda", golden)
    image = render_front(caps, 512)[0]
    totals: dict = {}
    for launches in (
            quality_bench(netG, netC, counters, card, golden, image, caps),
            quality_crossfam(netG, netC, counters, card, golden),
            quality_rotated(netG, netC, counters, card, golden, image, caps),
            quality_demo(counters, card)):
        for name, n in launches.items():
            totals[name] = totals.get(name, 0) + n
    emit({"phase": "quality", "seconds": time.perf_counter() - t0,
          "cudnn_benchmark": torch.backends.cudnn.benchmark,
          "launches": totals, "card": card})
    if not torch.backends.cudnn.benchmark:
        fail("the quality phase's cudnn.benchmark pin was changed")
    torch.cuda.empty_cache()
    return totals


KERNELS = [
    # name, source, the TPU kernel it replaces, its shapes on the main path
    ("fused_ray_mlp", "fused_ray_mlp.cu",
     "monoport_tpu/ops/pallas/fused_ray_mlp.py:109",
     ("march", "refine65", "refine257", "colour")),
    ("fused_mlp", "fused_mlp.cu",
     "monoport_tpu/ops/pallas/fused_mlp.py:78", ("march",)),
    ("fused_anchor_mlp", "fused_ray_mlp.cu",
     "monoport_tpu/ops/pallas/fused_ray_mlp.py:181",
     ("refine65", "refine257")),
    ("fused_gather_mlp", "fused_gather_mlp.cu",
     "monoport_tpu/ops/pallas/fused_gather_mlp.py:70",
     ("fine_192x6", "point_36k_t1")),
]


def kernels_line(rows: list, launches: dict) -> dict:
    """One entry a kernel: the bf16 launches of its frame summed (ms,
    plain_ms, bound_ms a frame), the largest error among them, and every
    measured shape under ``shapes``."""
    entries = []
    for name, source, replaces, on_path in KERNELS:
        mine = [r for r in rows if r["kernel"] == name]
        path = [r for r in mine if r["dtype"] == "bf16"
                and r["shape"] in on_path]
        if launches[name] < 1:
            fail(f"{name} was not launched on its frame's path")
        entries.append({
            "name": name, "route": "cuda",
            "source": os.path.join(CSRC, source), "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in path),
            "ms": sum(r["ms"] for r in path),
            "plain_ms": sum(r["plain_ms"] for r in path),
            "bound_ms": sum(r["bound_ms"] for r in path),
            "bound_by": "operations"
            if all(r["bound_by"] == "operations" for r in path) else "bytes",
            "library_ms": None,
            # the same launches forced into the scratch mode, and in place
            # again after it
            "scratch_ms": sum(r["scratch_ms"] for r in path),
            "in_place_ms_after": sum(r["in_place_ms_after"] for r in path),
            "shapes": {f"{r['shape']}/{r['dtype']}": {
                k: r[k] for k in ("route", "ms", "plain_ms", "bound_ms",
                                  "max_abs_err", "p999_abs_err")}
                for r in mine}})
    return {"kernels": entries}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    if not os.path.isdir(os.path.join(ROOT, CSRC)):
        fail("the repository checkout is not beside this script")
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    emit({"phase": "device", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})

    from monoport_tpu_torch.ops.cuda import build
    from monoport_tpu_torch.ops.cuda import fused_gather_mlp as tgather
    from monoport_tpu_torch.ops.cuda import fused_mlp as tmlp
    from monoport_tpu_torch.ops.cuda import fused_ray_mlp as tray
    from monoport_tpu_torch.ops.cuda import mix_rows
    from monoport_tpu_torch.weights import load_default_networks

    t0 = time.perf_counter()
    seconds: dict = {}
    libs = build.build_all(seconds)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": {os.path.join(CSRC, f"{name}.cu"): {
              "seconds": seconds[name],
              "library": os.path.relpath(path, ROOT)}
              for name, path in libs.items()}})

    netG, netC = load_default_networks()
    rows = kernel_phase(netG, netC, reference_helper().soft_netg("cuda"),
                        tray, tmlp, tgather)
    counters = {"fused_ray_mlp": tray.apply_ray, "fused_mlp": tmlp.apply_mlp,
                "fused_anchor_mlp": tray.apply_anchor,
                "fused_gather_mlp": tgather.apply_gather_ray,
                "mix_rows": mix_rows.launch_mix_rows}
    launches, frontal = frame_phases(netG, netC, counters, card)
    graphs_phase(netG, netC, card)
    for name, n in dense_phases(netG, netC, counters, card).items():
        launches[name] = launches.get(name, 0) + n
    for name, n in views_phase(counters, rows, card).items():
        launches[name] = launches.get(name, 0) + n
    for name, n in softonehot_phase(netC, counters, card).items():
        launches[name] = launches.get(name, 0) + n
    for name, n in wide_head_phase(netG, netC, counters, card).items():
        launches[name] = launches.get(name, 0) + n
    launches["fused_gather_mlp"] = gather_phase(counters)
    for name, n in serve_phase(counters, card).items():
        launches[name] = launches.get(name, 0) + n
    legacy_phase(netG, netC, frontal, card)
    for name, n in backbones_phase(netG, counters, card).items():
        launches[name] = launches.get(name, 0) + n
    train_parity_phase(netG, card)
    for name, n in capsule_app_phase(netC, counters, card).items():
        launches[name] = launches.get(name, 0) + n
    trainer_phase(card)
    train_ppl_phase(card)
    torch.cuda.empty_cache()
    for name, n in sharded_phase(netG, netC, counters, card).items():
        launches[name] = launches.get(name, 0) + n
    train_perception_phase(counters, card)
    for name, n in quality_phase(netG, netC, counters, card).items():
        launches[name] = launches.get(name, 0) + n

    emit(kernels_line(rows, launches))
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

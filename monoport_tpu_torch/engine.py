"""ReconEngine — the frame program on the card (port of
``monoport_tpu/engine.py``): the real-time march-pyramid frames, frontal
and rotated, the hierarchy frames (``mode='dense'`` and the coarse-volume
``mode='ray'``) and clips (``frames``).

One frame: netG ``HGFilter`` over the image, surface localization, normal
shading, netC ``ResnetFilter`` with netG's last feature map as its prior,
the colour query, and the display resize. Surface localization is one of

* the volume-free ``ray_pyramid`` (dense march, refines through the march
  levels and the windowed fine pass), when ``march_levels`` is set and the
  frame may march (below);
* else the hierarchical volume (``recon/hierarchy.py``: every level a
  static batch of per-point queries through the per-point MLP kernel),
  followed by ``depth_peel`` of the full volume (``mode='dense'``) or by
  ``ray_refine`` of the coarse one (``mode='ray'``). Such a frame also
  returns the volume (``sdf``) and the levels' candidate counts
  (``recon_counts``; ``band_report``).

The path is chosen on the host from the numpy calib, as the JAX engine
does, so no per-frame device sync appears:

* frontal calibs (diagonal, z-free image rows): separable grid sampling
  and the fused ray MLP for every query, 4 launches a frame
  (``ops/cuda/fused_ray_mlp.apply_ray``);
* in-plane rotations (z-free rows, not diagonal): the march and the
  refines gather once per ray and run the same ray MLP; the colour query
  runs per point through the plain head;
* rotated (free-viewpoint) calibs, every calib of a perspective net, and
  ``use_ray_query=False``: the march runs the exact per-point query
  through the per-point MLP kernel (``ops/cuda/fused_mlp.apply_mlp``);
  each refine level queries only its coarse-valid rays (compaction, a
  static budget) through the anchored ray MLP
  (``fused_ray_mlp.apply_anchor``) with the anchor count the host-side
  plan gives that level, or exact per-point where the plan gives none;
  the per-point colour query rides the last level's compaction.

A net with soft-onehot z features (``normalizer.soft_onehot``) takes no
ray, grid or anchored query, decided per net from its config as in the JAX
engine: a soft-onehot netG's frontal frame takes the hierarchy, its
rotated frame marches and refines per point, and a soft-onehot netC's
colour query runs per point.

With ``rotated.march=False`` a rotated calib takes the hierarchy instead
of the march, and ``mode='ray'`` then refines with the anchored query of
the single coarse-to-fine level. A mesh comes from a dense frame's ``sdf``
through ``recon/marching.extract_mesh``.

With a ``mesh`` whose ``points`` axis is wider than 1 (``parallel.mesh``;
one process a rank, every rank calling ``frame`` with the same inputs),
the query batches are split over that axis, as the JAX engine's
``_shard_points`` and ``_shard_map_head`` split them: each per-point or
per-ray query (the occupancy, ray-tap, anchored and colour closures) runs
whole, sampling and head, on this rank's contiguous share of its points
or rays, and the grid queries run their heads on this rank's share of the
flattened ray axis; the rows are padded up to a multiple of the axis
size, and one all-gather over the axis's process group puts the outputs
back together. Features stay replicated: every rank computes them, and
every row is computed by one rank, once. So a sharded frame equals the
single-card frame bit for bit where the ranks' convolutions pick the same
algorithms; under cuDNN's timed algorithms (``cudnn.benchmark``) each
process times its own, and a rank gathers rows computed from features a
few ulps off its own (on an H100: within ``frame_check.BF16_LIMITS``, not
bit-equal). The pad amounts come from shapes, so a frame still reads no
device value on the host.

Dtype policy (JAX ``_cast`` / ``_feats_f32``): the backbones run in the
compute dtype, their feature maps are upcast to f32 before the queries,
and the MLPs run in the compute dtype inside the kernels with f32
accumulation. The head operands are packed once, at construction. f32
parity with the JAX package (which pins full f32 precision) needs TF32
off on the card: ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` False, as ``chip_smoke.py`` sets them.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from .config import CN
from .models import MonoPortNet
from .ops.constants import upload_async
from .ops.cuda.fused_mlp import apply_mlp, pack_mlp_params
from .ops.cuda.fused_ray_mlp import (apply_anchor, apply_ray,
                                     pack_ray_mlp_params)
from .parallel.mesh import POINT_AXIS, Mesh, check_mesh
from .recon.depth_peel import (SurfaceMaps, colorize, depth_peel,
                               shade_normal, visualize)
from .recon.hierarchy import HierarchicalRecon
from .recon.ray_refine import (_axis_window, _compact_rays, _f32,
                               _sample_grid, _valid_indices, ray_pyramid,
                               ray_refine)
from .weights import resolve_device

# Adaptive rotated-compaction budget rungs: frame(compact_hint=...) snaps
# the hint up to one of these, so a bounded set of shapes ever runs.
COMPACT_LADDER = (0.25, 0.375, 0.5, 0.625)


def _scalar_z(net: MonoPortNet) -> bool:
    """True iff ``net``'s z feature is the scalar normalizer (not the
    soft-onehot one, whose nets only take per-point queries)."""
    return not CN(net.opt_net).normalizer.get("soft_onehot", False)


def _snap_budget(hint: float, ceiling: float) -> float:
    """Smallest COMPACT_LADDER rung >= hint, capped at the constructor
    ceiling (a capped rung may drop rays; telemetry counts them)."""
    for rung in COMPACT_LADDER:
        if rung >= hint:
            return min(rung, ceiling)
    return ceiling


@dataclasses.dataclass(frozen=True)
class RayCfg:
    """Reconstruction-path shape.

    mode: 'dense' = the full hierarchical volume at the recon's last
      resolution, depth-peeled (exact; the frame keeps 'sdf'); 'ray' = a
      coarse surface and a per-ray fine pass at ``fine_res``: the
      real-time path.
    fine_res / taps / window: the fine ray lattice, its z-taps per ray
      and the optional window^2 ray block over the subject's bbox.
    march_levels: e.g. (33, 65): replace the coarse hierarchy and its
      depth peel by the volume-free march pyramid on the frames that may
      march; such a frame has no 'sdf' / 'recon_counts'. Needs
      mode='ray' and direction='front'.
    use_ray_query: allow the ray-structured queries (shared gather and
    skip projections per ray). They are valid only for calibs with z-free
    image-plane rows; ``frame()`` checks per call. False sends every
    frame down the per-point / anchored path."""
    mode: str = "dense"
    fine_res: int = 257
    taps: int = 6
    window: Optional[int] = None
    march_levels: Optional[tuple] = None
    use_ray_query: bool = True


@dataclasses.dataclass(frozen=True)
class RotatedCfg:
    """Rotated-view (orbit camera / perspective net) path.

    march: rotated calibs take the march pyramid through exact per-point
      queries (the march axis is the view ray for any calib). False
      sends them down the hierarchy (the frame keeps 'sdf').
    compact: query only the coarse-valid rays of each refine level and
      only the valid texture pixels, padded to this fraction of the
      lattice; None = dense. This is the ceiling of the adaptive per-frame
      budget (``frame(compact_hint=...)`` snaps up COMPACT_LADDER).
      Overflow degrades to the coarse silhouette and is counted in
      ``frame()['compact_dropped']``.
    anchors: refine levels run the anchored ray query (K feature gathers
      per ray + a per-tap lerp). 'auto' = per-level K from the calib
      (``_rot_anchor_plan``); an int pins K; None/0 = exact per-point
      refines.
    anchor_texels: the 'auto' planner's tolerance: the most feature texels
      a lerp segment may span.
    """
    march: bool = True
    compact: Optional[float] = 0.5
    anchors: Any = "auto"
    anchor_texels: float = 1.5


@dataclasses.dataclass(frozen=True)
class TextureCfg:
    """netC texture-stage knobs (rotated per-point path).

    bf16: do not upcast netC's feature maps to f32 for the per-point
      colour query. As in the JAX package it changes nothing today: the
      f32 geometry prior concatenated into those maps has promoted them to
      f32 already.
    reuse_compact: the per-point colour query rides the last refine
      level's compaction (window, gathered rays, refined depths) instead
      of deriving window, valid set and indices again from the maps.
    stride: query colours on a dense (window/stride)^2 lattice instead of
      the compacted valid set, and upsample them bilinearly back to the
      ray lattice; geometry is untouched. 1 = exact.
    pallas_head: run the per-point colour MLP through the per-point MLP
      kernel, as the occupancy queries do (the flag keeps the JAX
      package's name). Default False: the plain head.
    """
    bf16: bool = False
    reuse_compact: bool = True
    stride: int = 1
    pallas_head: bool = False


@dataclasses.dataclass(frozen=True)
class EngineCfg:
    """render_size: output canvas; direction: the view of the hierarchy
    frames' depth peel ('front', 'back', 'left', 'right'); compute_dtype:
    backbone/MLP operand dtype (the feature maps feeding the queries are
    upcast to f32)."""
    render_size: int = 256
    direction: str = "front"
    compute_dtype: torch.dtype = torch.float32
    ray: RayCfg = RayCfg()
    rotated: RotatedCfg = RotatedCfg()
    texture: TextureCfg = TextureCfg()

    @classmethod
    def flat(cls, **knobs) -> "EngineCfg":
        """A grouped config from the JAX package's flat knob names
        (``monoport_tpu.engine.EngineCfg.flat``). An unknown name raises
        ``KeyError``. The port has no interpret mode and no plain route in
        place of its kernels: ``use_pallas`` is accepted only as True and
        ``pallas_interpret`` only as False."""
        top: dict = {}
        groups: dict = {"ray": {}, "rotated": {}, "texture": {}}
        for name, value in knobs.items():
            where = _FLAT[name]
            if name in _KERNEL_KNOBS:
                if value != _KERNEL_KNOBS[name]:
                    raise ValueError(
                        f"{name}={value!r}: the port's kernels always run "
                        f"on the card (their plain versions on CPU tensors);"
                        f" only {_KERNEL_KNOBS[name]} is accepted")
            elif where is None:
                top[name] = value
            else:
                groups[where[0]][where[1]] = value
        return cls(ray=RayCfg(**groups["ray"]),
                   rotated=RotatedCfg(**groups["rotated"]),
                   texture=TextureCfg(**groups["texture"]), **top)


# the JAX package's flat knob names -> (group, field); None = top level
_FLAT = {
    "render_size": None, "direction": None, "compute_dtype": None,
    "use_pallas": None, "pallas_interpret": None,
    "mode": ("ray", "mode"), "fine_res": ("ray", "fine_res"),
    "ray_taps": ("ray", "taps"), "ray_window": ("ray", "window"),
    "march_levels": ("ray", "march_levels"),
    "use_ray_query": ("ray", "use_ray_query"),
    "march_rotated": ("rotated", "march"),
    "compact_rotated": ("rotated", "compact"),
    "rot_anchors": ("rotated", "anchors"),
    "rot_anchor_texels": ("rotated", "anchor_texels"),
    "tex_bf16": ("texture", "bf16"),
    "tex_reuse_compact": ("texture", "reuse_compact"),
    "tex_stride": ("texture", "stride"),
    "tex_pallas_head": ("texture", "pallas_head"),
}
# the knobs of the JAX package's kernel routes, and the one value each
# takes here
_KERNEL_KNOBS = {"use_pallas": True, "pallas_interpret": False}


class ReconEngine:
    """Frame program: (images, calib) -> rendered maps, with the weights
    held by the nets.

    Args:
      netG / netC: MonoPortNet modules (netC optional: texture off).
      recon: HierarchicalRecon (b_min / b_max / balance_value are read).
      config: EngineCfg.
      device: ``None`` = ``cuda`` (raises when CUDA is absent); pass
        ``"cpu"`` to run on the CPU, where the MLP kernels take their
        plain versions.
      mesh: optional ``parallel.mesh.Mesh``; its ``points`` axis splits
        the query batches (module docstring). This rank must be one of
        its ranks.
    """

    def __init__(self, netG: MonoPortNet, netC: Optional[MonoPortNet] = None,
                 recon: Optional[HierarchicalRecon] = None,
                 config: Optional[EngineCfg] = None, device=None,
                 mesh: Optional[Mesh] = None):
        cfg = config or EngineCfg()
        self.config = cfg
        self.device = resolve_device(device)
        if check_mesh(mesh) is not None and not mesh.active:
            raise ValueError(f"rank {mesh.rank} is not a rank of the mesh")
        self.mesh = mesh
        if cfg.ray.mode not in ("dense", "ray"):
            raise ValueError(f"unknown mode {cfg.ray.mode!r}")
        if cfg.ray.march_levels and (cfg.ray.mode != "ray"
                                     or cfg.direction != "front"):
            raise ValueError("march_levels requires mode='ray' and the "
                             "frontal viewer")
        self.recon = recon or HierarchicalRecon()
        self.mode = cfg.ray.mode
        self.direction = cfg.direction
        self.compute_dtype = cfg.compute_dtype
        self.render_size = cfg.render_size
        self.fine_res = cfg.ray.fine_res
        self.ray_taps = cfg.ray.taps
        self.ray_window = cfg.ray.window
        self.march_levels = (tuple(cfg.ray.march_levels)
                             if cfg.ray.march_levels else None)
        # the compute-dtype copies of the nets (JAX ``_cast`` of params)
        self.netG = self._cast(netG)
        self.netC = self._cast(netC) if netC is not None else None
        # head operands, packed once: the ray and anchored kernels share
        # one packing, the per-point kernel has its own. A net with
        # soft-onehot z gets no ray-structured head (its z is no scalar
        # column), and ``frame()`` sends its queries per point.
        dt, dev = self.compute_dtype, self.device
        point_g = pack_mlp_params(self.netG.surface_classifier, dt, dev)
        self.point_g = lambda x: apply_mlp(point_g, x)
        self.head_g = self.anchor_g = self.head_c = self.point_c = None
        if _scalar_z(self.netG):
            ray_g = pack_ray_mlp_params(self.netG.surface_classifier, dt, dev)
            self.head_g = lambda feat, z: apply_ray(ray_g, feat, z)
            self.anchor_g = lambda feat_k, w, z: apply_anchor(ray_g, feat_k,
                                                              w, z)
        if self.netC is not None:
            if self._ray_ok(self.netC):
                ray_c = pack_ray_mlp_params(self.netC.surface_classifier, dt,
                                            dev)
                self.head_c = lambda feat, z: apply_ray(ray_c, feat, z)
            self.point_c = self._point_color_head()
        # the grid queries' heads take this rank's share of the rays
        self.grid_g = self._shard_rows(self.head_g)
        self.grid_c = self._shard_rows(self.head_c)

    def _shard_rows(self, fn):
        """``fn`` (tensors [B, R, ...] -> a tensor [B, R, ...], a map over
        the rows of axis 1) run on this rank's contiguous share of the R
        rows, padded with zero rows up to a multiple of the mesh's
        ``points`` axis, and gathered over that axis (the JAX engine's
        ``_shard_map_head``); ``fn`` itself without such an axis. The share
        is a fresh tensor: the bf16 kernels encode a TMA map from its
        pointer, which needs 16-byte aligned rows."""
        mesh = self.mesh
        if fn is None or mesh is None or mesh.shape[POINT_AXIS] == 1:
            return fn
        n = mesh.shape[POINT_AXIS]
        i = mesh.index(POINT_AXIS)
        group = mesh.group(POINT_AXIS)

        def share(a: torch.Tensor, lo: int, hi: int, k: int) -> torch.Tensor:
            out = a.new_zeros((a.shape[0], k) + tuple(a.shape[2:]))
            out[:, :hi - lo] = a[:, lo:hi]
            return out

        def sharded(*arrays):
            r = arrays[0].shape[1]
            k = -(-r // n)
            lo, hi = min(i * k, r), min((i + 1) * k, r)
            out = fn(*(share(a, lo, hi, k) for a in arrays)).contiguous()
            parts = [torch.empty_like(out) for _ in range(n)]
            dist.all_gather(parts, out, group=group)
            return torch.cat(parts, dim=1)[:, :r]

        return sharded

    def _cast(self, net: MonoPortNet) -> MonoPortNet:
        """The net in the compute dtype on the engine's device (a copy
        unless f32)."""
        net = copy.deepcopy(net) if self.compute_dtype != torch.float32 \
            else net
        return net.to(device=self.device, dtype=self.compute_dtype).eval()

    def _point_color_head(self):
        """The head of the per-point colour query (``query(head_fn=...)``;
        None = the net's own head).

        The JAX engine applies the plain head with compute-dtype params to
        f32 feature maps, which promotes to f32 products on the rounded
        weights: here that is an f32 copy of the compute-dtype head.
        ``texture.pallas_head`` takes the per-point MLP kernel instead."""
        head = self.netC.surface_classifier
        if self.config.texture.pallas_head:
            packed = pack_mlp_params(head, self.compute_dtype, self.device)
            return lambda x: apply_mlp(packed, x)
        if self.compute_dtype == torch.float32:
            return None
        return copy.deepcopy(head).float()

    def _ray_ok(self, net: MonoPortNet) -> bool:
        """True iff ``net`` may take the ray- and grid-structured queries
        (the JAX engine's ``_ray_head is not None``): they are allowed, the
        net is orthographic and its z feature is a scalar. Decided per net
        from its config, before any frame."""
        return (self.config.ray.use_ray_query and _scalar_z(net)
                and CN(net.opt_net).projection == "orthogonal")

    def _calib_taps_ok(self, calibs) -> bool:
        """True iff every calib has z-free image-plane rows (host check on
        the numpy calib), the net is orthographic and the ray-structured
        queries are allowed. A perspective net never qualifies: its
        z-divide moves (u, v) along every ray."""
        if not self.config.ray.use_ray_query:
            return False
        if CN(self.netG.opt_net).projection != "orthogonal":
            return False
        c = np.asarray(calibs)
        return bool(np.abs(c[..., :2, 2]).max() < 1e-6)

    def _calib_grid_ok(self, calibs) -> bool:
        """True iff the calib's image rows are diagonal and z-free (u from x
        alone, v from y alone): the condition of the separable query."""
        if not self._calib_taps_ok(calibs):
            return False
        c = np.asarray(calibs)
        return bool(max(np.abs(c[..., 0, 1]).max(),
                        np.abs(c[..., 1, 0]).max()) < 1e-6)

    def _feats_f32(self, feats):
        if self.compute_dtype == torch.float32:
            return feats
        return [[f.float() for f in fs] for fs in feats]

    def _refine_pairs(self) -> list:
        """(rc, rf) resolution pairs of the refine levels a rotated frame
        runs, in order: the march pyramid's chain, or the single
        coarse-to-fine pass of the hierarchy frame in ``mode='ray'``."""
        if self.march_levels and self.config.rotated.march:
            lv = list(self.march_levels) + [self.fine_res]
            return list(zip(lv[:-1], lv[1:]))
        if self.mode == "ray":
            return [(self.recon.resolutions[-1], self.fine_res)]
        return []

    def _rot_anchor_plan(self, calibs, image_h: int) -> tuple:
        """Host-side anchor count per refine level for a rotated calib (or
        any calib of a perspective net).

        A refine level's taps span (2*pad+1) fine voxels along recon z;
        under the net's projection they sweep an image-space chord whose
        length in feature texels is measured numerically: the span's end
        points go through the projection (affine or z-divide) for a grid
        of probe rays across the volume, and the worst chord counts. K
        anchors split the chord into K-1 lerp segments; K is the smallest
        count that keeps a segment under ``anchor_texels`` texels. A level
        that would need K >= taps gains nothing and runs exact per-point
        (None). An int ``anchors`` pins every level."""
        rot = self.config.rotated
        pairs = self._refine_pairs()
        if not rot.anchors or not pairs:
            return ()
        if rot.anchors != "auto":
            return tuple(int(rot.anchors) for _ in pairs)
        persp = CN(self.netG.opt_net).projection == "perspective"
        c = np.asarray(calibs, np.float64).reshape(-1, 4, 4)[0]
        feat_hw = max(image_h // 4, 2)          # stride-4 backbones
        b_min = np.asarray(self.recon.b_min, np.float64)
        b_max = np.asarray(self.recon.b_max, np.float64)
        # probe rays: a 5x5 (x, y) grid x a few z starts across the volume
        ax = np.linspace(0.0, 1.0, 5)
        gx, gy = np.meshgrid(ax, ax, indexing="ij")
        xy = np.stack([b_min[0] + gx.ravel() * (b_max[0] - b_min[0]),
                       b_min[1] + gy.ravel() * (b_max[1] - b_min[1])], -1)

        def uv(pts):
            homo = pts @ c[:3, :3].T + c[:3, 3]
            if persp:
                return homo[..., :2] / np.maximum(
                    np.abs(homo[..., 2:3]), 1e-9) * np.sign(homo[..., 2:3])
            return homo[..., :2]

        z_range = float(b_max[2] - b_min[2])
        plan = []
        for rc, rf in pairs:
            scale = (rf - 1) / (rc - 1)
            pad = math.ceil(scale) + 1
            world_span = (2 * pad + 1) * z_range / (rf - 1)
            span = 0.0
            for z0f in (0.0, 0.5, 1.0 - world_span / z_range):
                z0 = b_min[2] + z0f * z_range
                p0 = np.concatenate([xy, np.full((len(xy), 1), z0)], -1)
                p1 = p0.copy()
                p1[:, 2] += world_span
                span = max(span, float(
                    np.linalg.norm(uv(p1) - uv(p0), axis=-1).max()))
            texels = span * 0.5 * (feat_hw - 1)
            k = max(2, math.ceil(texels / rot.anchor_texels) + 1)
            plan.append(k if k < self.ray_taps else None)
        return tuple(plan)

    # -- query closures over one frame's features and calib ----------------
    # (under a mesh the per-point and per-ray closures run whole on this
    # rank's share, the grid closures shard inside, at their heads)
    def _query_occ_fn(self, feats, calib):
        def query_occ(pts):
            return self.netG.query(feats, pts, calib, head_fn=self.point_g)[0]
        return self._shard_rows(query_occ)

    def _query_taps_fn(self, feats, calib):
        def query_taps(xy, z_taps):
            return self.netG.query_taps(feats, xy, z_taps, calib,
                                        head_taps_fn=self.head_g)[..., 0]
        return self._shard_rows(query_taps)

    def _query_anchored_fn(self, feats, calib, anchors: int):
        """Anchored ray occupancy query of a rotated refine level (the
        [B,R,2] xy + [B,R,T] z -> [B,R,T] contract of ``_query_taps_fn``,
        valid for any affine calib and for perspective nets)."""
        def query_anchored(xy, z_taps):
            return self.netG.query_taps_anchored(
                feats, xy, z_taps, calib, anchors=anchors,
                head_anchor_fn=self.anchor_g)[..., 0]
        return self._shard_rows(query_anchored)

    def _query_grid_fn(self, feats, calib):
        def query_grid(xw, yw, wz):
            return self.netG.query_taps_grid(
                feats, xw[None], yw[None], wz[None], calib,
                head_taps_fn=self.grid_g)[0, ..., 0]
        return query_grid

    def _grid_color_fn(self, feats, calib):
        def color_grid(xw, yw, zw):
            return self.netC.query_taps_grid(
                feats, xw[None], yw[None], zw[None, ..., None], calib,
                head_taps_fn=self.grid_c)[0, :, :, 0, :]
        return color_grid

    def _query_color_fn(self, feats, calib):
        def query_color(pts):
            return self.netC.query(feats, pts, calib,
                                   head_fn=self.point_c)[0].float()
        return self._shard_rows(query_color)

    def _texture_canvas(self, maps: SurfaceMaps, resolution: int,
                        color_grid=None, query_color=None,
                        compact: Optional[float] = None,
                        telemetry: Optional[list] = None,
                        reuse: Optional[dict] = None) -> torch.Tensor:
        """Texture canvas for both colour queries, on a window^2 lattice
        over the subject's bbox when a window is set (resampled back: an
        exact gather at stride 1, bilinear colours beyond).

        ``color_grid`` (frontal frames): the separable grid query.
        ``query_color`` (every other frame): the per-point query on the
        same window lattice. ``compact``: per-point only; query just the
        window pixels whose ray is valid, padded to this fraction of the
        window lattice; the rest stay background white and are masked by
        ``maps.valid`` anyway. ``reuse``: the last refine level's compact
        state; the colour query runs at that level's gathered rays and
        refined depths. World coordinates still step by 1/r here, not by
        the refine's 1/(r-1). ``texture.stride`` > 1: a dense strided
        lattice over the window span instead of the valid set."""
        r = resolution
        dev = maps.depth.device
        b_min = _f32(self.recon.b_min, dev)
        b_max = _f32(self.recon.b_max, dev)
        sr = (b_max - b_min) / r
        w = self.ray_window
        stride = self.config.texture.stride
        fr = torch.arange(r, dtype=torch.float32, device=dev)

        def finish(color):
            color = color * 0.5 + 0.5
            return torch.where(maps.valid[..., None], color,
                               torch.ones_like(color))

        def from_window(color_w, x0, sx, y0, sy, n):
            u = torch.clamp((fr - x0) / sx, 0.0, n - 1)
            v = torch.clamp((fr - y0) / sy, 0.0, n - 1)
            return finish(torch.stack([_sample_grid(color_w[..., k], u, v)
                                       for k in range(3)], dim=-1))

        def lattice_points(xw, yw, zw):
            h, ww = zw.shape
            return torch.stack([xw[:, None].expand(h, ww),
                                yw[None, :].expand(h, ww), zw],
                               dim=-1).reshape(1, -1, 3)

        if w is None or w >= r:
            if color_grid is not None:
                return finish(color_grid(
                    fr * sr[0] + b_min[0], fr * sr[1] + b_min[1],
                    (float(r) - maps.depth) * sr[2] + b_min[2]))
            return colorize(maps, query_color, r, self.recon.b_min,
                            self.recon.b_max)
        if stride > 1 and query_color is not None:
            # dense strided lattice: no valid resample, no index set, no
            # scatter (and no telemetry row: it cannot drop pixels)
            if reuse is not None:
                w = reuse["w"]
                x0, sx, y0, sy = (reuse[k] for k in ("x0", "sx", "y0", "sy"))
            else:
                x0, sx = _axis_window(maps.valid.any(dim=1), r, r, 1.0, w)
                y0, sy = _axis_window(maps.valid.any(dim=0), r, r, 1.0, w)
            wc = max(2, w // stride)
            sxc = sx * (w - 1) / (wc - 1)
            syc = sy * (w - 1) / (wc - 1)
            ar = torch.arange(wc, dtype=torch.float32, device=dev)
            ac = x0 + ar * sxc
            bc = y0 + ar * syc
            depth_c = _sample_grid(maps.depth, ac, bc)
            pts = lattice_points(ac * sr[0] + b_min[0], bc * sr[1] + b_min[1],
                                 (float(r) - depth_c) * sr[2] + b_min[2])
            color_c = query_color(pts)[0].reshape(wc, wc, 3)
            return from_window(color_c, x0, sxc, y0, syc, wc)
        if reuse is not None:
            w = reuse["w"]
            idx, safe = reuse["idx"], reuse["safe"]
            if telemetry is not None:
                # a ray dropped at the refine level loses its texture too
                telemetry.append(reuse["dropped"])
            xw = reuse["aw"] * sr[0] + b_min[0]
            yw = reuse["bw"] * sr[1] + b_min[1]
            zw_sel = (float(r) - reuse["z"]) * sr[2] + b_min[2]    # [K]
            pts = torch.stack([xw[safe // w], yw[safe % w], zw_sel],
                              dim=-1)[None]                        # [1, K, 3]
            color_w = self._scatter_colors(query_color(pts)[0], idx, w)
            return from_window(color_w, reuse["x0"], reuse["sx"],
                               reuse["y0"], reuse["sy"], w)
        x0, sx = _axis_window(maps.valid.any(dim=1), r, r, 1.0, w)
        y0, sy = _axis_window(maps.valid.any(dim=0), r, r, 1.0, w)
        ar = torch.arange(w, dtype=torch.float32, device=dev)
        aw = x0 + ar * sx
        bw = y0 + ar * sy
        depth_w = _sample_grid(maps.depth, aw, bw)
        xw = aw * sr[0] + b_min[0]
        yw = bw * sr[1] + b_min[1]
        zw = (float(r) - depth_w) * sr[2] + b_min[2]
        budget = None if color_grid is not None else _compact_rays(compact,
                                                                   w, w)
        if color_grid is not None:
            color_w = color_grid(xw, yw, zw)
        elif budget:
            v_w = _sample_grid(maps.valid.float(), aw, bw) > 0.0
            if telemetry is not None:
                # valid pixels beyond the budget keep the white background
                telemetry.append(torch.clamp(
                    v_w.sum(dtype=torch.int32) - budget, min=0))
            idx = _valid_indices(v_w.reshape(-1), budget)
            safe = torch.where(idx < w * w, idx, torch.zeros_like(idx))
            pts = torch.stack([xw[safe // w], yw[safe % w],
                               zw.reshape(-1)[safe]], dim=-1)[None]
            color_w = self._scatter_colors(query_color(pts)[0], idx, w)
        else:
            color_w = query_color(lattice_points(xw, yw, zw))[0].reshape(
                w, w, 3)
        return from_window(color_w, x0, sx, y0, sy, w)

    @staticmethod
    def _scatter_colors(col: torch.Tensor, idx: torch.Tensor,
                        w: int) -> torch.Tensor:
        """Colours [K, 3] at the flat window indices ``idx`` on a white
        [w, w, 3] lattice (fill entries of ``idx`` are dropped)."""
        buf = torch.ones(w * w + 1, 3, dtype=col.dtype, device=col.device)
        buf.index_put_((idx,), col)
        return buf[:w * w].reshape(w, w, 3)

    @torch.no_grad()
    def frame(self, image_g: torch.Tensor,
              image_c: Optional[torch.Tensor] = None, calib=None,
              compact_hint: Optional[float] = None) -> dict:
        """One frame. images NHWC [1, H, W, 3]; calib a host [1, 4, 4]
        array (numpy; identity when None). -> {'depth', 'valid',
        'render_norm', 'mask'} (+ 'render_tex' with netC and image_c;
        + 'compact_dropped' on compacted frames: the dropped valid rays
        of each refine level, then of the texture stage; + 'sdf', the
        volume, and 'recon_counts', the candidate voxels of each refine
        level, on hierarchy frames).

        The path follows the calib: frontal calibs take the grid queries,
        in-plane rotations the ray taps, every other calib the rotated
        path; a frame marches when ``march_levels`` is set and its calib
        is frontal / in-plane or ``rotated.march`` is on, and takes the
        hierarchy otherwise (module docstring).

        compact_hint: the window-valid fraction measured on an earlier
        frame (``compact_hint_from_valid``); rotated frames snap it up
        COMPACT_LADDER and run that budget instead of the constructor's
        ceiling. The output is identical whenever nothing drops, and drops
        are counted. Ignored on frontal frames and when compaction is
        off."""
        if calib is None:
            calib = np.eye(4, dtype=np.float32)[None]
        if isinstance(calib, torch.Tensor):
            calib = calib.detach().cpu().numpy()
        cfg = self.config
        use_taps = self._calib_taps_ok(calib)
        use_grid = self._calib_grid_ok(calib)
        compact = None if use_taps else cfg.rotated.compact
        if compact_hint is not None and compact is not None:
            compact = _snap_budget(compact_hint, compact)
        rot_k = () if use_taps else self._rot_anchor_plan(
            calib, image_g.shape[1])

        calib_t = upload_async(np.asarray(calib, np.float32), self.device)
        dt = self.compute_dtype
        image_g = image_g.to(device=self.device, dtype=dt)
        feats_g = self._feats_f32(self.netG.filter(image_g))

        # a soft-onehot netG has no ray-structured query: its frontal frame
        # takes the hierarchy and its rotated frame refines per point
        ray_g = use_taps and self.head_g is not None
        if ray_g:
            taps_fns = self._query_taps_fn(feats_g, calib_t)
        elif self.anchor_g is not None and any(rot_k):
            # anchored ray query per refine level, K from the host-side
            # plan; the dense march stays per-point (full-volume tap spans)
            taps_fns = [self._query_anchored_fn(feats_g, calib_t, k)
                        if k else None for k in rot_k]
        else:
            taps_fns = None
        query_occ = self._query_occ_fn(feats_g, calib_t)
        query_grid = (self._query_grid_fn(feats_g, calib_t)
                      if use_grid and ray_g else None)
        telemetry: list = []
        tex_state: list = []
        vol, counts = None, []
        resolution = self.fine_res
        if self.march_levels and (ray_g or (not use_taps
                                            and cfg.rotated.march)):
            # volume-free: no hierarchy, no depth peel, no sdf
            want_state = (cfg.texture.reuse_compact and not use_taps
                          and self.netC is not None and image_c is not None)
            maps = ray_pyramid(
                query_occ, self.fine_res, levels=self.march_levels,
                taps=self.ray_taps, balance_value=self.recon.balance_value,
                b_min=self.recon.b_min, b_max=self.recon.b_max,
                window=self.ray_window, query_taps_fn=taps_fns,
                query_grid_fn=query_grid, march_taps=use_taps,
                compact=compact, telemetry=telemetry,
                compact_state=tex_state if want_state else None,
                device=self.device)
        else:
            vol, counts = self.recon(query_occ, return_counts=True,
                                     device=self.device)
            if self.mode == "ray":
                # one coarse-to-fine level: the rotated plan has one entry
                if isinstance(taps_fns, list):
                    taps_fns = taps_fns[-1]
                maps = ray_refine(
                    query_occ, vol, self.fine_res, taps=self.ray_taps,
                    balance_value=self.recon.balance_value,
                    b_min=self.recon.b_min, b_max=self.recon.b_max,
                    direction=self.direction, window=self.ray_window,
                    query_taps_fn=taps_fns, query_grid_fn=query_grid)
            else:
                resolution = self.recon.resolutions[-1]
                maps = depth_peel(vol, self.direction,
                                  self.recon.balance_value)
        render_norm, mask = visualize(shade_normal(maps), self.render_size)
        out = {"depth": maps.depth, "valid": maps.valid,
               "render_norm": render_norm, "mask": mask}
        if vol is not None:
            out["sdf"] = vol
        if counts:
            out["recon_counts"] = torch.stack(counts)
        if self.netC is not None and image_c is not None:
            image_c = image_c.to(device=self.device, dtype=dt)
            # the f32 prior promotes the concatenated maps to f32, as in
            # the JAX engine
            feat_prior = feats_g[-1][-1]
            feats_c = self.netC.filter(image_c, feat_prior)
            if not (cfg.texture.bf16 and not use_taps):
                feats_c = self._feats_f32(feats_c)
            if use_grid and self.head_c is not None:
                tex = self._texture_canvas(
                    maps, resolution,
                    color_grid=self._grid_color_fn(feats_c, calib_t))
            else:
                tex = self._texture_canvas(
                    maps, resolution,
                    query_color=self._query_color_fn(feats_c, calib_t),
                    compact=compact, telemetry=telemetry,
                    reuse=tex_state[0] if tex_state else None)
            render_tex, mask_tex = visualize(tex, self.render_size)
            out.update({"render_tex": render_tex, "mask": mask_tex})
        if telemetry:
            out["compact_dropped"] = torch.stack(telemetry)
        return out

    def band_report(self, out: dict) -> str:
        """Candidate counts of the hierarchy's refine levels against their
        budgets from a frame's output (fetches ``recon_counts``). With
        select='uncertain' an overflow drops the most confident voxels
        first, but it must be visible."""
        if "recon_counts" not in out:
            return "recon band: no refine levels"
        counts = out["recon_counts"].detach().cpu().tolist()
        truncated = self.recon.select != "uncertain"
        parts, overflow = [], False
        for res, c, b in zip(self.recon.resolutions[1:], counts,
                             self.recon.budgets[1:]):
            flag = ""
            if c > b:
                overflow = True
                flag = " OVERFLOW(TRUNCATED)" if truncated else " OVERFLOW"
            parts.append(f"{res}^3: {int(c)}/{b}{flag}")
        head = "recon band candidates/budget — "
        if overflow:
            head = ("recon band OVER BUDGET (raise recon.budgets or keep "
                    "select='uncertain' for graceful degradation) — ")
        return head + ", ".join(parts)

    def compact_report(self, out: dict) -> str:
        """Dropped-ray counts of the rotated compaction budgets from a
        frame's output (fetches ``compact_dropped``). Overflow degrades
        gracefully (dropped rays keep the coarse silhouette, dropped
        texture pixels the white background under the valid mask), but it
        must be visible."""
        if "compact_dropped" not in out:
            return "compact: dense (no ray compaction in this frame)"
        dropped = out["compact_dropped"].detach().cpu().tolist()
        labels = [f"refine{rc}->{rf}" for rc, rf in self._refine_pairs()]
        if len(dropped) == len(labels) + 1:
            labels.append("texture")
        parts = [f"{lb}: {int(d)} dropped" for lb, d in zip(labels, dropped)]
        if any(dropped):
            return ("compact OVERFLOW (raise compact_rotated or shrink the"
                    " subject window) — " + ", ".join(parts))
        return "compact budgets ok — " + ", ".join(parts)

    def compact_hint_from_valid(self, valid_fraction: float,
                                safety: float = 1.3) -> float:
        """Adaptive-budget hint from an earlier frame's fetched valid
        fraction (valid pixels / full fine lattice): rescaled to the
        window the budgets are fractions of, with headroom for the
        subject's growth between frames. Feed it to
        ``frame(compact_hint=...)``."""
        w = self.ray_window or self.fine_res
        window_frac = (self.fine_res / float(w)) ** 2
        return float(valid_fraction) * window_frac * safety

    def frames(self, images_g: torch.Tensor,
               images_c: Optional[torch.Tensor] = None, calibs=None) -> dict:
        """A clip: images [B, H, W, 3], calibs a host [B, 4, 4] array
        (identity when None) -> the outputs of ``frame`` with a leading
        clip axis, in clip order.

        The kernels take one frame a launch, so a clip is a loop over its
        frames, and each frame takes the path of its own calib: one
        rotated frame does not take the clip off the grid path (the JAX
        engine groups a clip by path for the same end). Keys are those
        every frame has: a rotated frame's ``compact_dropped`` goes when
        the clip also holds frontal frames."""
        b = images_g.shape[0]
        if calibs is None:
            calibs = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
        if isinstance(calibs, torch.Tensor):
            calibs = calibs.detach().cpu().numpy()
        calibs = np.asarray(calibs, np.float32).reshape(b, 1, 4, 4)
        outs = [self.frame(images_g[i:i + 1],
                           None if images_c is None else images_c[i:i + 1],
                           calibs[i]) for i in range(b)]
        keys = set.intersection(*(set(o) for o in outs))
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]
                if k in keys}

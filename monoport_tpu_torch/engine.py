"""ReconEngine — the frame program on the card (port of
``monoport_tpu/engine.py``): the real-time march-pyramid frames, frontal
and rotated, the hierarchy frames (``mode='dense'`` and the coarse-volume
``mode='ray'``) and clips (``frames``).

One frame: netG ``HGFilter`` over the image, surface localization, normal
shading, netC ``ResnetFilter`` with netG's last feature map as its prior,
the colour query (the texture stage, ``recon/texture.texture_canvas``),
and the display resize. Surface localization is one of

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
* rotated (free-viewpoint) calibs and every calib of a perspective net:
  the march runs the exact per-point query through the per-point MLP
  kernel (``ops/cuda/fused_mlp.apply_mlp``); each refine level queries
  only its coarse-valid rays (compaction, a static budget) through the
  anchored ray MLP (``fused_ray_mlp.apply_anchor``) with the anchor count
  the host-side plan gives that level, or exact per-point where the plan
  gives none; the per-point colour query rides the last level's
  compaction (``recon/ray_refine.RayCompaction``).

A net with soft-onehot z features (``normalizer.soft_onehot``) takes no
ray, grid or anchored query, decided per net from its config as in the JAX
engine: a soft-onehot netG's frontal frame takes the hierarchy, its
rotated frame marches and refines per point, and a soft-onehot netC's
colour query runs per point.

A multi-view netG (PIFu's ``num_views`` V > 1, ``models/monoport_net.py``)
takes the V images of one subject, ``image_g`` [V, H, W, 3], and a calib a
view, [V, 4, 4], and runs the dense frame alone: netG's backbone over the
V images (on the card one graph at batch V), the hierarchy, each level's
points projected and sampled in every view (span ``recon.views.sample``)
and run through the view-pooled per-point kernel
(``fused_mlp.apply_mlp_views``, f32), then the depth peel and the shading
of the volume along ``direction``. No ray or anchored head is packed for
it, and an engine that would run it anywhere else (a mode other than
'dense', so the march, the rotated path and ``ray_refine``; a netC; a
mesh) or in bf16 raises ``ValueError`` at construction.

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

On the card each backbone call (netG's ``filter`` and upcast, netC's
``filter`` over the prior and its upcast) and each stage of the march
pyramid (the march, each refine level) is captured into a CUDA graph in
the first frame of its signature and replayed in every later one
(``frame_graphs.py``): one copy of the image or the calib and one graph
launch where the eager call launches hundreds to ~1,000 kernels,
bit-equal to it. A stage's signature is what the host plan selects for it
(``stage_key``: the stage, the path, the window, the compaction rung, the
anchor count) and its inputs' shapes; it reads netG's maps and the
previous stage's maps in place. Hierarchy and peel frames, and the stages
of an engine whose mesh shards the rows, stay eager. Each such span
carries ``graph`` = ``capture`` | ``replay`` | ``eager`` (a backbone's
beside its ``imf`` and the queried ``stage``'s map shapes), and
``self.graphs.counts`` counts the calls of netG, netC and the stages
(``recon``) by mode. The outputs are graph-pool tensors that the next
frame overwrites; ``frame`` returns copies of the last stage's depth and
valid, and no output of it aliases them.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import math
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from .frame_graphs import FrameGraphs, leaves
from .config import CN
from .models import MonoPortNet
from .ops.constants import upload_async
from .ops.cuda.fused_mlp import (apply_mlp, apply_mlp_views, check_views,
                                 pack_mlp_params)
from .ops.cuda.fused_ray_mlp import (apply_anchor, apply_ray,
                                     pack_ray_mlp_params)
from .parallel.mesh import POINT_AXIS, Mesh, check_mesh
from .recon.depth_peel import (SurfaceMaps, depth_peel, shade_normal,
                               visualize)
from .recon.hierarchy import HierarchicalRecon
from .recon.ray_refine import (PyramidStage, pyramid_stages, ray_refine,
                               run_stage)
from .recon.texture import texture_canvas
from .utils import profiling
from .weights import resolve_device

# Adaptive rotated-compaction budget rungs: frame(compact_hint=...) snaps
# the hint up to one of these, so a bounded set of shapes ever runs.
COMPACT_LADDER = (0.25, 0.375, 0.5, 0.625)


def _scalar_z(net: MonoPortNet) -> bool:
    """True iff ``net``'s z feature is the scalar normalizer (not the
    soft-onehot one, whose nets only take per-point queries)."""
    return not CN(net.opt_net).normalizer.get("soft_onehot", False)


def _backbone_attrs(net: MonoPortNet, feats) -> dict:
    """A backbone span's attributes beside ``graph``: the backbone's
    ``imf`` and the [h, w, c] of each map of the stage the queries read
    (the last), from shapes alone; a multi-view net's ``views`` too."""
    attrs = {"imf": net.opt_net.backbone.IMF,
             "stage": [list(f.shape[1:]) for f in feats[-1]]}
    if net.num_views > 1:
        attrs["views"] = net.num_views
    return attrs


def stage_key(stage: PyramidStage, path: str, rung: Optional[float],
              anchors: int) -> tuple:
    """The host values a march-pyramid stage's work follows, for its
    graph's key beside its inputs' shapes and dtypes: the stage (march, or
    the refine ``rc -> rf``), the frame's path, the stage's window, its
    compaction rung (None: dense) and its anchor count (0: none)."""
    return (stage.rc, stage.rf, path, stage.window, rung, anchors)


def _snap_budget(hint: float, ceiling: float) -> float:
    """Smallest COMPACT_LADDER rung >= hint, capped at the constructor
    ceiling (a capped rung may drop rays; telemetry counts them)."""
    for rung in COMPACT_LADDER:
        if rung >= hint:
            return min(rung, ceiling)
    return ceiling


def _check_views_path(cfg: "EngineCfg", netC, mesh, views: int) -> None:
    """Raise ValueError where an engine of a multi-view netG would run a
    path other than the dense hierarchy frame, or a dtype the view-pooled
    kernel lacks."""
    where = f"the multi-view netG ({views} views) runs the dense frame alone"
    if cfg.ray.mode != "dense":
        raise ValueError(f"{where}: mode={cfg.ray.mode!r} (the march, the "
                         f"rotated path and ray_refine take one view)")
    if netC is not None:
        raise ValueError(f"{where}: no netC (its colour query would need "
                         f"the same pooling)")
    if mesh is not None:
        raise ValueError(f"{where}: no mesh")
    if cfg.compute_dtype != torch.float32:
        raise ValueError(f"{where}: the view-pooled kernel has an f32 route "
                         f"only, not {cfg.compute_dtype}")


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

    The ray-structured queries (one gather per ray, the projections
    shared by its taps) run wherever the calib's image rows are z-free
    and the net allows them; ``frame()`` checks per call."""
    mode: str = "dense"
    fine_res: int = 257
    taps: int = 6
    window: Optional[int] = None
    march_levels: Optional[tuple] = None


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

    @classmethod
    def flat(cls, **knobs) -> "EngineCfg":
        """A grouped config from the JAX package's flat knob names
        (``monoport_tpu.engine.EngineCfg.flat``). An unknown name raises
        ``KeyError``. A knob of ``_FIXED_KNOBS`` is one the port runs at
        one value only: that value changes nothing, any other raises
        ``ValueError``. They are the kernel routes (no interpret mode, no
        plain route in place of a kernel: ``use_pallas``,
        ``pallas_interpret``), the ray-structured queries wherever calib
        and net allow them (``use_ray_query``), and the texture stage's
        upcast netC maps, reused refine compaction, exact colour lattice
        and plain per-point colour head (``tex_bf16``,
        ``tex_reuse_compact``, ``tex_stride``, ``tex_pallas_head``)."""
        top: dict = {}
        groups: dict = {"ray": {}, "rotated": {}}
        for name, value in knobs.items():
            if name in _FIXED_KNOBS:
                if value != _FIXED_KNOBS[name]:
                    raise ValueError(
                        f"{name}={value!r}: the port runs only "
                        f"{name}={_FIXED_KNOBS[name]!r}")
                continue
            where = _FLAT[name]
            if where is None:
                top[name] = value
            else:
                groups[where[0]][where[1]] = value
        return cls(ray=RayCfg(**groups["ray"]),
                   rotated=RotatedCfg(**groups["rotated"]), **top)


# the JAX package's flat knob names -> (group, field); None = top level
_FLAT = {
    "render_size": None, "direction": None, "compute_dtype": None,
    "mode": ("ray", "mode"), "fine_res": ("ray", "fine_res"),
    "ray_taps": ("ray", "taps"), "ray_window": ("ray", "window"),
    "march_levels": ("ray", "march_levels"),
    "march_rotated": ("rotated", "march"),
    "compact_rotated": ("rotated", "compact"),
    "rot_anchors": ("rotated", "anchors"),
    "rot_anchor_texels": ("rotated", "anchor_texels"),
}
# the rest of the JAX package's flat knobs, and the one value each takes
# here (``EngineCfg.flat``)
_FIXED_KNOBS = {"use_pallas": True, "pallas_interpret": False,
                "use_ray_query": True, "tex_bf16": False,
                "tex_reuse_compact": True, "tex_stride": 1,
                "tex_pallas_head": False}


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
        self.views = netG.num_views
        if self.views > 1:
            _check_views_path(cfg, netC, mesh, self.views)
        # the compute-dtype copies of the nets (JAX ``_cast`` of params)
        self.netG = self._cast(netG)
        self.netC = self._cast(netC) if netC is not None else None
        # head operands, packed once: the ray and anchored kernels share
        # one packing, the per-point kernel has its own. A net with
        # soft-onehot z gets no ray-structured head (its z is no scalar
        # column), and ``frame()`` sends its queries per point; nor does a
        # multi-view net, whose queries run the view-pooled form.
        dt, dev = self.compute_dtype, self.device
        point_g = pack_mlp_params(self.netG.surface_classifier, dt, dev)
        self.point_g = lambda x: apply_mlp(point_g, x)
        if self.views > 1:
            check_views(point_g, self.views)
            self.point_g = lambda x: apply_mlp_views(point_g, x, self.views)
        self.head_g = self.anchor_g = self.head_c = self.point_c = None
        if _scalar_z(self.netG) and self.views == 1:
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
        # the backbone calls and the march pyramid's stages, replayed from
        # a CUDA graph a signature on the card (each rank of a mesh
        # captures its own backbones)
        self.graphs = FrameGraphs(self.device)

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
        weights: here that is an f32 copy of the compute-dtype head."""
        if self.compute_dtype == torch.float32:
            return None
        return copy.deepcopy(self.netC.surface_classifier).float()

    def _ray_ok(self, net: MonoPortNet) -> bool:
        """True iff ``net`` may take the ray- and grid-structured queries
        (the JAX engine's ``_ray_head is not None``): the net is
        orthographic and its z feature is a scalar. Decided per net from
        its config, before any frame."""
        return (_scalar_z(net)
                and CN(net.opt_net).projection == "orthogonal")

    def _calib_taps_ok(self, calibs) -> bool:
        """True iff every calib has z-free image-plane rows (host check on
        the numpy calib) and the net is orthographic. A perspective net
        never qualifies: its z-divide moves (u, v) along every ray."""
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

    def _filter_g(self, image):
        if self.views == 1:
            return self._feats_f32(self.netG.filter(image))
        # a multi-view net's views one at a time, their maps concatenated:
        # at batch 4 in f32 (TF32 off, cuDNN's heuristics) the hourglass's
        # convolutions take an FFT algorithm that an H100 ran 47x slower
        # than four calls at batch 1, with 25x the memory (PERF.md)
        per_view = [self.netG.filter(image[v:v + 1])
                    for v in range(image.shape[0])]
        return self._feats_f32([[torch.cat(maps) for maps in zip(*stage)]
                                for stage in zip(*per_view)])

    def _filter_c_f32(self, image, prior):
        return self._feats_f32(self.netC.filter(image, prior))

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
    # rank's share, the grid closures shard inside, at their heads; each
    # closure makes a ``profiling.query`` record of the rows it was asked
    # for, before any sharding)
    @staticmethod
    def _recorded(name: str, fn, anchors: int = 0):
        """``fn`` (inputs [B, R, ...], the second's last axis the taps)
        with a ``query`` record of its R rows at each call."""
        def recorded(*arrays):
            profiling.query(name, arrays[0].shape[1],
                            arrays[1].shape[-1] if len(arrays) > 1 else 1,
                            anchors)
            return fn(*arrays)
        return recorded

    def _query_occ_fn(self, feats, calib):
        if self.views > 1:
            return self._query_views_fn(feats, calib)

        def query_occ(pts):
            return self.netG.query(feats, pts, calib, head_fn=self.point_g)[0]
        return self._recorded("query_occ", self._shard_rows(query_occ))

    def _query_views_fn(self, feats, calib):
        """A multi-view net's occupancy query of [B, N, 3] points: the V
        views' projection and sampling under the span
        ``recon.views.sample``, then the view-pooled head; its ``query``
        record counts the points, with ``views``."""
        net = self.netG

        def query_views(pts):
            profiling.query("query_occ", pts.shape[1], views=self.views)
            with profiling.span("recon.views.sample"):
                x, in_img = net.sample_views(feats[-1], pts, calib)
            pred = self.point_g(x)
            return in_img[..., None].to(pred.dtype) * pred
        return query_views

    def _query_taps_fn(self, feats, calib):
        def query_taps(xy, z_taps):
            return self.netG.query_taps(feats, xy, z_taps, calib,
                                        head_taps_fn=self.head_g)[..., 0]
        return self._recorded("query_taps", self._shard_rows(query_taps))

    def _query_anchored_fn(self, feats, calib, anchors: int):
        """Anchored ray occupancy query of a rotated refine level (the
        [B,R,2] xy + [B,R,T] z -> [B,R,T] contract of ``_query_taps_fn``,
        valid for any affine calib and for perspective nets)."""
        def query_anchored(xy, z_taps):
            return self.netG.query_taps_anchored(
                feats, xy, z_taps, calib, anchors=anchors,
                head_anchor_fn=self.anchor_g)[..., 0]
        return self._recorded("query_anchored",
                              self._shard_rows(query_anchored), anchors)

    def _query_grid_fn(self, feats, calib):
        def query_grid(xw, yw, wz):
            profiling.query("query_grid", wz.shape[0] * wz.shape[1],
                            wz.shape[2])
            return self.netG.query_taps_grid(
                feats, xw[None], yw[None], wz[None], calib,
                head_taps_fn=self.grid_g)[0, ..., 0]
        return query_grid

    def _grid_color_fn(self, feats, calib):
        def color_grid(xw, yw, zw):
            profiling.query("color_grid", zw.shape[0] * zw.shape[1])
            return self.netC.query_taps_grid(
                feats, xw[None], yw[None], zw[None, ..., None], calib,
                head_taps_fn=self.grid_c)[0, :, :, 0, :]
        return color_grid

    def _query_color_fn(self, feats, calib):
        def query_color(pts):
            return self.netC.query(feats, pts, calib,
                                   head_fn=self.point_c)[0].float()
        return self._recorded("query_color", self._shard_rows(query_color))

    def _anchors(self, ray_g: bool, rot_k: tuple, level: int) -> int:
        """The anchor count of refine level ``level``'s query: the plan's K
        on the anchored rotated path, else 0 (the ray taps, or exact per
        point)."""
        if ray_g or self.anchor_g is None or not rot_k:
            return 0
        return rot_k[level] or 0

    def _level_taps_fn(self, feats, calib, ray_g: bool, anchors: int):
        """A refine level's ray query: the ray taps, the anchored query of
        ``anchors`` anchors, or None (exact per point)."""
        if ray_g:
            return self._query_taps_fn(feats, calib)
        if anchors:
            return self._query_anchored_fn(feats, calib, anchors)
        return None

    def _march(self, feats_g, calib_t, path: str, compact: Optional[float],
               rot_k: tuple) -> tuple:
        """The march pyramid (``ray_pyramid``), a stage at a time under the
        stage's span, each stage one call of ``self.graphs`` (name
        ``recon``; span attribute ``graph``): replayed from a graph on the
        card, eager elsewhere and on a mesh that shards the rows. A stage
        reads the calib (copied into its graph's buffer), netG's maps and
        the previous stage's maps (graph outputs, read in place); its key
        is what the host plan selects (``stage_key``). -> (SurfaceMaps,
        the dropped-ray counts, [the last level's RayCompaction] or []).
        The returned depth and valid are copies out of the graph's pool,
        which the next frame overwrites."""
        ray_g = path in ("grid", "taps")
        sharded = (self.mesh is not None
                   and self.mesh.shape[POINT_AXIS] > 1)
        feat_leaves = leaves(feats_g)
        sizes = [len(fs) for fs in feats_g]
        stages = pyramid_stages(self.march_levels, self.fine_res,
                                self.ray_window)
        maps, telemetry, state = None, [], []
        for stage in stages:
            # the march runs the taps or exact per point (the anchored
            # lerp holds only over a refine level's short tap span)
            k = 0 if stage.rc is None else self._anchors(ray_g, rot_k,
                                                         stage.level)
            rung = None if stage.rc is None else compact
            prev = () if maps is None else tuple(maps)
            fn = functools.partial(self._stage, stage, path, rung, k, sizes,
                                   len(prev))
            name, attrs = stage.span()
            with profiling.span(name, **attrs) as sp:
                (maps, dropped, comp), mode = self.graphs.run(
                    "recon", fn, (calib_t,) + prev + tuple(feat_leaves),
                    extra=stage_key(stage, path, rung, k),
                    capture=not sharded)
                if stage is stages[-1] and mode != "eager":
                    maps = maps._replace(depth=maps.depth.clone(),
                                         valid=maps.valid.clone())
                if sp is not None:
                    sp.attrs["graph"] = mode
            telemetry += dropped
            state += comp
        return maps, telemetry, state

    def _stage(self, stage: PyramidStage, path: str, rung: Optional[float],
               anchors: int, sizes: list, n_prev: int, calib, *tensors):
        """One pyramid stage over the calib, the previous stage's maps
        (``n_prev`` tensors) and netG's maps (stages of ``sizes`` maps),
        its queries built over these very tensors (the graph's) ->
        (SurfaceMaps, [dropped counts], [RayCompaction])."""
        prev, flat = tensors[:n_prev], tensors[n_prev:]
        feats, i = [], 0
        for n in sizes:
            feats.append(list(flat[i:i + n]))
            i += n
        ray_g = path in ("grid", "taps")
        telemetry: list = []
        state: list = []
        maps = run_stage(
            stage, SurfaceMaps(*prev) if prev else None,
            self._query_occ_fn(feats, calib),
            self._level_taps_fn(feats, calib, ray_g, anchors),
            self._query_grid_fn(feats, calib) if path == "grid" else None,
            taps=self.ray_taps, balance_value=self.recon.balance_value,
            b_min=self.recon.b_min, b_max=self.recon.b_max, compact=rung,
            telemetry=telemetry, compact_state=state, device=self.device)
        return maps, telemetry, state

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
        with profiling.span(profiling.FRAME) as root:
            with profiling.span("engine.plan"):
                if calib is None:
                    calib = np.eye(4, dtype=np.float32)[None]
                if isinstance(calib, torch.Tensor):
                    calib = calib.detach().cpu().numpy()
                if self.views > 1:
                    self._check_views_inputs(image_g, calib)
                cfg = self.config
                use_taps = self._calib_taps_ok(calib)
                use_grid = self._calib_grid_ok(calib)
                compact = None if use_taps else cfg.rotated.compact
                if compact_hint is not None and compact is not None:
                    compact = _snap_budget(compact_hint, compact)
                rot_k = () if use_taps else self._rot_anchor_plan(
                    calib, image_g.shape[1])
                # a soft-onehot netG has no ray-structured query: its
                # frontal frame takes the hierarchy and its rotated frame
                # refines per point
                ray_g = use_taps and self.head_g is not None
                march = bool(self.march_levels) and (
                    ray_g or (not use_taps and cfg.rotated.march))
                calib_t = upload_async(np.asarray(calib, np.float32),
                                       self.device)
            if root is not None:
                root.attrs.update(path=self._path(use_grid, ray_g, march),
                                  rung=compact, plan=rot_k)
            return self._frame(image_g, image_c, calib_t, use_taps,
                               use_grid, ray_g, march, compact, rot_k)

    def _check_views_inputs(self, image_g, calib) -> None:
        v = self.views
        if image_g.shape[0] != v or np.shape(calib) != (v, 4, 4):
            raise ValueError(
                f"the multi-view netG takes {v} images and {v} calibs, one "
                f"a view: image_g [{v}, H, W, 3], calib [{v}, 4, 4]; got "
                f"{tuple(image_g.shape)} and {np.shape(calib)}")

    def _path(self, use_grid: bool, ray_g: bool, march: bool) -> str:
        """The frame's path, as its span names it: grid, taps, rotated
        (the march pyramid by the calib), hierarchy or peel (the volume)."""
        if not march:
            return "hierarchy" if self.mode == "ray" else "peel"
        if not ray_g:
            return "rotated"
        return "grid" if use_grid else "taps"

    def _frame(self, image_g, image_c, calib_t, use_taps: bool,
               use_grid: bool, ray_g: bool, march: bool,
               compact: Optional[float], rot_k: tuple) -> dict:
        """``frame`` after its host plan: the backbones, the surface, the
        shading and the texture, each under its span."""
        dt = self.compute_dtype
        with profiling.span("backbone.netG") as sp:
            feats_g, mode = self.graphs.run(
                "netG", self._filter_g, (image_g,), (dt,),
                extra=dt != torch.float32)
            if sp is not None:
                sp.attrs.update(graph=mode, **_backbone_attrs(self.netG,
                                                              feats_g))

        telemetry: list = []
        tex_state: list = []
        vol, counts = None, []
        resolution = self.fine_res
        if march:
            # volume-free: no hierarchy, no depth peel, no sdf; a rotated
            # frame's colour query reuses the last level's compaction
            maps, telemetry, tex_state = self._march(
                feats_g, calib_t, self._path(use_grid, ray_g, march),
                compact, rot_k)
        else:
            query_occ = self._query_occ_fn(feats_g, calib_t)
            with profiling.span("recon.hierarchy"):
                vol, counts = self.recon(query_occ, return_counts=True,
                                         device=self.device)
            if self.mode == "ray":
                # one coarse-to-fine level: the rotated plan has one entry
                maps = ray_refine(
                    query_occ, vol, self.fine_res, taps=self.ray_taps,
                    balance_value=self.recon.balance_value,
                    b_min=self.recon.b_min, b_max=self.recon.b_max,
                    direction=self.direction, window=self.ray_window,
                    query_taps_fn=self._level_taps_fn(
                        feats_g, calib_t, ray_g,
                        self._anchors(ray_g, rot_k, -1)),
                    query_grid_fn=(self._query_grid_fn(feats_g, calib_t)
                                   if use_grid and ray_g else None))
            else:
                resolution = self.recon.resolutions[-1]
                with profiling.span("recon.peel"):
                    maps = depth_peel(vol, self.direction,
                                      self.recon.balance_value)
        with profiling.span("render.shade"):
            render_norm, mask = visualize(shade_normal(maps),
                                          self.render_size)
        out = {"depth": maps.depth, "valid": maps.valid,
               "render_norm": render_norm, "mask": mask}
        if vol is not None:
            out["sdf"] = vol
        if counts:
            out["recon_counts"] = torch.stack(counts)
        if self.netC is not None and image_c is not None:
            with profiling.span("backbone.netC") as sp:
                # the f32 prior promotes the concatenated maps to f32, as
                # in the JAX engine
                feat_prior = feats_g[-1][-1]
                feats_c, mode = self.graphs.run(
                    "netC", self._filter_c_f32, (image_c, feat_prior),
                    (dt, feat_prior.dtype), extra=dt != torch.float32)
                if sp is not None:
                    sp.attrs.update(graph=mode, **_backbone_attrs(self.netC,
                                                                  feats_c))
            with profiling.span("texture.query"):
                lattice = (maps, resolution, self.recon.b_min,
                           self.recon.b_max, self.ray_window)
                if use_grid and self.head_c is not None:
                    tex = texture_canvas(
                        *lattice,
                        color_grid=self._grid_color_fn(feats_c, calib_t))
                else:
                    tex = texture_canvas(
                        *lattice,
                        query_color=self._query_color_fn(feats_c, calib_t),
                        compact=compact, telemetry=telemetry,
                        reuse=tex_state[0] if tex_state else None)
            with profiling.span("render.texture"):
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
        the clip also holds frontal frames. A multi-view net takes no
        clip."""
        if self.views > 1:
            raise ValueError(f"the multi-view netG ({self.views} views) "
                             f"takes one subject a frame(): no clip")
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

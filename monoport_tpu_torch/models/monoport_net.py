"""MonoPortNet — the pixel-aligned implicit-function network (port of
``monoport_tpu/models/monoport_net.py``).

Layouts follow the JAX package: images NHWC [B, H, W, C]; features
[B, h, w, C]; points point-major [B, N, 3]; predictions [B, N, Res].
``query(train=True)`` supervises every stage of the backbone (4 for the
4-stack HGFilter) through the plain head; ``train=False`` queries the last
stage only, as the engine's frames do. ``get_loss`` averages the MSE / L1
over the stages; ``forward`` with labels returns ``(pred, loss)``.

``num_views`` > 1 (the net's config, default 1) is PIFu's multi-view net
(PIFu section 3.3): ``filter`` takes the V images of each subject, [B *
V, H, W, C], and ``query`` takes the subject's points [B, N, 3] with one
calib a view, [B * V, 4, 4]. Each point is projected into every view and
sampled from that view's maps with that view's z feature
(``sample_views``), and the head pools the views at its middle layer. As
in PIFu's ``query`` at batch 1, a prediction is masked by the point's
being inside view 0's image.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..config import CN
from ..ops.constants import device_constant
from ..ops.projection import PROJECTIONS
from ..ops.resize import interpolate_2d
from ..ops.sampling import index, index_grid
from .backbones import BACKBONES
from .heads import HEAD_SPECS, HEADS
from .normalizers import PIFuNomalizer

FeatStages = Sequence[Sequence[torch.Tensor]]


def _anchor_positions(k: int) -> np.ndarray:
    """Chord positions of k anchors: 0..1 evenly, a single anchor at 0."""
    if k > 1:
        return np.linspace(0.0, 1.0, k, dtype=np.float32)
    return np.zeros((1,), np.float32)


def _arange(k: int) -> np.ndarray:
    return np.arange(k, dtype=np.float32)

NORMALIZERS = {"PIFuNomalizer": PIFuNomalizer}


def _in_image(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (u >= -1.0) & (u <= 1.0) & (v >= -1.0) & (v <= 1.0)


class MonoPortNet(nn.Module):
    """``head_channels`` overrides the published head widths (a small test
    backbone gives a narrower head input); ``weights.build_net`` reads
    them from the loaded params."""

    def __init__(self, opt_net, head_channels: Optional[Sequence[int]] = None):
        super().__init__()
        opt = CN(opt_net)
        if opt.projection not in ("orthogonal", "perspective"):
            raise ValueError(opt.projection)
        self.opt_net = opt
        self.num_views = int(opt.get("num_views", 1))
        if self.num_views < 1:
            raise ValueError(f"num_views {self.num_views}")
        self.image_filter = BACKBONES[opt.backbone.IMF](opt.backbone)
        views = {"num_views": self.num_views} if self.num_views > 1 else {}
        self.surface_classifier = HEADS[opt.head.IMF](
            opt.head, filter_channels=head_channels, **views)
        self.normalizer = NORMALIZERS[opt.normalizer.IMF](opt.normalizer)
        self.projection = PROJECTIONS[opt.projection]

    # -- feature extraction ------------------------------------------------
    def filter(self, images: torch.Tensor,
               feat_prior: Optional[torch.Tensor] = None) -> FeatStages:
        feats_stages = self.image_filter(images)
        if feat_prior is not None:  # netC: concat the geometry prior
            h, w = feats_stages[0][0].shape[1:3]
            feat_prior = interpolate_2d(feat_prior, (h, w), "nearest")
            feats_stages = [[torch.cat([feat_prior, f], dim=-1) for f in fs]
                            for fs in feats_stages]
        return feats_stages

    # -- per-point query ---------------------------------------------------
    def query(self, feats_stages: FeatStages, points: torch.Tensor,
              calibs: Optional[torch.Tensor] = None,
              transforms: Optional[torch.Tensor] = None,
              train: bool = False, head_fn=None) -> list[torch.Tensor]:
        """Query at [B, N, 3] world points -> a [B, N, Res] prediction a
        stage: every stage with ``train``, else the last one."""
        if not train:
            feats_stages = feats_stages[-1:]
        if self.num_views > 1:
            return self._query_views(feats_stages, points, calibs,
                                     transforms, head_fn)
        xyz = points if calibs is None else self.projection(
            points, calibs, transforms)
        xy, z = xyz[..., :2], xyz[..., 2:3]
        in_img = _in_image(xy[..., 0], xy[..., 1])
        z_feat = self.normalizer(z)
        preds = []
        for feats in feats_stages:
            x = torch.cat([index(f, xy) for f in feats]
                          + [z_feat.to(feats[0].dtype)], dim=-1)
            pred = (head_fn(x) if head_fn is not None
                    else self.surface_classifier(x))
            preds.append(in_img[..., None].to(pred.dtype) * pred)
        return preds

    def sample_views(self, feats: Sequence[torch.Tensor],
                     points: torch.Tensor, calibs: torch.Tensor,
                     transforms: Optional[torch.Tensor] = None):
        """The multi-view head input of [B, N, 3] points over one stage's
        maps of the B * V views (calibs [B * V, 4, 4]) -> (x [B, N, V,
        C_in] point-major: a point's V rows together, each a view's
        sampled features and z feature; view 0's in-image mask [B, N])."""
        v = self.num_views
        b, n, _ = points.shape
        pts = points[:, None].expand(b, v, n, 3).reshape(b * v, n, 3)
        xyz = self.projection(pts, calibs, transforms)
        xy = xyz[..., :2]
        z_feat = self.normalizer(xyz[..., 2:3])            # [B * V, N, Z]
        z_feat = z_feat.reshape(b, v, n, -1).permute(0, 2, 1, 3)
        x = torch.cat([index(f, xy).reshape(b, v, n, -1).transpose(1, 2)
                       for f in feats] + [z_feat.to(feats[0].dtype)], dim=-1)
        xy0 = xy.reshape(b, v, n, 2)[:, 0]
        return x, _in_image(xy0[..., 0], xy0[..., 1])

    def _query_views(self, feats_stages: FeatStages, points, calibs,
                     transforms, head_fn) -> list[torch.Tensor]:
        """``query`` of a multi-view net: ``head_fn`` takes the point-major
        [B, N, V, C_in] rows (``ops/cuda/fused_mlp.apply_mlp_views``); the
        plain head its [B * V, N, C_in] layout."""
        if calibs is None:
            raise ValueError("a multi-view query needs a calib a view")
        preds = []
        for feats in feats_stages:
            x, in_img = self.sample_views(feats, points, calibs, transforms)
            if head_fn is not None:
                pred = head_fn(x)
            else:
                b, n, v, c = x.shape
                pred = self.surface_classifier(
                    x.permute(0, 2, 1, 3).reshape(b * v, n, c))
            preds.append(in_img[..., None].to(pred.dtype) * pred)
        return preds

    # -- ray-structured query ----------------------------------------------
    def query_taps(self, feats_stages: FeatStages, xy_world: torch.Tensor,
                   z_world: torch.Tensor,
                   calibs: Optional[torch.Tensor] = None,
                   transforms: Optional[torch.Tensor] = None,
                   head_taps_fn=None) -> torch.Tensor:
        """T z-taps per ray: [B,R,2] xy + [B,R,T] z -> [B, R, T, Res].
        Valid only for calibs whose image-plane rows have no z term."""
        self._scalar_z("query_taps")
        feats = feats_stages[-1]
        base = torch.cat([xy_world, z_world[..., :1]], dim=-1)
        xyz = (self.projection(base, calibs, transforms)
               if calibs is not None else base)
        xy = xyz[..., :2]
        in_img = _in_image(xy[..., 0], xy[..., 1])
        zz = (calibs[:, 2, 2] if calibs is not None
              else torch.ones(xy.shape[0], dtype=xy.dtype, device=xy.device))
        zc = xyz[..., 2:] + zz[:, None, None] * (z_world - z_world[..., :1])
        z_feat = self.normalizer(zc)                           # [B, R, T]
        feat = torch.cat([index(f, xy) for f in feats], dim=-1)
        pred = self._head_taps(feat, z_feat.to(feat.dtype), head_taps_fn)
        return in_img[..., None, None].to(pred.dtype) * pred

    # -- anchored ray query (rotated-view fast path) -----------------------
    def query_taps_anchored(self, feats_stages: FeatStages,
                            xy_world: torch.Tensor, z_world: torch.Tensor,
                            calibs: Optional[torch.Tensor] = None,
                            transforms: Optional[torch.Tensor] = None,
                            anchors: int = 2,
                            head_anchor_fn=None) -> torch.Tensor:
        """T z-taps per ray under any affine calib or a perspective net:
        [B,R,2] xy + [B,R,T] z -> [B, R, T, Res].

        A ray's projected path is a straight uv chord under both
        projections. Every tap is projected exactly; features are gathered
        at ``anchors`` evenly spaced points of the chord, and each tap's
        feature is the piecewise-linear mix of its two bracketing anchors
        (hat weights over alpha, the tap's exact position on the chord).
        (u, v, zc) and the in-image mask per tap are exact; the feature is
        approximate where the bilinear sample is not linear across a lerp
        segment. ``head_anchor_fn(feat_k, w_taps, z_feat)`` takes the K
        anchor features, the hat weights and the z features
        (``ops/cuda/fused_ray_mlp.apply_anchor``); without it the taps are
        mixed here and go through the plain head."""
        self._scalar_z("query_taps_anchored")
        feats = feats_stages[-1]
        b, r, t = z_world.shape
        k = anchors
        base_t = torch.cat([xy_world[:, :, None].expand(b, r, t, 2),
                            z_world[..., None]], dim=-1)     # [B, R, T, 3]
        if calibs is not None:
            xyz_t = self.projection(base_t.reshape(b, r * t, 3), calibs,
                                    transforms).reshape(b, r, t, 3)
        else:
            xyz_t = base_t
        uv_t = xyz_t[..., :2]                                # exact per tap
        uv0 = uv_t[..., :1, :]
        duv = uv_t[..., -1:, :] - uv0                        # [B, R, 1, 2]
        denom = (duv * duv).sum(-1)                          # [B, R, 1]
        alpha = torch.where(
            denom > 1e-12,
            ((uv_t - uv0) * duv).sum(-1) / torch.clamp(denom, min=1e-12),
            torch.zeros_like(denom))                         # [B, R, T]
        ak = device_constant(_anchor_positions, (k,), uv_t.device,
                             torch.float32)
        uv_k = uv0 + ak[:, None] * duv                       # [B, R, K, 2]
        feat_k = torch.cat(
            [index(f, uv_k.reshape(b, r * k, 2)) for f in feats],
            dim=-1).reshape(b, r, k, -1)
        # hat weights: tap t mixes its two bracketing anchors
        pos = alpha[..., None] * (k - 1) - device_constant(
            _arange, (k,), uv_t.device, torch.float32)
        w_taps = torch.clamp(1.0 - torch.abs(pos), min=0.0)  # [B, R, T, K]
        in_img = _in_image(uv_t[..., 0], uv_t[..., 1])       # [B, R, T]
        z_feat = self.normalizer(xyz_t[..., 2]).to(feat_k.dtype)
        if head_anchor_fn is not None:
            pred = head_anchor_fn(feat_k, w_taps, z_feat)
        else:
            feat_t = torch.matmul(w_taps.to(feat_k.dtype), feat_k)
            x = torch.cat([feat_t, z_feat[..., None]], dim=-1)
            pred = self.surface_classifier(
                x.reshape(b, r * t, -1)).reshape(b, r, t, -1)
        return in_img[..., None].to(pred.dtype) * pred

    # -- grid-structured query (frontal fast path) -------------------------
    def query_taps_grid(self, feats_stages: FeatStages,
                        x_world: torch.Tensor, y_world: torch.Tensor,
                        z_world: torch.Tensor,
                        calibs: Optional[torch.Tensor] = None,
                        head_taps_fn=None) -> torch.Tensor:
        """Outer-product ray lattice x_world [B,Nu] x y_world [B,Nv] with
        z_world [B,Nu,Nv,T] -> [B, Nu, Nv, T, Res]. Valid only when the
        calib's image rows are diagonal and z-free (engine._calib_grid_ok)."""
        self._scalar_z("query_taps_grid")
        feats = feats_stages[-1]
        if calibs is not None:
            c = calibs
            u = c[:, 0, 0, None] * x_world + c[:, 0, 3, None]
            v = c[:, 1, 1, None] * y_world + c[:, 1, 3, None]
            zc = (c[:, 2, 0, None, None, None] * x_world[:, :, None, None]
                  + c[:, 2, 1, None, None, None] * y_world[:, None, :, None]
                  + c[:, 2, 2, None, None, None] * z_world
                  + c[:, 2, 3, None, None, None])
        else:
            u, v, zc = x_world, y_world, z_world
        in_img = _in_image(u[:, :, None], v[:, None, :])
        z_feat = self.normalizer(zc)                           # [B,Nu,Nv,T]
        feat = torch.cat([index_grid(f, u, v) for f in feats], dim=-1)
        b, nu, nv, c_f = feat.shape
        t = z_feat.shape[-1]
        feat = feat.reshape(b, nu * nv, c_f)
        zf = z_feat.reshape(b, nu * nv, t).to(feat.dtype)
        pred = self._head_taps(feat, zf, head_taps_fn)
        pred = pred.reshape(b, nu, nv, t, -1)
        return in_img[..., None, None].to(pred.dtype) * pred

    def _scalar_z(self, method: str) -> None:
        if self.normalizer.soft_onehot:
            raise ValueError(f"{method} requires the scalar z normalizer")

    def _head_taps(self, feat, z_feat, head_taps_fn):
        if head_taps_fn is not None:
            return head_taps_fn(feat, z_feat)
        # through the plain head: expand taps into the point axis
        b, r, t = z_feat.shape
        x = torch.cat([feat[:, :, None].expand(b, r, t, feat.shape[-1]),
                       z_feat[..., None]], dim=-1)
        return self.surface_classifier(x.reshape(b, r * t, -1)).reshape(
            b, r, t, -1)

    # -- loss --------------------------------------------------------------
    def get_loss(self, pred_stages: Sequence[torch.Tensor],
                 labels: torch.Tensor) -> torch.Tensor:
        """The loss of ``opt_net.loss`` (MSE or L1), averaged over stages."""
        imf = self.opt_net.loss.IMF
        if imf == "MSE":
            fn = lambda p: torch.mean((p - labels) ** 2)
        elif imf == "L1":
            fn = lambda p: torch.mean(torch.abs(p - labels))
        else:
            raise NotImplementedError(imf)
        return sum(fn(p) for p in pred_stages) / len(pred_stages)

    def forward(self, images: torch.Tensor, points: torch.Tensor,
                calibs: torch.Tensor,
                transforms: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None,
                feat_prior: Optional[torch.Tensor] = None,
                train: bool = False):
        """-> the last stage's prediction, and with ``labels`` also the
        loss over the queried stages: ``(pred, loss)``."""
        feats_stages = self.filter(images, feat_prior)
        pred_stages = self.query(feats_stages, points, calibs, transforms,
                                 train=train)
        if labels is not None:
            return pred_stages[-1], self.get_loss(pred_stages, labels)
        return pred_stages[-1]


def backbone_channels(opt_backbone) -> int:
    """The feature width a stage of the backbone gives the head (its
    levels' channels summed), from a dry run at 64^2 on the CPU."""
    with torch.no_grad():
        feats = BACKBONES[opt_backbone.IMF](opt_backbone)(
            torch.zeros(1, 64, 64, 3))
    return sum(f.shape[-1] for f in feats[-1])


def head_channels_for(opt_net, prior_channels: int = 0) -> tuple[int, ...]:
    """Head widths for a net trained from scratch: the published hidden
    and output widths of ``opt_net.head`` after an input of the
    backbone's features, a prior of ``prior_channels`` (netC: netG's
    feature width) and the z feature. The JAX package's flax head infers
    its input width; a torch ``Linear`` needs it up front."""
    opt = CN(opt_net)
    z = opt.normalizer.soft_dim if opt.normalizer.get("soft_onehot") else 1
    spec = HEAD_SPECS[opt.head.IMF][0]
    return (backbone_channels(opt.backbone) + prior_channels + z,
            *spec[1:])


def eval_net(net: MonoPortNet) -> MonoPortNet:
    """Inference-mode counterpart of a net built with norm 'batch_train'
    (``monoport_tpu.models.monoport_net.eval_net``): the same module in
    eval mode, so its BatchNorms read their running stats. torch keeps the
    variables in the module, so this switches ``net`` itself; ``.train()``
    switches it back."""
    return net.eval()


def _pifu_opt(projection: str, backbone: str, head: str, loss: str) -> CN:
    opt = CN()
    opt.projection = projection
    opt.backbone = CN({"IMF": backbone})
    opt.normalizer = CN({"IMF": "PIFuNomalizer", "soft_onehot": False,
                         "soft_dim": 64})
    opt.head = CN({"IMF": head})
    opt.loss = CN({"IMF": loss})
    return opt


def PIFuNetG() -> MonoPortNet:
    """The geometry net: HGFilter, occupancy head, MSE."""
    return MonoPortNet(_pifu_opt(
        "orthogonal", "PIFuHGFilters", "PIFuNetGMLP", "MSE"))


def PIFuNetC() -> MonoPortNet:
    """The colour net: ResnetFilter, colour head, L1."""
    return MonoPortNet(_pifu_opt(
        "orthogonal", "PIFuResBlkFilters", "PIFuNetCMLP", "L1"))

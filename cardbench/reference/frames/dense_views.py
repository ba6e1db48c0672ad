"""The reference frame of PIFu's multi-view netG on the dense path
(``mode='dense'``, ``configs/quality.yaml``'s hierarchy and depth peel), in
plain PyTorch, float32 (TF32 off).

The net (Saito et al., "PIFu", ICCV 2019, section 3.3; MonoPort's
``heads/SurfaceClassifier.py`` with ``num_views``): a frame takes the V
images of one subject, [V, H, W, 3], and one calib a view, [V, 4, 4].
netG's backbone runs on all V images. Each queried world point X is
projected through every view's calib, which gives that view's pixel x_v,
its sampled feature F_v(x_v) and its depth z_v; the head input of view v is
``f_v = [F_v(x_v), z_v * Z_SCALE]``. The head is the PIFu MLP (leaky ReLU
0.01 between layers, the input concatenated onto every layer after the
first) with the views mean-pooled after layer ``P = n_layers // 2``:

    y_v = phi_P(... phi_1(cat(phi_0(f_v), f_v)) ...)   (each with its leaky ReLU)
    ybar = mean_v y_v,   fbar = mean_v f_v
    s = sigmoid(phi_L-1(cat(... phi_P+1(cat(ybar, fbar)) ..., fbar)))

and the prediction is masked by X being inside view 0's image. The volume,
its hierarchy, the depth peel (along the volume's z axis, which is view
0's when its calib is the identity) and the shading are ``dense.py``'s,
which this file takes by name (``frame_path('dense')``).

Departures from PIFu, none of them in what a frame computes: the backbone
runs the V images one at a time (at batch 4, f32 with TF32 off, cuDNN's
heuristics take an FFT algorithm ~50x slower on an H100); the views'
points are projected and sampled as V separate rows and pooled inside the
head, as PIFu's ``reshape_sample_tensor`` does; the head runs on blocks of
``HEAD_ROWS / V`` points. The in-image mask of view 0 is PIFu's own at
batch 1 (its ``query`` multiplies the pooled prediction by every view's
mask and its reconstruction reads the first). The departures of the
dense path from the port's are ``dense.py``'s.

``queries`` lists the head queries of a frame as (net, 'views', points,
views): each level's points, each of ``views`` head rows up to the pool
and one after it (``harness/work.py`` has no such kind; the cell's own
roofline reader counts them).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from cardbench.reference import nets
from cardbench.reference.frame import frame_path

_dense = frame_path("dense")
depth_peel = _dense.depth_peel


def pooled_head(head: nets.SurfaceClassifier, x: torch.Tensor) -> torch.Tensor:
    """The multi-view head over x [N, V, C_in] (a point's V views
    together) -> [N, C_out]: the views mean-pooled after layer
    ``n_layers // 2`` and its activation, and the input with them."""
    y = skip = x
    pool = head.n_layers // 2
    for i in range(head.n_layers):
        if i:
            y = torch.cat([y, skip], dim=-1)
        y = getattr(head, f"filters_{i}")(y)
        if i != head.n_layers - 1:
            y = F.leaky_relu(y, 0.01)
        if i == pool:
            y, skip = y.mean(dim=-2), x.mean(dim=-2)
    return torch.sigmoid(y) if head.last_op == "sigmoid" else torch.tanh(y)


def sample_views(net: nets.ImplicitNet, feats, points: torch.Tensor,
                 calibs: torch.Tensor):
    """The head input of world points [N, 3] in the V views (maps [V, h,
    w, C], calibs [V, 4, 4]) -> (x [N, V, C_in], view 0's in-image mask
    [N])."""
    v = calibs.shape[0]
    xyz = nets.orthogonal(points[None].expand(v, *points.shape), calibs)
    xy = xyz[..., :2]
    x = torch.cat([nets.index(f, xy) for f in feats]
                  + [xyz[..., 2:3] * nets.Z_SCALE], dim=-1)   # [V, N, C]
    return x.transpose(0, 1), nets.in_image(xy[0, :, 0], xy[0, :, 1])


def queries(config: dict, calib: np.ndarray, rows) -> list:
    """(net, kind, points, views) of each head query of a frame whose
    hierarchy levels query ``rows`` points: netG's view-pooled query a
    level (no netC on this path)."""
    views = config["netG"]["head"]["num_views"]
    return [("netG", "views", int(n), views) for n in rows]


class ViewByView:
    """A reference net whose ``filter`` runs the views one at a time and
    concatenates their maps (the same convolutions a view)."""

    def __init__(self, net: nets.ImplicitNet):
        self.net = net
        self.surface_classifier = net.surface_classifier

    def filter(self, images: torch.Tensor):
        maps = [self.net.filter(images[v:v + 1])
                for v in range(images.shape[0])]
        return [torch.cat(m) for m in zip(*maps)]


class Frame(_dense.Frame):
    def __init__(self, config: dict, nets_: dict):
        if "netC" in nets_:
            raise ValueError("the multi-view frame has no colour net")
        super().__init__(config, nets_)
        self.netG = ViewByView(self.netG)
        self.views = config["netG"]["head"]["num_views"]

    def _query(self, net, feats, calib_t, pts: torch.Tensor) -> torch.Tensor:
        """Multi-view query of world points [N, 3] -> [N, 1], HEAD_ROWS /
        V points a call."""
        block = max(1, nets.HEAD_ROWS // self.views)
        parts = []
        for i in range(0, pts.shape[0], block):
            x, in_img = sample_views(net, feats, pts[i:i + block], calib_t)
            pred = pooled_head(net.surface_classifier, x)
            parts.append(in_img[:, None].to(pred.dtype) * pred)
        if not parts:
            return pts.new_zeros(0, 1)
        return torch.cat(parts)

    def _calib(self, calib, device):
        calib = np.asarray(calib, np.float32)
        if calib.shape != (self.views, 4, 4):
            raise ValueError(f"{self.views} views need a calib a view, "
                             f"[{self.views}, 4, 4]; got {calib.shape}")
        return torch.as_tensor(calib, device=device)

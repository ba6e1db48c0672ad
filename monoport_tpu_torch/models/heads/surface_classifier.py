"""Point-wise occupancy / color MLP (port of
``monoport_tpu/models/heads/surface_classifier.py``).

Linear layers over point-major [B, N, C], leaky-ReLU 0.01 between layers,
and the PIFu skip-concat of the input feature into every layer after the
first. Layer widths are explicit: ``weights.build_net`` reads them from
the loaded params (a small test backbone gives a narrower head input
than the published spec).

``out_init_scale`` is the variance-scaling multiplier of the output
layer's initial kernel (``parallel.train_step.init_params``; 1.0 is
flax's lecun_normal). netC's head takes 1e-4: its ResnetFilter features
are not normalised, and a default-initialised tanh starts saturated with
zero gradients. Loaded weights are untouched by it.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

LAST_OPS = {"sigmoid": torch.sigmoid, "tanh": torch.tanh, None: None}


class SurfaceClassifier(nn.Module):
    def __init__(self, filter_channels: Sequence[int],
                 last_op: str | None = None, out_init_scale: float = 1.0):
        super().__init__()
        chans = list(filter_channels)
        self.filter_channels = tuple(chans)
        self.last_op = last_op
        self.out_init_scale = out_init_scale
        for i in range(len(chans) - 1):
            in_dim = chans[i] + (chans[0] if i > 0 else 0)
            self.add_module(f"filters_{i}", nn.Linear(in_dim, chans[i + 1]))
        self.n_layers = len(chans) - 1

    def layers(self) -> list[nn.Linear]:
        return [getattr(self, f"filters_{i}") for i in range(self.n_layers)]

    def forward(self, feature: torch.Tensor) -> torch.Tensor:
        """[B, N, C_in] -> [B, N, C_out]."""
        y = feature
        for i, lin in enumerate(self.layers()):
            if i > 0:
                y = torch.cat([y, feature], dim=-1)
            y = lin(y)
            if i != self.n_layers - 1:
                y = F.leaky_relu(y, negative_slope=0.01)
        fn = LAST_OPS[self.last_op]
        return fn(y) if fn is not None else y


def PIFuNetGMLP(opt=None, filter_channels=None) -> SurfaceClassifier:
    """Occupancy head: [257,1024,512,256,128,1] + sigmoid."""
    return SurfaceClassifier(filter_channels or HEAD_SPECS["PIFuNetGMLP"][0],
                             last_op="sigmoid")


def PIFuNetCMLP(opt=None, filter_channels=None) -> SurfaceClassifier:
    """Color head: [513,1024,512,256,128,3] + tanh; its output layer
    initialised at 1e-4 of the default variance."""
    return SurfaceClassifier(filter_channels or HEAD_SPECS["PIFuNetCMLP"][0],
                             last_op="tanh", out_init_scale=1e-4)


# (filter_channels, last_op) per head
HEAD_SPECS = {
    "PIFuNetGMLP": ((257, 1024, 512, 256, 128, 1), "sigmoid"),
    "PIFuNetCMLP": ((513, 1024, 512, 256, 128, 3), "tanh"),
}

HEADS = {"PIFuNetGMLP": PIFuNetGMLP, "PIFuNetCMLP": PIFuNetCMLP}

"""Backbone registry (IMF dispatch). The HRNet and Yolov4 backbones of the
JAX package are not ported yet (ROADMAP queue 1 item 12)."""

from .hourglass import ConvBlock, HGFilter, HourGlass, PIFuHGFilters
from .resnet import PIFuResBlkFilters, ResnetBlock, ResnetFilter

BACKBONES = {
    "PIFuHGFilters": PIFuHGFilters,
    "PIFuResBlkFilters": PIFuResBlkFilters,
}

__all__ = ["HGFilter", "PIFuHGFilters", "ConvBlock", "HourGlass",
           "ResnetFilter", "PIFuResBlkFilters", "ResnetBlock", "BACKBONES"]

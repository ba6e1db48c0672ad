"""Backbone registry (the reference's IMF dispatch, backbones/__init__.py)."""

from .hourglass import ConvBlock, HGFilter, HourGlass, PIFuHGFilters
from .hrnet import (HRNet, HRNetV2_W18_small_v2,
                    HRNetV2_W18_small_v2_balance,
                    HRNetV2_W18_small_v2_balance_gn32,
                    HRNetV2_W18_small_v2_balance_last,
                    HRNetV2_W18_small_v2_balance_v2,
                    HRNetV2_W18_small_v2_deeper)
from .resnet import PIFuResBlkFilters, ResnetBlock, ResnetFilter
from .yolov4 import Yolov4, Yolov4Filters

BACKBONES = {
    "PIFuHGFilters": PIFuHGFilters,
    "PIFuResBlkFilters": PIFuResBlkFilters,
    "Yolov4Filters": Yolov4Filters,
    "HRNetV2_W18_small_v2": HRNetV2_W18_small_v2,
    "HRNetV2_W18_small_v2_balance": HRNetV2_W18_small_v2_balance,
    "HRNetV2_W18_small_v2_balance_gn32": HRNetV2_W18_small_v2_balance_gn32,
    "HRNetV2_W18_small_v2_balance_last": HRNetV2_W18_small_v2_balance_last,
    "HRNetV2_W18_small_v2_balance_v2": HRNetV2_W18_small_v2_balance_v2,
    "HRNetV2_W18_small_v2_deeper": HRNetV2_W18_small_v2_deeper,
}

__all__ = ["HGFilter", "PIFuHGFilters", "ConvBlock", "HourGlass",
           "ResnetFilter", "PIFuResBlkFilters", "ResnetBlock",
           "HRNet", "Yolov4", "Yolov4Filters", "BACKBONES"]

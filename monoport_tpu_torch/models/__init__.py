from .backbones import BACKBONES
from .heads import HEAD_SPECS, HEADS
from .monoport_net import MonoPortNet

__all__ = ["MonoPortNet", "BACKBONES", "HEADS", "HEAD_SPECS"]

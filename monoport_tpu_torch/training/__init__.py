from .logger import colorlogger
from .trainer import Trainer

__all__ = ["colorlogger", "Trainer"]

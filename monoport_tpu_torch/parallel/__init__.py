from .train_step import (TrainState, create_train_state, make_optimizer,
                         make_scan_train_step, make_train_step)

__all__ = ["TrainState", "create_train_state", "make_optimizer",
           "make_train_step", "make_scan_train_step"]

from .mesh import Mesh, batch_sharding, make_mesh, replicated
from .train_step import (TrainState, create_train_state, make_optimizer,
                         make_scan_train_step, make_train_step)

__all__ = ["Mesh", "make_mesh", "batch_sharding", "replicated",
           "TrainState", "create_train_state", "make_optimizer",
           "make_train_step", "make_scan_train_step"]

from .compaction import dilate_mask, rank_writeback, select_k
from .projection import PROJECTIONS, orthogonal, perspective
from .resize import (avg_pool_2d, interpolate_2d, interpolate_3d, resize_axis,
                     upsample2x_bicubic)
from .sampling import bilinear_rows, grid_sample_2d, index, index_grid

__all__ = ["PROJECTIONS", "orthogonal", "perspective", "avg_pool_2d",
           "interpolate_2d", "interpolate_3d", "resize_axis",
           "upsample2x_bicubic", "bilinear_rows", "grid_sample_2d", "index",
           "index_grid", "dilate_mask", "rank_writeback", "select_k"]

from .calib import pifu_calib
from .depth_peel import SurfaceMaps, shade_normal, visualize
from .hierarchy import HierarchicalRecon
from .ray_refine import ray_march, ray_pyramid, refine_from_maps

__all__ = ["SurfaceMaps", "shade_normal", "visualize", "HierarchicalRecon",
           "pifu_calib", "ray_march", "ray_pyramid", "refine_from_maps"]

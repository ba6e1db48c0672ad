from .depth_peel import SurfaceMaps, shade_normal, visualize
from .hierarchy import HierarchicalRecon
from .ray_refine import ray_march, ray_pyramid, refine_from_maps

__all__ = ["SurfaceMaps", "shade_normal", "visualize", "HierarchicalRecon",
           "ray_march", "ray_pyramid", "refine_from_maps"]

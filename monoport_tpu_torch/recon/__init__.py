# ``depth_peel`` and ``ray_refine`` are not re-exported: the names stay the
# submodules' (``from .recon import ray_refine`` gives the module).
from .calib import pifu_calib
from .dense import dense_eval, grid_points, index_to_world
from .depth_peel import SurfaceMaps, shade_normal, visualize
from .hierarchy import HierarchicalRecon
from .marching import extract_mesh, marching_tets
from .ray_refine import ray_march, ray_pyramid, refine_from_maps

__all__ = ["SurfaceMaps", "shade_normal", "visualize", "HierarchicalRecon",
           "pifu_calib", "ray_march", "ray_pyramid", "refine_from_maps",
           "dense_eval", "grid_points", "index_to_world", "extract_mesh",
           "marching_tets"]

from .mesh import (compute_normal, load_obj_mesh, load_obj_mesh_with_color,
                   save_obj_mesh, save_obj_mesh_with_color)

__all__ = ["compute_normal", "load_obj_mesh", "load_obj_mesh_with_color",
           "save_obj_mesh", "save_obj_mesh_with_color"]

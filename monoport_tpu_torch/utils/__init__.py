from .mesh import save_obj_mesh, save_obj_mesh_with_color

__all__ = ["save_obj_mesh", "save_obj_mesh_with_color"]

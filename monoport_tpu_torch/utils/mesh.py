"""OBJ export of an extracted mesh (the port's copy of the writers of
``monoport_tpu/utils/mesh.py``; host-side numpy)."""

from __future__ import annotations

import numpy as np


def _write_faces(f, faces: np.ndarray) -> None:
    for face in np.asarray(faces) + 1:           # OBJ indices are 1-based
        f.write(f"f {face[0]} {face[1]} {face[2]}\n")


def save_obj_mesh(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        _write_faces(f, faces)


def save_obj_mesh_with_color(path: str, verts: np.ndarray,
                             faces: np.ndarray, colors: np.ndarray) -> None:
    """Per-vertex coloured OBJ: ``v x y z r g b``."""
    with open(path, "w") as f:
        for v, c in zip(verts, colors):
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f} "
                    f"{c[0]:.6f} {c[1]:.6f} {c[2]:.6f}\n")
        _write_faces(f, faces)

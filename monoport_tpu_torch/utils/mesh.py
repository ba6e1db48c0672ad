"""OBJ reading and writing (the port's copy of ``monoport_tpu/utils/mesh.py``;
host-side numpy): the readers, with quads and 1-based or negative indices,
area-weighted vertex normals, and the writers of an extracted mesh."""

from __future__ import annotations

import numpy as np


def _triangulate(idx: list[int]) -> list[tuple[int, int, int]]:
    """Fan-triangulate a polygon index list (a quad gives two triangles)."""
    out = [(idx[0], idx[1], idx[2])]
    if len(idx) == 4:
        out.append((idx[0], idx[2], idx[3]))
    return out


def _fix(idx_arr: np.ndarray, count: int) -> np.ndarray:
    """OBJ indices (1-based, or negative from the end) -> 0-based."""
    return np.where(idx_arr > 0, idx_arr - 1, idx_arr + count)


def load_obj_mesh(path: str, with_normal: bool = False,
                  with_texture: bool = False):
    """Parse an OBJ file -> (verts [V,3], faces [F,3], ...extras): with
    ``with_texture`` the uvs and the faces' uv indices, with
    ``with_normal`` the normals and the faces' normal indices (the vertex
    normals and ``faces`` when the file has none)."""
    verts, norms, uvs = [], [], []
    faces, face_norms, face_uvs = [], [], []
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif tag == "vn":
                norms.append([float(x) for x in parts[1:4]])
            elif tag == "vt":
                uvs.append([float(x) for x in parts[1:3]])
            elif tag == "f":
                comps = [p.split("/") for p in parts[1:]]
                faces.extend(_triangulate([int(c[0]) for c in comps]))
                if with_texture and all(len(c) > 1 and c[1] for c in comps):
                    face_uvs.extend(_triangulate([int(c[1]) for c in comps]))
                if with_normal and all(len(c) > 2 and c[2] for c in comps):
                    face_norms.extend(
                        _triangulate([int(c[2]) for c in comps]))

    v = np.asarray(verts, np.float32)
    f_arr = _fix(np.asarray(faces, np.int64), len(verts))
    out = [v, f_arr]
    if with_texture:
        out += [np.asarray(uvs, np.float32),
                _fix(np.asarray(face_uvs, np.int64), len(uvs))]
    if with_normal:
        if norms:
            out += [np.asarray(norms, np.float32),
                    _fix(np.asarray(face_norms, np.int64), len(norms))]
        else:
            out += [compute_normal(v, f_arr), f_arr]
    return tuple(out)


def load_obj_mesh_with_color(path: str):
    """OBJ with per-vertex colour, ``v x y z r g b`` (white where a vertex
    has none) -> (verts, colors, faces)."""
    verts, colors, faces = [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
                colors.append([float(x) for x in parts[4:7]]
                              if len(parts) >= 7 else [1.0, 1.0, 1.0])
            elif parts[0] == "f":
                faces.extend(_triangulate(
                    [int(p.split("/")[0]) for p in parts[1:]]))
    v = np.asarray(verts, np.float32)
    f_arr = _fix(np.asarray(faces, np.int64), len(verts))
    return v, np.asarray(colors, np.float32), f_arr


def compute_normal(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted per-vertex unit normals."""
    norm = np.zeros_like(vertices)
    tris = vertices[faces]
    n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    for i in range(3):
        np.add.at(norm, faces[:, i], n)
    length = np.linalg.norm(norm, axis=1, keepdims=True)
    return norm / np.maximum(length, 1e-12)


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

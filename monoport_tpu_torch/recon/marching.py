"""Iso-surface mesh extraction: marching tetrahedra with static shapes
(port of ``monoport_tpu/recon/marching.py``).

Six tetrahedra a cell share the 0-7 diagonal; a tet has 16 cases of at most
2 triangles, which vectorises into gathers over a fixed budget of active
cells:

  1. active cells = cells whose 8 corners straddle the level, the first
     ``max_cells`` of them (``ops/compaction.select_k``, padded);
  2. for each cell x 6 tets a 4-bit inside mask indexes a [16, 2, 3] edge
     table; vertices are linear interpolations on tet edges;
  3. the output is a padded triangle soup [K*12, 3, 3] with a validity
     mask; welding to an indexed mesh happens on the host for OBJ export.

Volume convention: vol[i=z, j=y, k=x] (``recon/dense.py``); emitted vertex
coords are world-space (x, y, z) in [b_min, b_max].
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.compaction import select_k
from ..ops.constants import device_constant
from .dense import _bounds

# cube corners: bit 0 -> +x, bit 1 -> +y, bit 2 -> +z
_CORNER_OFFSETS = np.array(
    [[(c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)],
    np.int64)

# six tetrahedra sharing the 0-7 diagonal (the same in every cell, so
# shared faces tile consistently)
_TETS = np.array([
    [0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7],
    [0, 6, 4, 7], [0, 4, 5, 7], [0, 5, 1, 7]], np.int64)

# tet edges: (corner_a, corner_b) index pairs, local 0..3
_TET_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], np.int64)
_AB, _AC, _AD, _BC, _BD, _CD = range(6)
_X = -1  # no edge

# case -> up to 2 triangles of tet-edge indices (bit i set = corner i
# inside): one corner in or out gives the triangle on its three edges, two
# in give a quad over the four in-out edges, split in cyclic order
_TET_TRI_TABLE = np.array([
    [[_X] * 3, [_X] * 3],                          # 0000
    [[_AB, _AC, _AD], [_X] * 3],                   # a
    [[_AB, _BD, _BC], [_X] * 3],                   # b
    [[_AC, _AD, _BD], [_AC, _BD, _BC]],            # a b
    [[_AC, _BC, _CD], [_X] * 3],                   # c
    [[_AB, _AD, _CD], [_AB, _CD, _BC]],            # a c
    [[_AB, _BD, _CD], [_AB, _CD, _AC]],            # b c
    [[_AD, _BD, _CD], [_X] * 3],                   # a b c
    [[_AD, _CD, _BD], [_X] * 3],                   # d
    [[_AB, _AC, _CD], [_AB, _CD, _BD]],            # a d
    [[_AB, _BC, _CD], [_AB, _CD, _AD]],            # b d
    [[_AC, _CD, _BC], [_X] * 3],                   # a b d  (c outside)
    [[_AC, _BC, _BD], [_AC, _BD, _AD]],            # c d
    [[_AB, _BC, _BD], [_X] * 3],                   # a c d  (b outside)
    [[_AB, _AD, _AC], [_X] * 3],                   # b c d  (a outside)
    [[_X] * 3, [_X] * 3],                          # 1111
], np.int64)


_TABLES = {"tets": _TETS, "edges": _TET_EDGES, "tris": _TET_TRI_TABLE}


def _table(name: str) -> np.ndarray:
    return _TABLES[name]


def marching_tets(vol: torch.Tensor, level: float = 0.5,
                  max_cells: int = 131072,
                  b_min=(-1.0, -1.0, -1.0), b_max=(1.0, 1.0, 1.0)):
    """-> (tris [max_cells*12, 3, 3] world coords, valid [max_cells*12]).

    Padded triangle soup of the ``level`` iso-surface of vol [R, R, R]
    (volume order [z, y, x]). Cells beyond ``max_cells`` are dropped in
    scan order."""
    r = vol.shape[0]
    rc = r - 1
    dev = vol.device
    inside = vol > level

    # active cells: any corner differs from corner 0
    base = inside[:-1, :-1, :-1]
    straddle = torch.zeros_like(base)
    for dx, dy, dz in _CORNER_OFFSETS[1:].tolist():
        straddle = straddle | (
            inside[dz:rc + dz, dy:rc + dy, dx:rc + dx] != base)
    n_cells = rc ** 3
    idx = select_k(straddle, max_cells)[0]
    cell_valid = idx < n_cells
    safe = torch.where(cell_valid, idx, torch.zeros_like(idx))
    iz = safe // (rc * rc)
    jy = (safe // rc) % rc
    kx = safe % rc

    # the 8 corner values and world positions of each cell
    lo, hi = _bounds(b_min, b_max, dev)
    scale = (hi - lo) / (r - 1)
    corner_vals, corner_pos = [], []
    for dx, dy, dz in _CORNER_OFFSETS.tolist():
        corner_vals.append(vol[iz + dz, jy + dy, kx + dx])
        pos = torch.stack([kx + dx, jy + dy, iz + dz], dim=-1).float()
        corner_pos.append(pos * scale + lo)
    vals = torch.stack(corner_vals, dim=1)             # [K, 8]
    pos = torch.stack(corner_pos, dim=1)               # [K, 8, 3]

    tets = device_constant(_table, ("tets",), dev, torch.int64)
    tet_vals = vals[:, tets]                           # [K, 6, 4]
    tet_pos = pos[:, tets]                             # [K, 6, 4, 3]
    bits = (tet_vals > level).long()
    case = (bits[..., 0] + 2 * bits[..., 1] + 4 * bits[..., 2]
            + 8 * bits[..., 3])                        # [K, 6]

    # the interpolation points of all 6 tet edges
    edges = device_constant(_table, ("edges",), dev, torch.int64)
    ea, eb = edges[:, 0], edges[:, 1]
    va = tet_vals[..., ea]                             # [K, 6 tets, 6 edges]
    denom = tet_vals[..., eb] - va
    t = (level - va) / torch.where(torch.abs(denom) > 1e-12, denom,
                                   torch.ones_like(denom))
    t = torch.clamp(t, 0.0, 1.0)
    pa = tet_pos[:, :, ea]                             # [K, 6, 6, 3]
    edge_pts = pa + t[..., None] * (tet_pos[:, :, eb] - pa)

    tri_edges = device_constant(_table, ("tris",), dev, torch.int64)[case]
    tri_valid = tri_edges[..., 0] >= 0                 # [K, 6, 2]
    safe_edges = torch.clamp(tri_edges, min=0)         # [K, 6, 2, 3]
    # the edge point of each triangle corner: [K, 6, 6, 3] read at
    # [K, 6, 2 * 3] edge indices
    k = safe_edges.shape[0]
    tris = torch.gather(
        edge_pts, 2,
        safe_edges.reshape(k, 6, 6, 1).expand(k, 6, 6, 3))
    tris = tris.reshape(-1, 3, 3)
    valid = (tri_valid & cell_valid[:, None, None]).reshape(-1)
    return tris, valid


def extract_mesh(vol: torch.Tensor, level: float = 0.5,
                 max_cells: int = 131072,
                 b_min=(-1.0, -1.0, -1.0), b_max=(1.0, 1.0, 1.0),
                 weld_decimals: int = 5):
    """Indexed mesh on the host: -> (verts [V, 3] f32, faces [F, 3] i64),
    numpy. Fetches the triangle soup, so it synchronises."""
    tris, valid = marching_tets(vol, level, max_cells, b_min, b_max)
    tris = tris.detach().cpu().numpy()[valid.cpu().numpy()]
    if len(tris) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    key = np.round(tris.reshape(-1, 3), weld_decimals)
    uniq, inverse = np.unique(key, axis=0, return_inverse=True)
    faces = inverse.reshape(-1, 3)
    # drop degenerate faces produced by clipped interpolations
    ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
          & (faces[:, 0] != faces[:, 2]))
    return uniq.astype(np.float32), faces[ok].astype(np.int64)

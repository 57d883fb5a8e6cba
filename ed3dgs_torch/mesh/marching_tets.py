"""Marching tetrahedra (host-side numpy; the port's own copy of
ed3dgs_tpu/mesh/marching_tets.py).

Replacement for the reference's kaolin-derived utils/tetmesh.py:47-190:
given tet vertices, connectivity and an SDF, emit the crossing-edge vertex
set (as endpoint pairs, ready for the binary-search refinement of
mesh_extract_tetrahedra.py:117-129) and the triangle faces indexing it.
"""

from __future__ import annotations

import numpy as np

# tet edges by local vertex pair, edge index 0..5
TET_EDGES = np.array([(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)])

# triangles per occupancy case (bit i set = vertex i "inside"), as edge
# indices. For two-inside cases the four crossing edges form a quad whose
# cyclic order comes from walking the tet faces (each face holds exactly two
# crossing edges); complements reverse the winding so orientations stay
# consistent across cases (validated on an analytic sphere in tests).
_TRI_TABLE = {
    0b0001: [(0, 1, 2)],                    # S={0}: edges e01,e02,e03
    0b1110: [(0, 2, 1)],
    0b0010: [(0, 4, 3)],                    # S={1}: edges e01,e12,e13
    0b1101: [(0, 3, 4)],
    0b0100: [(1, 3, 5)],                    # S={2}: edges e02,e12,e23
    0b1011: [(1, 5, 3)],
    0b1000: [(2, 5, 4)],                    # S={3}: edges e03,e13,e23
    0b0111: [(2, 4, 5)],
    0b0011: [(1, 4, 3), (1, 2, 4)],         # S={0,1}: cycle e02-e12-e13-e03
    0b1100: [(1, 3, 4), (1, 4, 2)],
    0b0101: [(0, 3, 5), (0, 5, 2)],         # S={0,2}: cycle e01-e12-e23-e03
    0b1010: [(0, 5, 3), (0, 2, 5)],
    0b1001: [(0, 1, 5), (0, 5, 4)],         # S={0,3}: cycle e01-e02-e23-e13
    0b0110: [(0, 5, 1), (0, 4, 5)],
}
_MAX_TRIS = 2


def marching_tetrahedra(verts: np.ndarray, tets: np.ndarray, sdf: np.ndarray):
    """Extract the iso-surface edge/face structure at sdf == 0.

    Args:
      verts: [V, 3] float tet vertices.
      tets: [T, 4] int connectivity.
      sdf: [V] float signed distance (inside > 0).

    Returns:
      edge_verts: [E, 2] int — endpoint vertex ids per crossing edge (the
        surface vertex lies between them).
      faces: [F, 3] int — triangles as indices into edge_verts.
    """
    occ = sdf > 0
    tets = np.asarray(tets)
    # canonicalize tet orientation (positive signed volume) so the per-case
    # triangle windings are globally consistent regardless of how the
    # Delaunay backend ordered the vertices
    v = verts[tets]
    vol = np.einsum("ti,ti->t", np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]),
                    v[:, 3] - v[:, 0])
    flip = vol < 0
    tets = tets.copy()
    tets[flip, 2], tets[flip, 3] = tets[flip, 3], tets[flip, 2]
    code = (occ[tets] << np.arange(4)).sum(axis=1)
    active = (code != 0) & (code != 0b1111)
    tets_a = tets[active]
    code_a = code[active]
    if len(tets_a) == 0:
        return np.zeros((0, 2), np.int64), np.zeros((0, 3), np.int64)

    # global edge keys of every (tet, edge)
    ev = tets_a[:, TET_EDGES]                      # [Ta, 6, 2]
    lo = ev.min(axis=2).astype(np.int64)
    hi = ev.max(axis=2).astype(np.int64)
    keys = lo * len(verts) + hi                    # [Ta, 6]

    # faces per case
    tri_edge_idx = np.full((16, _MAX_TRIS * 3), -1, np.int64)
    for c, tris in _TRI_TABLE.items():
        flat = [e for tri in tris for e in tri]
        tri_edge_idx[c, : len(flat)] = flat
    face_edges = tri_edge_idx[code_a]              # [Ta, 6]
    valid = face_edges >= 0
    face_keys = np.where(valid, np.take_along_axis(
        keys, np.maximum(face_edges, 0), axis=1), -1)

    used_keys = face_keys[valid]
    uniq, inv = np.unique(used_keys, return_inverse=True)
    face_idx = np.full(face_keys.shape, -1, np.int64)
    face_idx[valid] = inv
    faces = face_idx.reshape(-1, _MAX_TRIS, 3)
    faces = faces[(faces >= 0).all(axis=2)]

    edge_verts = np.stack([uniq // len(verts), uniq % len(verts)], axis=1)
    return edge_verts, faces

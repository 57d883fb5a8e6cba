"""Sparse block-hashed TSDF fusion (port of ed3dgs_tpu/mesh/tsdf_sparse.py;
the reference's Open3D VoxelBlockGrid, mesh_extract_tsdf_fusion.py:31-106).

B^3 voxel blocks are allocated only in the truncation band around observed
surface points, so memory scales with surface area instead of bounding-box
volume. The block keys and payloads are tensors on the caller's device:

- Blocks live on a global integer grid anchored at the world origin: voxel
  `(i, j, k)` sits at `ijk * voxel_size` and belongs to block `ijk // B`.
- `activate` unprojects a depth map's valid pixels and allocates the
  27-neighbourhood (a wider one for `trunc` past a block edge) of each
  touched block. A frame's fresh blocks are appended in ascending key
  order, which is the lexicographic order of their coordinates, as the
  numpy original's `np.unique(axis=0)` gives them: that order sets the
  voxel rows, so also the mesh's vertex and face order.
- `integrate` applies the dense path's projective update
  (`tsdf.project_voxels`) to every allocated voxel.
- `extract_surface` finds each cell's corners by a `searchsorted` over the
  sorted voxel keys (a hash join) on the device, drops cells with an
  unallocated or unobserved corner, keeps the tetrahedra that straddle
  the surface (the only ones that give faces; their order kept), and
  marches those on the host.
  Vertices on block faces resolve to the same global voxel row, so the mesh
  is welded across blocks by construction.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .marching_tets import marching_tetrahedra
from .tsdf import (_CUBE_TETS, _as_device, _device_of, interpolate_surface, project_voxels,
                   unproject_depth)

# global voxel-coordinate encoding: 21 bits per axis, offset to allow
# negative indices. 2^20 voxels * 0.002 m ~ 2 km of scene per side.
_M = 1 << 21
_OFF = 1 << 20


def encode(ijk: torch.Tensor) -> torch.Tensor:
    """[N, 3] integer voxel (or block) coords -> unique int64 keys, ordered
    as the coordinates are lexicographically. Raises ValueError, naming the
    coordinate, for any |i|, |j| or |k| >= 2^20: past that the 21-bit
    fields would run into each other and two voxels share a key."""
    ijk = ijk.to(torch.int64)
    out = (ijk.abs() >= _OFF).any(1)
    if bool(out.any()):
        raise ValueError(f"voxel coordinate {tuple(ijk[out][0].tolist())} is outside the "
                         f"sparse TSDF's key range: each of |i|, |j|, |k| must be < 2^20")
    return ((ijk[:, 0] + _OFF) * _M + (ijk[:, 1] + _OFF)) * _M + (ijk[:, 2] + _OFF)


def decode(keys: torch.Tensor) -> torch.Tensor:
    """The inverse of `encode`: int64 keys -> [N, 3] coords."""
    k = keys % _M - _OFF
    rest = keys // _M
    return torch.stack([rest // _M - _OFF, rest % _M - _OFF, k], 1)


def _cube(n: int, device, lo: int = 0) -> torch.Tensor:
    """[n^3, 3] int64 offsets lo..lo+n-1 per axis, i-major."""
    r = torch.arange(lo, lo + n, device=device)
    return torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)


class SparseTsdfVolume:
    """Hash-allocated B^3 voxel blocks with TSDF/weight/colour payloads."""

    def __init__(self, voxel_size: float, block: int = 8, device="cpu"):
        self.voxel_size = float(voxel_size)
        self.block = int(block)
        self.device = torch.device(device)
        n = self.block ** 3
        f32 = dict(dtype=torch.float32, device=self.device)
        self.block_keys = torch.zeros(0, dtype=torch.int64, device=self.device)  # row order
        self.tsdf = torch.zeros((0, n), **f32)
        self.weight = torch.zeros((0, n), **f32)
        self.color = torch.zeros((0, n, 3), **f32)
        self._offsets = _cube(self.block, self.device)       # voxel offsets in a block

    @property
    def n_blocks(self) -> int:
        return len(self.block_keys)

    @property
    def block_coords(self) -> torch.Tensor:
        return decode(self.block_keys)

    def activate(self, points: torch.Tensor, trunc: float) -> None:
        """Allocate blocks covering the truncation band around world points
        [N, 3] float64."""
        if len(points) == 0:
            return
        bedge = self.block * self.voxel_size
        rad = max(1, int(np.ceil(trunc / bedge)))
        touched = decode(torch.unique(encode(torch.floor(points / bedge))))
        dil = _cube(2 * rad + 1, self.device, lo=-rad)
        keys = torch.unique(encode((touched[:, None, :] + dil[None]).reshape(-1, 3)))
        fresh = keys[~torch.isin(keys, self.block_keys)]
        if len(fresh) == 0:
            return
        self.block_keys = torch.cat([self.block_keys, fresh])
        z = torch.zeros((len(fresh), self.block ** 3), dtype=torch.float32, device=self.device)
        self.tsdf = torch.cat([self.tsdf, z])
        self.weight = torch.cat([self.weight, z])
        self.color = torch.cat([self.color, torch.zeros(z.shape + (3,), dtype=z.dtype,
                                                        device=self.device)])

    def voxel_coords(self) -> torch.Tensor:
        """Global integer coords of every allocated voxel, [nb*B^3, 3]."""
        return (self.block_coords[:, None, :] * self.block
                + self._offsets[None, :, :]).reshape(-1, 3)

    def integrate(self, depth, color, world_view: np.ndarray, focal_x: float,
                  focal_y: float, depth_max: float = 8.0, trunc_mult: float = 8.0) -> None:
        """Fuse one (masked) z-depth map + colour image, dense-parity math."""
        depth, color = _as_device(depth, self.device), _as_device(color, self.device)
        trunc = trunc_mult * self.voxel_size
        # allocate the band around this frame's unprojected surface points
        self.activate(unproject_depth(depth, world_view, focal_x, focal_y, depth_max), trunc)
        if self.n_blocks == 0:
            return
        pts = self.voxel_coords().double() * self.voxel_size
        ok, sdf, yi_c, xi_c = project_voxels(pts, depth, world_view, focal_x, focal_y,
                                             depth_max, trunc)
        tsdf_new = torch.clamp(sdf / trunc, -1.0, 1.0).float()

        shape = self.tsdf.shape
        tsdf = self.tsdf.reshape(-1)
        wgt = self.weight.reshape(-1)
        col = self.color.reshape(-1, 3)
        wn = ok.to(torch.float32)
        tot = wgt + wn
        tot_safe = torch.clamp_min(tot, 1e-8)
        self.tsdf = torch.where(wn > 0, (tsdf * wgt + tsdf_new * wn) / tot_safe,
                                tsdf).reshape(shape)
        self.weight = tot.reshape(shape)
        if color is not None:
            c_new = color[yi_c, xi_c].float()
            col_out = (col * wgt[:, None] + c_new * wn[:, None]) / tot_safe[:, None]
            self.color = torch.where(wn[:, None] > 0, col_out, col).reshape(shape + (3,))

    def extract_surface(self, min_weight: float = 1.0):
        """Zero-crossing surface -> (vertices, faces, colours), welded."""
        if self.n_blocks == 0:
            e = np.zeros((0, 3), np.float32)
            return e, np.zeros((0, 3), np.int64), e
        vox = self.voxel_coords()                      # [Nv, 3]
        keys = encode(vox)
        order = torch.argsort(keys)
        keys_sorted = keys[order]

        def lookup(q_keys):
            """hash join: global key -> voxel row (-1 if absent)."""
            pos = torch.searchsorted(keys_sorted, q_keys).clamp_max(len(keys_sorted) - 1)
            return torch.where(keys_sorted[pos] == q_keys, order[pos], -1)

        # cells: one per allocated voxel; corners may live in neighbour blocks
        corners = torch.stack([lookup(encode(vox + off)) for off in _cube(2, self.device)], 1)
        sdf = self.tsdf.reshape(-1).double()
        seen = self.weight.reshape(-1) >= min_weight
        # dense-parity rule: cells touching unobserved/unallocated space are
        # dropped, and unobserved voxels read as "far outside"
        sdf = torch.where(seen, sdf, -1.0)
        cell_ok = (corners >= 0).all(1) & seen[corners.clamp_min(0)].all(1)
        # only tets whose corners straddle the surface give faces, so keep
        # those (in order) before the host marches: a cell whose corners
        # all lie on one side holds none
        occ = sdf > 0
        cells = corners[cell_ok]
        cell_occ = occ[cells]
        cells = cells[cell_occ.any(1) & ~cell_occ.all(1)]
        tets = cells[:, torch.as_tensor(_CUBE_TETS, device=self.device)].reshape(-1, 4)
        tet_occ = occ[tets]
        tets = tets[tet_occ.any(1) & ~tet_occ.all(1)]
        verts = (vox.double() * self.voxel_size).cpu().numpy()
        sdf = sdf.cpu().numpy()
        edge_verts, faces = marching_tetrahedra(verts, tets.cpu().numpy(), sdf)
        return interpolate_surface(verts, sdf, self.color.reshape(-1, 3).cpu().numpy(),
                                   edge_verts, faces)


def fuse_volume_sparse(depths: List, colors: List[Optional[object]],
                       world_views: List[np.ndarray], focals, *, voxel_size: float,
                       depth_max: float = 8.0, block: int = 8) -> SparseTsdfVolume:
    """Every view fused into a fresh volume on the first depth map's device
    (numpy depths: the CPU)."""
    vol = SparseTsdfVolume(voxel_size, block=block, device=_device_of(depths[0]))
    for depth, color, wv, (fx, fy) in zip(depths, colors, world_views, focals):
        vol.integrate(depth, color, np.asarray(wv), fx, fy, depth_max=depth_max)
    return vol


def fuse_depths_sparse(depths, colors, world_views, focals, *, voxel_size: float,
                       depth_max: float = 8.0, block: int = 8, min_weight: float = 1.0):
    """Sparse counterpart of `tsdf.fuse_depths`: `fuse_volume_sparse`, then
    its surface -> (vertices, faces, colours)."""
    return fuse_volume_sparse(depths, colors, world_views, focals, voxel_size=voxel_size,
                              depth_max=depth_max, block=block).extract_surface(min_weight=min_weight)

"""Per-timestep mesh/pointcloud sequences -> videos (port of
ed3dgs_tpu/tools/mesh_video.py; the reference's offline NerSemble export
nersemble_scripts/per_timestamp_mesh_2_video.py:1-66).

A z-buffer point splatter stands in for pyvista's off-screen renders:
pointcloud plys render their stored RGB colours; triangle meshes are
densified with per-face surface samples and Lambert-shaded with the face
normal (headlight). The splatter runs on the device; the plys are read and
densified on the host.

Usage:  python -m ed3dgs_torch.tools.mesh_video <input_folder> [--device cpu]
where <input_folder> holds timestep_* directories as tools/mesh_extract.py /
tools/evaluate_mesh.py write them. The frames are PNGs from the port's
codec; the video goes through tools/render.export_video, which writes none
(and says so) where neither imageio nor Pillow is installed.
"""

from __future__ import annotations

import argparse
import os
import re
import tempfile

import numpy as np
import torch

from ..data.cameras import look_at_camera
from ..data.ply import read_mesh_ply, read_ply
from ..device import resolve_device
from ..mesh.mesh_eval import face_normals
from .render import export_video, save_img

# the reference's three fixed (eye, focal_point, up) views
# (per_timestamp_mesh_2_video.py:18-28) -- scene-calibration constants for
# the NerSemble head scenes; "mouth" zooms 2x
VIEWS = {
    "central": (np.array([0.20431704, 0.06167632, 0.67057732]),
                np.array([0.17365520, 0.09827889, 0.08799868]),
                np.array([-0.01393465, 0.99788905, 0.06342932]), 1.0),
    "side": (np.array([-0.44461417, 0.02220413, 0.19259187]),
             np.array([0.06150647, 0.11428958, -0.08496881]),
             np.array([-0.11043348, 0.98590030, 0.12571811]), 1.0),
    "mouth": (np.array([-0.03543708, -0.03187355, 0.62626738]),
              np.array([0.11900690, 0.05757573, 0.06964933]),
              np.array([-0.05132445, 0.98816429, 0.14455843]), 2.0),
}

PLY_FILES = (
    "recon.ply",
    "pointcloud_distance_2_mesh_colored.ply",
    "pointcloud_similarity_2_normal_colored.ply",
)


def natural_sort_key(s):
    return [int(t) if t.isdigit() else t.lower() for t in re.split(r"(\d+)", s)]


def _load_colored_points(path):
    """Any ply -> (points [N,3], colors-or-normals [N,3], is_normals).

    Meshes are densified (vertices + 4 surface samples per face) and
    return per-point NORMALS (is_normals=True) for view-dependent Lambert
    shading; pointclouds return their stored RGB (is_normals=False).
    """
    data = read_ply(path)
    v = data["vertex"]
    has_faces = "face" in data and len(data["face"]) > 0
    names = v.dtype.names
    pts = np.stack([v["x"], v["y"], v["z"]], 1).astype(np.float32)
    if not has_faces:
        if "red" in names:
            scale = 255.0 if v["red"].dtype == np.uint8 else 1.0
            col = np.stack([v["red"], v["green"], v["blue"]], 1
                           ).astype(np.float32) / scale
        else:
            col = np.full_like(pts, 0.8)
        return pts, col, False
    verts, faces = read_mesh_ply(path)
    fn = face_normals(verts, faces)                       # [F, 3]
    a, b, c = (verts[faces[:, i]] for i in range(3))
    # 4 fixed barycentric samples per face + the vertices
    bary = np.array([[1, 1, 1], [4, 1, 1], [1, 4, 1], [1, 1, 4]], np.float32)
    bary /= bary.sum(1, keepdims=True)
    samples = (bary[:, None, 0:1] * a + bary[:, None, 1:2] * b
               + bary[:, None, 2:3] * c).reshape(-1, 3)
    s_norm = np.tile(fn, (4, 1))
    all_pts = np.concatenate([verts, samples], 0)
    vn = np.zeros_like(verts)
    np.add.at(vn, faces.reshape(-1), np.repeat(fn, 3, axis=0))
    vn /= np.maximum(np.linalg.norm(vn, axis=1, keepdims=True), 1e-9)
    all_n = np.concatenate([vn, s_norm], 0)
    return all_pts, all_n, True  # normals; shading happens view-dependently


def _rows(p: torch.Tensor, m: torch.Tensor, r: int) -> torch.Tensor:
    """sum_j p[:, j] * m[r, j], each product and sum its own rounding."""
    return p[:, 0] * m[r, 0] + p[:, 1] * m[r, 1] + p[:, 2] * m[r, 2]


def render_points(pts, colors_or_normals, eye, target, up, zoom, width=550,
                  height=802, shaded=False, point_size=2, device="cuda"):
    """Z-buffer point splat on `device`: project, order far-to-near, write
    near last; returns the image [3, H, W] float32 on the host.

    pyvista's default view_angle=30 deg is the FULL VERTICAL angle; zoom
    scales the half-angle tangent, and the horizontal fov follows in tan
    space from the aspect ratio (per_timestamp_mesh_2_video.py). Each of
    the point_size^2 offset passes overwrites the image where it lands, in
    the numpy original's order; within a pass the nearest point of a pixel
    wins (the largest far-to-near rank, by a `scatter_reduce` amax, so the
    winner is the same on every device). Points at equal depths keep their
    input order (a stable sort; `np.argsort` leaves it unspecified).
    """
    dev = resolve_device(device)
    fovy = 2 * np.arctan(np.tan(np.radians(30.0) / 2.0) / zoom)
    fovx = 2 * np.arctan(np.tan(fovy / 2.0) * width / height)
    cam = look_at_camera(eye, target, up, fovx, fovy, width, height).matrices()
    pts = torch.as_tensor(pts, device=dev)
    R = torch.as_tensor(np.asarray(cam.world_view, np.float32), device=dev).to(
        torch.promote_types(pts.dtype, torch.float32))   # translation in column 3
    x, y, z = (_rows(pts, R, r) + R[r, 3] for r in range(3))
    keep = z > 1e-4
    x = x / z * cam.focal_x + width / 2.0
    y = y / z * cam.focal_y + height / 2.0
    cn = torch.as_tensor(colors_or_normals, device=dev)
    if shaded:
        n_z = _rows(cn, R.to(cn.dtype).T, 2)              # (n @ R[:3, :3])[:, 2]
        ndotl = torch.clamp(-n_z, 0, 1)
        shade = torch.clamp(0.15 + 0.75 * ndotl + 0.2 * ndotl ** 16, 0, 1)
        col = torch.stack([shade] * 3, 1)
    else:
        col = cn
    keep &= (x >= 0) & (x < width) & (y >= 0) & (y < height)
    x, y, z, col = x[keep], y[keep], z[keep], col[keep]
    order = torch.argsort(-z, stable=True)                # far first
    xi, yi = x[order].to(torch.int32), y[order].to(torch.int32)
    c = col[order].to(torch.float32)
    rank = torch.arange(len(order), device=dev)
    img = torch.zeros((height * width, 3), dtype=torch.float32, device=dev)
    r = point_size // 2
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            pix = (torch.clamp(yi + dy, 0, height - 1) * width
                   + torch.clamp(xi + dx, 0, width - 1)).long()
            win = torch.full((height * width,), -1, dtype=torch.int64, device=dev)
            win.scatter_reduce_(0, pix, rank, "amax")
            hit = win >= 0
            img[hit] = c[win[hit]]
    return img.reshape(height, width, 3).permute(2, 0, 1).cpu().numpy()


def main(argv=None):
    """Render every view of every ply kind present; returns the videos'
    paths (as export_video would name them) and writes each frame's PNG."""
    p = argparse.ArgumentParser(
        description="Generate videos from per-timestep mesh/pointcloud plys")
    p.add_argument("input_folder")
    p.add_argument("--width", type=int, default=550)
    p.add_argument("--height", type=int, default=802)
    p.add_argument("--fps", type=int, default=30)
    p.add_argument("--device", default="cuda",
                   help="torch device to splat on (default: the GPU)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    tdirs = sorted([d for d in os.listdir(args.input_folder)
                    if d.startswith("timestep_")], key=natural_sort_key)
    made = []
    for view_name, (eye, target, up, zoom) in VIEWS.items():
        for ply_file in PLY_FILES:
            with tempfile.TemporaryDirectory() as fdir:
                n = 0
                for d in tdirs:
                    path = os.path.join(args.input_folder, d, ply_file)
                    if not os.path.exists(path):
                        continue
                    pts, cn, is_normals = _load_colored_points(path)
                    img = render_points(pts, cn, eye, target, up, zoom,
                                        args.width, args.height,
                                        shaded=is_normals, device=device)
                    save_img(os.path.join(fdir, f"{n:05d}.png"), img)
                    n += 1
                if n == 0:
                    continue
                out = os.path.join(
                    args.input_folder,
                    f"{view_name}_{ply_file.replace('.ply', '')}_video.mp4")
                export_video(fdir, out, fps=args.fps)
                made.append(out)
                print(f"Video saved to {out}")
    return made


if __name__ == "__main__":
    main()

"""Synthetic on-disk dataset generator (test/demo harness; port of
ed3dgs_tpu/data/synthetic.py: `generate_scene` and `generate_hyper_scene`).

Writes a complete COLMAP-layout dynamic scene — cameras.bin/images.bin, per-
camera per-frame PNGs of a known moving Gaussian cloud, and
points3D_downsample.ply — so the training CLI runs hermetically. The JAX
package renders the frames with its per-pixel oracle (ops/rasterize_ref.py);
the port renders the same cloud through its own `project_gaussians` and
`rasterize` (colours precomputed, kernel size 0, SH 0): the forward blend
kernel K1 on the card, its plain version on the CPU. The PNGs are written by
the port's own codec (data/image_io.py).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..device import resolve_device
from . import colmap, image_io
from .cameras import look_at_camera
from .ply import store_point_cloud


def _gt_cloud(n, rng, tongue_frac=0.0):
    """Moving GT cloud; the last `tongue_frac` of points form a compact
    pure-red blob (the synthetic "tongue": red seed colors are what
    create_from_points keys the tongue class on, gaussian_model.py:150-192)."""
    n_t = int(round(n * tongue_frac))
    n_m = n - n_t
    pts = np.stack([
        rng.uniform(-0.6, 0.6, n_m), rng.uniform(-0.6, 0.6, n_m),
        rng.uniform(1.9, 2.5, n_m)], 1).astype(np.float32)
    cols = rng.uniform(0.15, 0.95, (n_m, 3)).astype(np.float32)
    if n_t:
        blob = np.array([0.25, 0.25, 2.1], np.float32) + np.clip(
            rng.normal(0, 0.06, (n_t, 3)), -0.15, 0.15).astype(np.float32)
        red = np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), (n_t, 1))
        pts = np.concatenate([pts, blob])
        cols = np.concatenate([cols, red])
    is_tongue = np.arange(n) >= n_m
    return pts, cols, is_tongue


def _moved(pts, t):
    n = pts.shape[0]
    phase = np.linspace(0, 2 * np.pi, n, dtype=np.float32)
    moved = pts.copy()
    moved[:, 0] += 0.05 * np.sin(2 * np.pi * t + phase)
    moved[:, 1] += 0.03 * np.cos(2 * np.pi * t + phase)
    return moved


def _render_gt(pts, cols, cam_matrices, t, opacity=None, bg=1.0,
               return_alpha=False, device="cpu"):
    """Render of the moving cloud at time t (simple sinusoidal sway) through
    the port's projection and rasterizer. `opacity` (per-point) lets callers
    render subsets (e.g. the tongue-only alpha used for segmentation masks);
    `return_alpha` adds the [H,W] alpha."""
    from ..core.projection import project_gaussians
    from ..ops.rasterize import RasterConfig, rasterize

    n = pts.shape[0]
    moved = _moved(pts, t)
    if opacity is None:
        opacity = np.full((n,), 0.85, np.float32)
    f32 = dict(dtype=torch.float32, device=device)
    m = cam_matrices
    proj = project_gaussians(
        torch.as_tensor(moved, **f32), torch.full((n, 3), 0.04, **f32),
        torch.tensor([[1.0, 0, 0, 0]], **f32).repeat(n, 1),
        torch.as_tensor(np.asarray(opacity, np.float32), **f32), torch.zeros((n, 16, 3), **f32),
        viewmatrix=torch.as_tensor(m.world_view, **f32),
        projmatrix=torch.as_tensor(m.full_proj, **f32),
        campos=torch.as_tensor(m.campos, **f32),
        width=m.width, height=m.height, tan_fovx=m.tan_fovx, tan_fovy=m.tan_fovy,
        focal_x=m.focal_x, focal_y=m.focal_y, kernel_size=0.0, sh_degree=0,
        colors_precomp=torch.as_tensor(cols, **f32))
    # every pair the frame has fits (the oracle the JAX package renders
    # with has no pair limit)
    pairs = int(proj.tiles_touched.sum())
    cfg = RasterConfig(width=m.width, height=m.height, focal_x=m.focal_x, focal_y=m.focal_y,
                       pair_capacity=max(1 << 12, -(-pairs // 4096) * 4096))
    out = rasterize(proj, torch.zeros(n, **f32), torch.full((3,), float(bg), **f32), cfg)
    img = np.clip(out.color.cpu().numpy().transpose(1, 2, 0), 0, 1)
    if return_alpha:
        return img, out.alpha.cpu().numpy()[0]
    return img


def generate_hyper_scene(root: str, *, n_frames: int = 8, width: int = 64,
                         height: int = 64, n_points: int = 120,
                         seed: int = 0, device="cuda") -> str:
    """Synthetic HyperNeRF-layout monocular scene: scene/metadata/dataset
    jsons + per-image Nerfies camera jsons + rgb/2x images + init ply. The
    frames render on `device` (the card unless the caller asks for the
    CPU)."""
    import json

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    pts, cols, _ = _gt_cloud(n_points, rng)
    fov = math.radians(55.0)
    # camera jsons store FULL-resolution intrinsics; images live in rgb/2x
    full_w, full_h = width * 2, height * 2
    focal = full_w / (2 * math.tan(fov / 2))
    fovy = 2 * math.atan(math.tan(fov / 2) * full_h / full_w)

    os.makedirs(os.path.join(root, "camera"), exist_ok=True)
    os.makedirs(os.path.join(root, "rgb", "2x"), exist_ok=True)
    ids, meta = [], {}
    for j in range(n_frames):
        cid = f"{j:06d}"
        ids.append(cid)
        meta[cid] = {"warp_id": j, "appearance_id": j, "camera_id": 0}
        angle = 0.35 * math.sin(2 * math.pi * j / n_frames)
        eye = (1.0 * math.sin(angle), 0.05 * j / n_frames, 2.2 - 1.0 * math.cos(angle))
        cam = look_at_camera(eye, (0, 0, 2.2), (0, -1, 0), fov, fovy,
                             full_w, full_h)
        # Nerfies json: orientation = world->cam rotation, position = cam center
        w2v = cam.matrices().world_view
        orientation = w2v[:3, :3]
        position = np.linalg.inv(w2v)[:3, 3]
        with open(os.path.join(root, "camera", f"{cid}.json"), "w") as f:
            json.dump({
                "orientation": orientation.tolist(),
                "position": position.tolist(),
                "focal_length": focal,
                "principal_point": [full_w / 2, full_h / 2],
                "image_size": [full_w, full_h],
                "skew": 0.0, "pixel_aspect_ratio": 1.0,
                "radial_distortion": [0, 0, 0],
                "tangential_distortion": [0, 0],
            }, f)
        small = look_at_camera(eye, (0, 0, 2.2), (0, -1, 0), fov, fovy,
                               width, height).matrices()
        img = _render_gt(pts, cols, small, j / n_frames, device=device)
        image_io.write_png(os.path.join(root, "rgb", "2x", f"{cid}.png"),
                           (img * 255).astype(np.uint8))

    with open(os.path.join(root, "scene.json"), "w") as f:
        json.dump({"near": 0.1, "far": 10.0, "scale": 1.0,
                   "center": [0, 0, 2.2]}, f)
    with open(os.path.join(root, "metadata.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(root, "dataset.json"), "w") as f:
        json.dump({"ids": ids, "val_ids": [], "train_ids": ids}, f)
    noisy = pts + rng.normal(0, 0.01, pts.shape).astype(np.float32)
    store_point_cloud(os.path.join(root, "points3D_downsample.ply"), noisy, cols)
    return root


def generate_scene(root: str, *, n_cams: int = 4, n_frames: int = 6,
                   width: int = 64, height: int = 64, n_points: int = 150,
                   seed: int = 0, tongue_frac: float = 0.0,
                   cam_start: int = 0, principal_point: float = 0.0,
                   device="cuda") -> str:
    """Create the dataset under `root`; returns the scene path.

    tongue_frac > 0 adds a pure-red tongue blob to the cloud and writes
    per-frame segmentation masks under segmentations/<cam>/ (the reference's
    images->segmentations path swap, scene/cameras.py:126-136) plus red seed
    points in the init ply — the full NerSemble-TONGUE training layout.

    cam_start renames cameras (Technicolor scenes start at cam10, whose
    test split keys on that name); principal_point != 0 writes PINHOLE
    intrinsics with an off-center principal point (cx = (0.5+pp)*W etc.)
    and renders the images through the matching CV projection — exercising
    the technicolor cxr/cyr path (dataset_readers.py:191-234).

    The frames render on `device` (the card unless the caller asks for
    the CPU)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    pts, cols, is_tongue = _gt_cloud(n_points, rng, tongue_frac)

    fov = math.radians(55.0)
    focal = width / (2 * math.tan(fov / 2))
    fovy = 2 * math.atan(math.tan(fov / 2) * height / width)
    cx = (0.5 + principal_point) * width
    cy = (0.5 - principal_point) * height

    sparse = os.path.join(root, "colmap/dense/workspace/sparse")
    os.makedirs(sparse, exist_ok=True)
    cameras, images = {}, {}
    for c in range(n_cams):
        angle = (c - (n_cams - 1) / 2) * 0.25
        eye = (0.9 * math.sin(angle), 0.12 * c - 0.2, 2.2 - 0.9 * math.cos(angle))
        cam = look_at_camera(eye, (0, 0, 2.2), (0, -1, 0), fov, fovy,
                             width, height, cx_ratio=principal_point,
                             cy_ratio=-principal_point)
        name = f"cam{cam_start + c:02d}"
        # COLMAP stores world->cam: R_wc = R.T (our Camera.R is cam->world)
        qvec = colmap.rotmat_to_qvec(cam.R.T)
        cameras[c + 1] = colmap.ColmapCamera(
            c + 1, "PINHOLE", width, height, np.array([focal, focal, cx, cy]))
        images[c + 1] = colmap.ColmapImage(c + 1, qvec, cam.T, c + 1,
                                           f"{name}.png")
        img_dir = os.path.join(root, "images", name)
        os.makedirs(img_dir, exist_ok=True)
        seg_dir = os.path.join(root, "segmentations", name)
        if tongue_frac > 0:
            os.makedirs(seg_dir, exist_ok=True)
        m = cam.matrices()
        for j in range(n_frames):
            img = _render_gt(pts, cols, m, j / n_frames, device=device)
            image_io.write_png(os.path.join(img_dir, "%04d.png" % j),
                               (img * 255).astype(np.uint8))
            if tongue_frac > 0:
                # tongue-only alpha on black = the segmentation mask
                _, a = _render_gt(
                    pts, cols, m, j / n_frames,
                    opacity=np.where(is_tongue, 0.85, 0.0).astype(np.float32),
                    bg=0.0, return_alpha=True, device=device)
                image_io.write_png(os.path.join(seg_dir, "%04d.png" % j),
                                   (np.clip(a, 0, 1) * 255).astype(np.uint8))

    colmap.write_cameras_binary(os.path.join(sparse, "cameras.bin"), cameras)
    colmap.write_images_binary(os.path.join(sparse, "images.bin"), images)
    noisy = pts + rng.normal(0, 0.01, pts.shape).astype(np.float32)
    if tongue_frac > 0:  # red seed colors must stay EXACTLY (1,0,0)
        cols = np.where(is_tongue[:, None], np.array([1.0, 0, 0], np.float32),
                        cols)
    store_point_cloud(os.path.join(root, "points3D_downsample.ply"), noisy, cols)
    return root

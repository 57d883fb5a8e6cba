"""Dataset readers: COLMAP-based multi-view video scenes (DyNeRF/Neural-3D-
Video, NerSemble, Technicolor) and the scene-info contract (port of
ed3dgs_tpu/data/readers.py; images decode through the port's own PNG codec,
data/image_io.py, instead of PIL).

Semantics follow reference scene/dataset_readers.py:95-433: one CameraInfo per
(camera, frame) with timestamp = (frame - start)/duration, cam00 (or cam10 for
Technicolor) as the held-out test camera, nerf++-style normalization radius
from the training camera centers, and the initial point cloud from
points3D_downsample.ply. Images load lazily on the host (with optional alpha
mask from a 4th channel and tongue segmentations from the images->
segmentations path swap, scene/cameras.py:126-136).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np

from ..core.camera_math import focal2fov, world_to_view
from . import colmap, image_io
from .cameras import Camera
from .ply import fetch_point_cloud


@dataclass
class SceneInfo:
    point_cloud: Optional[tuple]      # (points, colors, normals)
    train_cameras: List[Camera]
    test_cameras: List[Camera]
    video_cameras: List[Camera]
    nerf_normalization: dict
    ply_path: str
    maxtime: int = 0


def get_nerfpp_norm(cams: List[Camera]) -> dict:
    """Camera-center bounding radius (reference getNerfppNorm :71-92)."""
    centers = []
    for cam in cams:
        w2c = world_to_view(cam.R, cam.T)
        centers.append(np.linalg.inv(w2c)[:3, 3])
    centers = np.stack(centers, axis=0)
    avg = centers.mean(axis=0)
    diagonal = np.linalg.norm(centers - avg, axis=1).max()
    return {"translate": -avg, "radius": diagonal * 1.1}


def _resolution_for(width, height, resolution_arg):
    """Resolution scaling logic of loadCamv2 (utils/camera_utils.py:68-93)."""
    if resolution_arg in (1, 2, 4, 8):
        return round(width / resolution_arg), round(height / resolution_arg)
    if resolution_arg == -1:
        down = width / 1600 if width > 1600 else 1
    else:
        down = width / resolution_arg
    return int(width / down), int(height / down)


def make_image_loader(white_background: bool = True,
                      load_tongue: bool = False) -> Callable:
    """Host-side lazy loader: image (resized, [3,H,W] float), alpha mask,
    tongue mask (from the segmentations sibling directory). Reads PNGs
    through image_io, as the JAX package's PIL loader reads them."""

    def load(cam: Camera):
        arr = image_io.load_image(cam.image_path, cam.width, cam.height)
        arr = arr.astype(np.float32) / 255.0
        mask = None
        if arr.ndim == 3 and arr.shape[2] == 4:
            mask = arr[..., 3:4].transpose(2, 0, 1)
            arr = arr[..., :3]
        img_chw = arr.transpose(2, 0, 1) if arr.ndim == 3 else arr[None]
        if mask is not None:
            img_chw = img_chw * mask
        tongue = None
        if load_tongue:
            seg_path = cam.image_path.replace("images", "segmentations")
            if os.path.exists(seg_path):
                seg_arr = image_io.load_image(seg_path, cam.width, cam.height)
                seg_arr = seg_arr.astype(np.float32) / 255.0
                if seg_arr.ndim == 3:
                    seg_arr = seg_arr[..., 0]
                tongue = seg_arr[None]
        return img_chw, mask, tongue

    return load


def _cameras_from_colmap(path: str, *, duration: int, start: int = 0,
                         resolution: int = -1, principal_point: bool = False,
                         image_loader=None, extension: str = ".png"):
    """Per-(camera, frame) Camera list (readColmapCamerasDynerf :95-137 /
    Technicolor variant :191-234)."""
    sparse = os.path.join(path, "colmap/dense/workspace/sparse")
    if not os.path.isdir(sparse):
        sparse = os.path.join(path, "sparse")
    cams, images = colmap.read_model(sparse)
    out = []
    for image in sorted(images.values(), key=lambda im: im.name):
        intr = cams[image.camera_id]
        R = colmap.qvec_to_rotmat(image.qvec).T  # cam->world rotation
        T = np.array(image.tvec)
        if intr.model == "SIMPLE_PINHOLE":
            fovx = focal2fov(intr.params[0], intr.width)
            fovy = focal2fov(intr.params[0], intr.height)
            cx_i, cy_i = 1, 2
        elif intr.model == "PINHOLE":
            fovx = focal2fov(intr.params[0], intr.width)
            fovy = focal2fov(intr.params[1], intr.height)
            cx_i, cy_i = 2, 3
        else:
            raise ValueError(f"unsupported COLMAP model {intr.model}")
        cxr = cyr = 0.0
        if principal_point:
            cxr = intr.params[cx_i] / intr.width - 0.5
            cyr = intr.params[cy_i] / intr.height - 0.5
        cam_dir = image.name[:-4] if "." in image.name else image.name
        try:
            cam_no = int(cam_dir.replace("cam", ""))
        except ValueError:
            cam_no = intr.id
        w, h = _resolution_for(intr.width, intr.height, resolution)
        for j in range(start, start + duration):
            image_path = os.path.join(path, "images", cam_dir, "%04d%s" % (j, extension))
            out.append(Camera(
                R=R, T=T, fovx=fovx, fovy=fovy, width=w, height=h,
                time=(j - start) / duration, cam_no=cam_no, frame_no=j - start,
                image_name=os.path.join(cam_dir, os.path.basename(image_path)),
                image_path=image_path, cx_ratio=cxr, cy_ratio=cyr,
                znear=0.01, zfar=100.0, image_loader=image_loader,
            ))
    return out


def _split_train_test(cam_list, test_prefix):
    train = [c for c in cam_list if test_prefix not in c.image_name]
    test = [c for c in cam_list if test_prefix in c.image_name]
    assert test, f"no test cameras matched {test_prefix}"
    assert len({c.cam_no for c in test}) == 1
    return train, test


def read_colmap_scene(path: str, *, duration: int, test_cam: str = "cam00",
                      resolution: int = -1, principal_point: bool = False,
                      image_loader=None, extension: str = ".png",
                      video_trajectory: Optional[str] = None) -> SceneInfo:
    cam_list = _cameras_from_colmap(
        path, duration=duration, resolution=resolution,
        principal_point=principal_point, image_loader=image_loader,
        extension=extension)
    cam_list.sort(key=lambda c: (c.cam_no, c.frame_no))
    train, test = _split_train_test(cam_list, test_cam)
    frame0 = [c for c in cam_list if c.frame_no == 0]
    norm = get_nerfpp_norm([c for c in train if c.frame_no == 0])
    # Novel-view video path: spiral for DyNeRF (reference dataset_readers.py
    # :285), circular head orbit for NerSemble (:341), none for Technicolor.
    video: List[Camera] = []
    if video_trajectory == "spiral":
        from .trajectories import spiral_video_cameras
        video = spiral_video_cameras(frame0, near=0.01, far=100.0, n_views=300)
    elif video_trajectory == "circle":
        from .trajectories import nersemble_video_cameras
        video = nersemble_video_cameras(frame0, duration=duration)
    ply_path = os.path.join(path, "points3D_downsample.ply")
    pcd = fetch_point_cloud(ply_path) if os.path.exists(ply_path) else None
    return SceneInfo(point_cloud=pcd, train_cameras=train, test_cameras=test,
                     video_cameras=video, nerf_normalization=norm,
                     ply_path=ply_path, maxtime=duration)


def read_dynerf_scene(path, duration=300, **kw) -> SceneInfo:
    kw.setdefault("video_trajectory", "spiral")
    return read_colmap_scene(path, duration=duration, test_cam="cam00", **kw)


def read_nersemble_scene(path, duration=110, **kw) -> SceneInfo:
    kw.setdefault("video_trajectory", "circle")
    return read_colmap_scene(path, duration=duration, test_cam="cam00", **kw)


def read_technicolor_scene(path, duration=50, **kw) -> SceneInfo:
    return read_colmap_scene(path, duration=duration, test_cam="cam10",
                             principal_point=True, **kw)


def read_nerfies_scene(path, duration=None, **kw) -> SceneInfo:
    from .hyper import read_hyper_scene
    kw.pop("image_loader", None)  # hyper has its own loader
    return read_hyper_scene(path, duration=duration, **kw)


SCENE_READERS = {
    "dynerf": read_dynerf_scene,
    "nersemble": read_nersemble_scene,
    "technicolor": read_technicolor_scene,
    "colmap": read_dynerf_scene,
    "nerfies": read_nerfies_scene,
    "hypernerf": read_nerfies_scene,
}

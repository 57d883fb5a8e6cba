"""HyperNeRF/Nerfies dataset loader (monocular deformable scenes; port of
ed3dgs_tpu/data/hyper.py, reading images through the port's own PNG codec
and its replays of PIL's Lanczos and bilinear resizes, data/image_io.py).

Reference parity: scene/hyper_loader.py:43-251 + the Nerfies camera JSON
schema (scene/utils.py:98-165). Reads scene.json / metadata.json /
dataset.json plus per-image camera JSONs; vrig scenes use the explicit
train/val id lists, otherwise the every-4th interleaved split. Images come
from rgb/<1/ratio>x/, covisible masks (test split) from covisible/2x/val/.

Distortion: the Nerfies camera model includes radial/tangential distortion
(scene/utils.py:28-96). PROOF THE REFERENCE NEVER APPLIES IT AT RUNTIME: the
only reads of the parsed camera are scene/hyper_loader.py:159-164, :187-193
and :226-231, which touch exactly orientation/position/focal_length/
principal_point; no reference code path calls Camera.pixel_to_local_rays /
pixels_to_rays / project (grep for those names finds only their definitions
in scene/utils.py), and the CUDA rasterizer is pinhole. This loader therefore
also renders pinhole. The distortion component itself (Newton undistort,
distortion-aware projection/rays, image undistortion for dataset prep) lives
in data/nerfies_camera.py.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

from ..core.camera_math import focal2fov
from . import image_io
from .cameras import Camera
from .ply import fetch_point_cloud
from .readers import SceneInfo, get_nerfpp_norm


def _nerfies_camera(path: str):
    with open(path) as f:
        cj = json.load(f)
    return {
        "orientation": np.asarray(cj["orientation"], np.float64),
        "position": np.asarray(cj["position"], np.float64),
        "focal_length": float(cj["focal_length"]),
        "principal_point": np.asarray(cj["principal_point"], np.float64),
        "image_size": np.asarray(cj["image_size"], np.int64),  # (W, H)
        "radial_distortion": np.asarray(cj.get("radial_distortion", [0, 0, 0])),
        "tangential_distortion": np.asarray(cj.get("tangential_distortion", [0, 0])),
    }


def _hyper_image_loader(covisible_path: Optional[str]):
    """Image [3, H, W] float (PIL-Lanczos resized) and, where a covisible
    mask of the same name exists, the mask [1, H, W] (PIL-bilinear
    resized), as the JAX package's Pillow loader gives them."""

    def load(cam: Camera):
        arr = image_io.load_image(cam.image_path, cam.width, cam.height)
        arr = arr.astype(np.float32)[..., :3] / 255.0
        mask = None
        if covisible_path:
            mpath = os.path.join(covisible_path, os.path.basename(cam.image_path))
            if os.path.exists(mpath):
                m = image_io.resize_bilinear(image_io.read_png(mpath), cam.width, cam.height)
                mask = m.astype(np.float32) / 255.0
                if mask.ndim == 3:
                    mask = mask[..., 0]
                mask = mask[None]
        return arr.transpose(2, 0, 1), mask, None

    return load


def read_hyper_scene(path: str, *, ratio: float = 0.5, duration=None,
                     resolution: int = -1, image_loader=None,
                     extension: str = ".png") -> SceneInfo:
    path = os.path.expanduser(path)
    with open(os.path.join(path, "scene.json")) as f:
        scene_json = json.load(f)
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    with open(os.path.join(path, "dataset.json")) as f:
        dataset = json.load(f)

    near, far = scene_json["near"], scene_json["far"]
    all_ids: List[str] = dataset["ids"]
    val_ids = dataset.get("val_ids", [])
    duration = duration or len(all_ids) // 2
    all_ids = all_ids[: duration * 2]

    if len(val_ids) == 0:
        i_train = np.array([i for i in range(len(all_ids)) if i % 4 == 0])
        i_test = (i_train + 2)[:-1]
    else:
        train_ids = dataset["train_ids"]
        i_train = [i for i, x in enumerate(all_ids) if x in train_ids]
        i_test = [i for i, x in enumerate(all_ids) if x in val_ids[:duration]]

    times = [meta[x]["warp_id"] for x in all_ids]

    inv_ratio = int(1 / ratio)
    covis = os.path.join(path, "covisible", "2x", "val")
    covis = covis if os.path.isdir(covis) else None

    def make_cam(i, with_mask):
        cid = all_ids[i]
        camj = _nerfies_camera(os.path.join(path, "camera", f"{cid}.json"))
        W, H = int(camj["image_size"][0]), int(camj["image_size"][1])
        w, h = W // inv_ratio, H // inv_ratio
        R = camj["orientation"].T           # cam->world (reference load_raw)
        T = -camj["position"] @ R
        fovx = focal2fov(camj["focal_length"], W)
        fovy = focal2fov(camj["focal_length"], H)
        cxr = camj["principal_point"][0] / W - 0.5
        cyr = camj["principal_point"][1] / H - 0.5
        return Camera(
            R=R, T=T, fovx=fovx, fovy=fovy, width=w, height=h,
            time=(times[i]) / duration, cam_no=0, frame_no=times[i],
            image_name=f"{cid}.png",
            image_path=os.path.join(path, "rgb", f"{inv_ratio}x", f"{cid}.png"),
            cx_ratio=float(cxr), cy_ratio=float(cyr),
            znear=0.01, zfar=far if far > 0.01 else 100.0,
            image_loader=_hyper_image_loader(covis if with_mask else None))

    train = [make_cam(i, False) for i in i_train]
    test = [make_cam(i, True) for i in i_test]
    norm = get_nerfpp_norm(train)
    # Video split: slerp/lerp-smoothed fly-through over all camera poses,
    # capped at 500 frames (reference scene/hyper_loader.py:124-128).
    from .trajectories import smooth_camera_poses
    all_cams = [make_cam(i, False) for i in range(len(all_ids))]
    video = smooth_camera_poses(all_cams, num_interpolations=10, max_poses=500)
    ply_path = os.path.join(path, "points3D_downsample.ply")
    pcd = fetch_point_cloud(ply_path) if os.path.exists(ply_path) else None
    return SceneInfo(point_cloud=pcd, train_cameras=train, test_cameras=test,
                     video_cameras=video, nerf_normalization=norm,
                     ply_path=ply_path, maxtime=duration)

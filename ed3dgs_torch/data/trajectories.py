"""Novel-view video camera trajectories (the port's own copy of
ed3dgs_tpu/data/trajectories.py, pure numpy).

Reference parity:
- Spiral path for DyNeRF/Neural-3D-Video scenes — exact math of
  reference scene/dataset_readers.py:472-518 (normalize/viewmatrix/
  render_path_spiral/get_spiral, N_views=300, N_rots=3, rads from the 90th
  percentile of camera offsets, zrate=(1-0.75)*(near+far)).
- Circular orbit for NerSemble head captures — reference
  scene/dataset_readers.py:568-657 (buildTrajectory) delegates to
  dreifus.trajectory.circle_around_axis(n, axis=mean z direction,
  up=(0,-1,0), move=camera centroid, look_at=centroid+1.1*mean_z,
  distance=0.5). dreifus is reimplemented here as `circle_around_axis`:
  eye points on a radius-`distance` circle in the plane perpendicular to
  `axis` through `move`, each posed with an OpenCV look-at.
- Slerp-smoothed camera paths for HyperNeRF video renders — reference
  utils/pose_utils.py:33-64 (smooth_camera_poses: quaternion slerp on
  orientation + linear interpolation on position, `num_interpolations`
  in-between poses per input pair).
"""

from __future__ import annotations

import math
from dataclasses import replace
from typing import List, Optional, Sequence

import numpy as np

from ..core.camera_math import world_to_view
from .cameras import Camera


def _normalize(v):
    return v / np.linalg.norm(v)


def viewmatrix(z, up, pos):
    """c2w basis from a forward vector, an up hint and a position
    (reference dataset_readers.py:476-483)."""
    vec2 = _normalize(z)
    vec0 = _normalize(np.cross(up, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    m = np.eye(4)
    m[:3] = np.stack([vec0, vec1, vec2, pos], axis=1)
    return m


def render_path_spiral(c2w, up, rads, zrate, n_rots=2, n=120):
    """Spiral of c2w poses around a base camera (reference :485-496)."""
    poses = []
    for theta in np.linspace(0.0, 2.0 * np.pi * n_rots, n + 1)[:-1]:
        d = c2w[:3, :3] @ (np.array([np.cos(theta), np.sin(theta), 1.0]) * rads)
        c = c2w[:3, 3] + d
        z = _normalize(zrate * c2w[:3, 2] - d)
        poses.append(viewmatrix(z, up, c))
    return poses


def get_spiral(c2ws_all, near, far, rads_scale=0.25, n_views=120):
    """Spiral validation path centered on the first camera (reference
    :498-518). `c2ws_all` is [M,3,4] (or [M,4,4]) cam->world."""
    c2ws_all = np.asarray(c2ws_all)[:, :3, :]
    c2w = c2ws_all[0]
    up = c2ws_all[0, :3, 1]
    dt = 0.75
    zrate = (1.0 - dt) * (near + far)
    tt = c2ws_all[1:, :3, 3] - c2ws_all[0:1, :3, 3]
    rads = np.percentile(np.abs(tt), 90, 0) * rads_scale
    return np.stack(render_path_spiral(c2w, up, rads, zrate, n_rots=3, n=n_views))


def _camera_c2w(cam: Camera) -> np.ndarray:
    return np.linalg.inv(world_to_view(cam.R, cam.T))


def _camera_from_c2w(c2w: np.ndarray, template: Camera, *, time: float,
                     frame_no: int, name: str) -> Camera:
    w2c = np.linalg.inv(c2w)
    return Camera(
        R=w2c[:3, :3].T, T=w2c[:3, 3].copy(),
        fovx=template.fovx, fovy=template.fovy,
        width=template.width, height=template.height,
        time=time, cam_no=0, frame_no=frame_no, image_name=name,
        znear=template.znear, zfar=template.zfar)


def spiral_video_cameras(base_cams: Sequence[Camera], *, near: float = 0.01,
                         far: float = 100.0, n_views: int = 300) -> List[Camera]:
    """Spiral novel-view cameras from one Camera per physical viewpoint
    (frame-0 cameras), matching getSpiralColmap (reference :521-565):
    intrinsics are taken from the camera set, timestamps are i/(n-1)."""
    base_cams = sorted(base_cams, key=lambda c: c.cam_no)
    c2ws = np.stack([_camera_c2w(c) for c in base_cams])
    poses = get_spiral(c2ws, near, far, n_views=n_views)
    tmpl = base_cams[0]
    out = []
    for i, p in enumerate(poses):
        c2w = np.eye(4)
        c2w[:3, :] = p[:3, :]
        out.append(_camera_from_c2w(c2w, tmpl, time=i / (len(poses) - 1),
                                    frame_no=i, name=f"video/{i:04d}.png"))
    return out


def circle_around_axis(n_poses: int, axis, up, move, look_at,
                       distance: float) -> List[np.ndarray]:
    """Camera-to-world poses (OpenCV convention: x right, y down, z forward)
    on a circle of radius `distance` in the plane perpendicular to `axis`
    through `move`, all aimed at `look_at`. Reimplementation of the dreifus
    helper used by reference dataset_readers.py:614-619."""
    axis = _normalize(np.asarray(axis, np.float64))
    up = np.asarray(up, np.float64)
    # in-plane orthonormal basis seeded by the up hint
    b1 = np.cross(up, axis)
    if np.linalg.norm(b1) < 1e-8:  # up parallel to axis: pick any perpendicular
        b1 = np.cross(np.array([1.0, 0.0, 0.0]), axis)
        if np.linalg.norm(b1) < 1e-8:
            b1 = np.cross(np.array([0.0, 1.0, 0.0]), axis)
    b1 = _normalize(b1)
    b2 = np.cross(axis, b1)
    move = np.asarray(move, np.float64)
    look_at = np.asarray(look_at, np.float64)
    poses = []
    for theta in np.linspace(0.0, 2.0 * np.pi, n_poses, endpoint=False):
        eye = move + distance * (math.cos(theta) * b1 + math.sin(theta) * b2)
        z = _normalize(look_at - eye)           # OpenCV forward
        down = -_normalize(up)
        x = _normalize(np.cross(down, z))       # right = down x forward
        y = np.cross(z, x)                      # down
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, eye
        poses.append(c2w)
    return poses


def nersemble_video_cameras(base_cams: Sequence[Camera], *, duration: int,
                            distance: float = 0.5) -> List[Camera]:
    """Circular head-orbit cameras (reference buildTrajectory :568-657):
    orbit axis = mean camera z direction, center = camera-position centroid,
    look-at = centroid + 1.1 * mean z, up = (0,-1,0), one pose per frame."""
    base_cams = sorted(base_cams, key=lambda c: c.cam_no)
    c2ws = np.stack([_camera_c2w(c) for c in base_cams])
    centers = c2ws[:, :3, 3]
    centroid = centers.mean(axis=0)
    mean_z = np.stack([c2w[:3, :3] @ np.array([0.0, 0.0, 1.0]) for c2w in c2ws]).mean(axis=0)
    look_at = centroid + 1.1 * mean_z
    poses = circle_around_axis(int(duration), axis=mean_z, up=(0.0, -1.0, 0.0),
                               move=centroid, look_at=look_at, distance=distance)
    tmpl = base_cams[0]
    n = max(len(poses) - 1, 1)
    return [_camera_from_c2w(p, tmpl, time=i / n, frame_no=i,
                             name=f"video/{i:04d}.png")
            for i, p in enumerate(poses)]


def quaternion_slerp(q1, q2, t):
    """Shortest-arc spherical interpolation (reference utils/pose_utils.py:13-25)."""
    q1 = np.asarray(q1, np.float64)
    q2 = np.asarray(q2, np.float64)
    dot = float(np.dot(q1, q2))
    if dot < 0.0:
        q1, dot = -q1, -dot
    dot = min(max(dot, -1.0), 1.0)
    if dot > 1.0 - 1e-10:
        out = (1 - t) * q1 + t * q2
        return out / np.linalg.norm(out)
    theta = math.acos(dot) * t
    q3 = q2 - q1 * dot
    q3 = q3 / np.linalg.norm(q3)
    return math.cos(theta) * q1 + math.sin(theta) * q3


def _rot_to_quat(m):
    """Rotation matrix -> quaternion (w,x,y,z)."""
    t = np.trace(m)
    if t > 0:
        s = math.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (m[2, 1] - m[1, 2]) / s,
                         (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s])
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = math.sqrt(max(1.0 + m[i, i] - m[j, j] - m[k, k], 0.0)) * 2
    q = np.empty(4)
    q[0] = (m[k, j] - m[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (m[j, i] + m[i, j]) / s
    q[1 + k] = (m[k, i] + m[i, k]) / s
    return q


def _quat_to_rot(q):
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def smooth_camera_poses(cameras: Sequence[Camera], num_interpolations: int = 5,
                        max_poses: Optional[int] = None) -> List[Camera]:
    """Slerp/lerp-smoothed camera path (reference utils/pose_utils.py:33-64,
    used by the HyperNeRF video split, scene/hyper_loader.py:124-128).
    Interpolates cam->world orientation by quaternion slerp and the camera
    center linearly, inserting `num_interpolations` poses per input pair.
    Timestamps are normalized to [0,1] over the output (the reference's
    10x-scaled video_time is an artifact its own video loader mismatches)."""
    out: List[Camera] = []
    for i in range(len(cameras) - 1):
        c1, c2 = cameras[i], cameras[i + 1]
        c2w1, c2w2 = _camera_c2w(c1), _camera_c2w(c2)
        q1, q2 = _rot_to_quat(c2w1[:3, :3]), _rot_to_quat(c2w2[:3, :3])
        for j in range(num_interpolations + 1):
            t = j / (num_interpolations + 1)
            rot = _quat_to_rot(quaternion_slerp(q1, q2, t))
            pos = (1 - t) * c2w1[:3, 3] + t * c2w2[:3, 3]
            c2w = np.eye(4)
            c2w[:3, :3], c2w[:3, 3] = rot, pos
            out.append(_camera_from_c2w(c2w, c1, time=c1.time, frame_no=len(out),
                                        name=f"video/{len(out):04d}.png"))
    if cameras:
        last = cameras[-1]
        out.append(replace(last, image_name=f"video/{len(out):04d}.png",
                           frame_no=len(out), image_loader=None,
                           _image=None, _mask=None, _tongue_mask=None))
    if max_poses is not None:
        out = out[:max_poses]
    n = max(len(out) - 1, 1)
    for i, cam in enumerate(out):
        cam.time = i / n
    return out

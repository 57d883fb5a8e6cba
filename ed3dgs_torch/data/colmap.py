"""COLMAP model readers/writers (binary + text), implemented from the COLMAP
format specification (the port's own copy of ed3dgs_tpu/data/colmap.py,
pure numpy). Covers the subset the pipeline needs (pinhole cameras,
image poses, 3D points) — equivalent of reference scene/colmap_loader.py.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, NamedTuple

import numpy as np

CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
MODEL_IDS = {name: (mid, n) for mid, (name, n) in CAMERA_MODELS.items()}


class ColmapCamera(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class ColmapImage(NamedTuple):
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str


def qvec_to_rotmat(qvec):
    """COLMAP qvec (w,x,y,z) -> rotation matrix (world->cam)."""
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
        [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
    ])


def rotmat_to_qvec(R):
    t = np.trace(R)
    if t > 0:
        w = np.sqrt(1 + t) / 2
        x = (R[2, 1] - R[1, 2]) / (4 * w)
        y = (R[0, 2] - R[2, 0]) / (4 * w)
        z = (R[1, 0] - R[0, 1]) / (4 * w)
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(1 + R[i, i] - R[j, j] - R[k, k], 1e-12)) * 2
        q = np.zeros(4)
        q[1 + i] = s / 4
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
        w, x, y, z = q
    return np.array([w, x, y, z])


# --- binary ---------------------------------------------------------------

def read_cameras_binary(path: str) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            cam_id, model_id, w, h = struct.unpack("<iiQQ", f.read(24))
            name, np_ = CAMERA_MODELS[model_id]
            params = np.array(struct.unpack("<" + "d" * np_, f.read(8 * np_)))
            out[cam_id] = ColmapCamera(cam_id, name, int(w), int(h), params)
    return out


def read_images_binary(path: str) -> Dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            image_id = struct.unpack("<i", f.read(4))[0]
            qvec = np.array(struct.unpack("<dddd", f.read(32)))
            tvec = np.array(struct.unpack("<ddd", f.read(24)))
            camera_id = struct.unpack("<i", f.read(4))[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (npts,) = struct.unpack("<Q", f.read(8))
            f.seek(npts * 24, os.SEEK_CUR)  # skip 2D points (x, y, point3D_id)
            out[image_id] = ColmapImage(image_id, qvec, tvec, camera_id,
                                        name.decode("utf-8"))
    return out


def read_points3d_binary(path: str):
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        xyz = np.zeros((n, 3))
        rgb = np.zeros((n, 3), np.uint8)
        for i in range(n):
            _pid = struct.unpack("<q", f.read(8))[0]
            xyz[i] = struct.unpack("<ddd", f.read(24))
            rgb[i] = struct.unpack("<BBB", f.read(3))
            _err = struct.unpack("<d", f.read(8))[0]
            (tl,) = struct.unpack("<Q", f.read(8))
            f.seek(tl * 8, os.SEEK_CUR)
    return xyz, rgb


def write_cameras_binary(path: str, cameras: Dict[int, ColmapCamera]):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            mid, np_ = MODEL_IDS[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, mid, cam.width, cam.height))
            f.write(struct.pack("<" + "d" * np_, *cam.params))


def write_images_binary(path: str, images: Dict[int, ColmapImage]):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.id))
            f.write(struct.pack("<dddd", *im.qvec))
            f.write(struct.pack("<ddd", *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", 0))


def write_points3d_binary(path: str, xyz: np.ndarray, rgb: np.ndarray):
    """points3D.bin with no track data (ids 1..N, error 0) — the layout
    prepare_single_nersemble_4_radegs.py:389-409 emits for the per-timestep
    COLMAP models."""
    xyz = np.asarray(xyz, np.float64)
    rgb = np.asarray(rgb, np.uint8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        for i in range(len(xyz)):
            f.write(struct.pack("<q", i + 1))
            f.write(struct.pack("<ddd", *xyz[i]))
            f.write(struct.pack("<BBB", *rgb[i]))
            f.write(struct.pack("<d", 0.0))
            f.write(struct.pack("<Q", 0))


# --- text -----------------------------------------------------------------

def read_cameras_text(path: str) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tok = line.split()
            cam_id, model = int(tok[0]), tok[1]
            out[cam_id] = ColmapCamera(cam_id, model, int(tok[2]), int(tok[3]),
                                       np.array([float(x) for x in tok[4:]]))
    return out


def read_images_text(path: str) -> Dict[int, ColmapImage]:
    out = {}
    with open(path) as f:
        lines = [l.strip() for l in f if not l.strip().startswith("#")]
    # Each image record is two lines: the pose line, then its 2D-point line —
    # which is EMPTY for models without observations (e.g. the known-pose
    # "manual" models fed to point_triangulator). So the points line must be
    # consumed positionally, not filtered out as blank.
    expect_points = False
    for line in lines:
        if expect_points:
            expect_points = False
            continue
        if not line:
            continue
        tok = line.split()
        out[int(tok[0])] = ColmapImage(
            int(tok[0]),
            np.array([float(x) for x in tok[1:5]]),
            np.array([float(x) for x in tok[5:8]]),
            int(tok[8]), tok[9])
        expect_points = True
    return out


def read_model(sparse_dir: str):
    """Read cameras + images from a COLMAP sparse dir (binary preferred)."""
    cb = os.path.join(sparse_dir, "cameras.bin")
    if os.path.exists(cb):
        return (read_cameras_binary(cb),
                read_images_binary(os.path.join(sparse_dir, "images.bin")))
    return (read_cameras_text(os.path.join(sparse_dir, "cameras.txt")),
            read_images_text(os.path.join(sparse_dir, "images.txt")))

"""Minimal PCD (Point Cloud Data) file reader/writer (the port's own copy of
ed3dgs_tpu/data/pcd.py, pure numpy).

The reference consumes `.pcd` ground-truth clouds via Open3D in two places:
the COLMAP point-cloud supervision loss (utils/train_utils.py:66-89) and the
mesh evaluation against NerSemble `pointcloud_16.pcd` GT
(evaluate_pointcloud_mesh.py:110). This implements the PCD v0.7 container
directly (ascii + binary encodings; binary_compressed is not used by those
datasets).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

_TYPE_MAP = {("F", 4): "<f4", ("F", 8): "<f8",
             ("I", 1): "<i1", ("I", 2): "<i2", ("I", 4): "<i4",
             ("U", 1): "<u1", ("U", 2): "<u2", ("U", 4): "<u4"}


def read_pcd(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Returns (points [N,3] float32, normals [N,3] float32 or None)."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("ascii", "replace").strip()
            if not line or line.startswith("#"):
                continue
            key, _, rest = line.partition(" ")
            header[key.upper()] = rest.split()
            if key.upper() == "DATA":
                break
        fields = header["FIELDS"]
        sizes = [int(s) for s in header["SIZE"]]
        types = header["TYPE"]
        counts = [int(c) for c in header.get("COUNT", ["1"] * len(fields))]
        n = int(header["POINTS"][0])
        data_mode = header["DATA"][0].lower()

        dtype_fields = []
        for name, t, s, c in zip(fields, types, sizes, counts):
            base = _TYPE_MAP.get((t, s))
            if base is None:
                raise ValueError(f"unsupported PCD field type {t}{s} in {path}")
            dtype_fields.append((name, base, (c,)) if c > 1 else (name, base))
        dt = np.dtype(dtype_fields)

        if data_mode == "ascii":
            raw = np.loadtxt(f, dtype=np.float64, max_rows=n)
            raw = np.atleast_2d(raw)
            cols = {}
            off = 0
            for name, c in zip(fields, counts):
                cols[name] = raw[:, off] if c == 1 else raw[:, off:off + c]
                off += c
        elif data_mode == "binary":
            arr = np.frombuffer(f.read(n * dt.itemsize), dtype=dt, count=n)
            cols = {name: arr[name] for name in fields}
        else:
            raise ValueError(f"unsupported PCD DATA mode '{data_mode}' in {path}")

    pts = np.stack([cols["x"], cols["y"], cols["z"]], axis=1).astype(np.float32)
    normals = None
    if all(k in cols for k in ("normal_x", "normal_y", "normal_z")):
        normals = np.stack([cols["normal_x"], cols["normal_y"],
                            cols["normal_z"]], axis=1).astype(np.float32)
    return pts, normals


def read_pcd_colors(path: str) -> Optional[np.ndarray]:
    """Point colors of a .pcd as [N,3] float32 in [0,1], or None.

    Handles both separate r/g/b fields and PCL's packed-float 'rgb' field
    (0x00RRGGBB reinterpreted as f32 — what Open3D reads from NerSemble's
    pointcloud_16.pcd in prepare_single_nersemble_4_radegs.py:140-141)."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("ascii", "replace").strip()
            if not line or line.startswith("#"):
                continue
            key, _, rest = line.partition(" ")
            header[key.upper()] = rest.split()
            if key.upper() == "DATA":
                break
        fields = header["FIELDS"]
        sizes = [int(s) for s in header["SIZE"]]
        types = header["TYPE"]
        counts = [int(c) for c in header.get("COUNT", ["1"] * len(fields))]
        n = int(header["POINTS"][0])
        data_mode = header["DATA"][0].lower()
        dtype_fields = []
        for name, t, s, c in zip(fields, types, sizes, counts):
            base = _TYPE_MAP.get((t, s))
            if base is None:
                raise ValueError(f"unsupported PCD field type {t}{s} in {path}")
            dtype_fields.append((name, base, (c,)) if c > 1 else (name, base))
        dt = np.dtype(dtype_fields)
        if data_mode == "ascii":
            raw = np.loadtxt(f, dtype=np.float64, max_rows=n)
            raw = np.atleast_2d(raw)
            cols = {}
            off = 0
            for name, c in zip(fields, counts):
                cols[name] = raw[:, off] if c == 1 else raw[:, off:off + c]
                off += c
        elif data_mode == "binary":
            arr = np.frombuffer(f.read(n * dt.itemsize), dtype=dt, count=n)
            cols = {name: arr[name] for name in fields}
        else:
            raise ValueError(f"unsupported PCD DATA mode '{data_mode}'")
    if all(k in cols for k in ("r", "g", "b")):
        rgb = np.stack([cols["r"], cols["g"], cols["b"]], 1).astype(np.float32)
        return rgb / 255.0 if rgb.max() > 1.0 else rgb
    if "rgb" in cols:
        packed = np.ascontiguousarray(
            np.asarray(cols["rgb"], np.float32)).view(np.uint32)
        return np.stack([(packed >> 16) & 0xFF, (packed >> 8) & 0xFF,
                         packed & 0xFF], 1).astype(np.float32) / 255.0
    return None


def write_pcd(path: str, points: np.ndarray, normals: Optional[np.ndarray] = None,
              binary: bool = True) -> None:
    points = np.asarray(points, np.float32)
    fields = ["x", "y", "z"]
    cols = [points[:, 0], points[:, 1], points[:, 2]]
    if normals is not None:
        normals = np.asarray(normals, np.float32)
        fields += ["normal_x", "normal_y", "normal_z"]
        cols += [normals[:, 0], normals[:, 1], normals[:, 2]]
    n = len(points)
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {' '.join(fields)}\n"
        f"SIZE {' '.join(['4'] * len(fields))}\n"
        f"TYPE {' '.join(['F'] * len(fields))}\n"
        f"COUNT {' '.join(['1'] * len(fields))}\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        stacked = np.stack(cols, axis=1).astype("<f4")
        if binary:
            f.write(stacked.tobytes())
        else:
            np.savetxt(f, stacked, fmt="%.8g")


def load_pointcloud_any(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Dispatch .pcd / .ply point clouds to one (points, normals) contract."""
    if path.endswith(".pcd"):
        return read_pcd(path)
    from .ply import read_ply
    data = read_ply(path)["vertex"]
    pts = np.stack([data["x"], data["y"], data["z"]], 1).astype(np.float32)
    normals = None
    if "nx" in data.dtype.names:
        normals = np.stack([data["nx"], data["ny"], data["nz"]], 1).astype(np.float32)
    return pts, normals

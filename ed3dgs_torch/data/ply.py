"""Minimal PLY reader/writer (no external plyfile dependency); the port's
own copy of ed3dgs_tpu/data/ply.py, pure numpy.

Supports the layouts the pipeline needs:
  * input point clouds (x/y/z [+ red/green/blue uchar or float] [+ normals]),
  * Gaussian checkpoints (all-float32 vertex attributes, binary little endian),
  * triangle meshes (float vertices [+ uchar colours], uchar-list faces),
matching the reference's on-disk format (scene/gaussian_model.py:260-347) so
checkpoints interchange with the CUDA implementation.
"""

from __future__ import annotations

import numpy as np

_DTYPES = {
    "char": "i1", "uchar": "u1", "short": "i2", "ushort": "u2",
    "int": "i4", "uint": "u4", "float": "f4", "double": "f8",
    "int8": "i1", "uint8": "u1", "int16": "i2", "uint16": "u2",
    "int32": "i4", "uint32": "u4", "float32": "f4", "float64": "f8",
}


def read_ply(path: str) -> dict:
    """Read a PLY file -> {element_name: structured numpy array}."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop_name, np_dtype)])
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unexpected EOF in header")
            tok = line.strip().split()
            if not tok:
                continue
            if tok[0] == b"format":
                fmt = tok[1].decode()
            elif tok[0] == b"element":
                elements.append([tok[1].decode(), int(tok[2]), []])
            elif tok[0] == b"property":
                if tok[1] == b"list":
                    elements[-1][2].append(
                        (tok[4].decode(), ("list", _DTYPES[tok[2].decode()],
                                           _DTYPES[tok[3].decode()])))
                else:
                    elements[-1][2].append(
                        (tok[2].decode(), _DTYPES[tok[1].decode()]))
            elif tok[0] == b"end_header":
                break
        out = {}
        endian = "<" if fmt != "binary_big_endian" else ">"
        for name, count, props in elements:
            if any(isinstance(d, tuple) for _, d in props):
                out[name] = _read_list_element(f, fmt, endian, count, props)
                continue
            dtype = np.dtype([(p, endian + d) for p, d in props])
            if fmt == "ascii":
                rows = [f.readline().split() for _ in range(count)]
                arr = np.zeros(count, dtype=dtype)
                for i, row in enumerate(rows):
                    for (p, _), v in zip(props, row):
                        arr[p][i] = float(v)
            else:
                arr = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype)
            out[name] = arr
        return out


def _read_list_element(f, fmt, endian, count, props):
    """Slow path for elements with list properties (e.g. faces)."""
    rows = []
    for _ in range(count):
        row = {}
        if fmt == "ascii":
            tok = f.readline().split()
            i = 0
            for p, d in props:
                if isinstance(d, tuple):
                    n = int(tok[i]); i += 1
                    row[p] = np.array(tok[i:i + n], dtype=d[2]); i += n
                else:
                    row[p] = float(tok[i]); i += 1
        else:
            for p, d in props:
                if isinstance(d, tuple):
                    n = int(np.frombuffer(f.read(np.dtype(d[1]).itemsize),
                                          dtype=endian + d[1])[0])
                    row[p] = np.frombuffer(
                        f.read(n * np.dtype(d[2]).itemsize), dtype=endian + d[2])
                else:
                    row[p] = np.frombuffer(f.read(np.dtype(d).itemsize),
                                           dtype=endian + d)[0]
        rows.append(row)
    return rows


def write_ply(path: str, names, arrays, element: str = "vertex"):
    """Write float32 columns as a binary_little_endian PLY."""
    arrays = [np.asarray(a, dtype=np.float32).reshape(len(a), -1) for a in arrays]
    cols = []
    colnames = []
    for name, arr in zip(names, arrays):
        if arr.shape[1] == 1:
            cols.append(arr[:, 0]); colnames.append(name)
        else:
            for i in range(arr.shape[1]):
                cols.append(arr[:, i]); colnames.append(f"{name}_{i}")
    n = len(cols[0])
    dtype = np.dtype([(c, "<f4") for c in colnames])
    rec = np.zeros(n, dtype=dtype)
    for c, col in zip(colnames, cols):
        rec[c] = col
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element {element} {n}\n".encode())
        for c in colnames:
            f.write(f"property float {c}\n".encode())
        f.write(b"end_header\n")
        f.write(rec.tobytes())


def write_mesh_ply(path: str, vertices: np.ndarray, faces: np.ndarray,
                   vertex_colors: np.ndarray = None):
    """Triangle mesh (binary little endian): float vertices (+ uchar colors)
    + uchar-list faces."""
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int32)
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {len(vertices)}\n".encode())
        f.write(b"property float x\nproperty float y\nproperty float z\n")
        if vertex_colors is not None:
            f.write(b"property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(f"element face {len(faces)}\n".encode())
        f.write(b"property list uchar int vertex_indices\n")
        f.write(b"end_header\n")
        if vertex_colors is None:
            f.write(vertices.astype("<f4").tobytes())
        else:
            cols = np.clip(np.asarray(vertex_colors) * 255.0, 0, 255).astype(np.uint8)
            rec = np.zeros(len(vertices), dtype=np.dtype(
                [("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                 ("red", "u1"), ("green", "u1"), ("blue", "u1")]))
            rec["x"], rec["y"], rec["z"] = vertices.T
            rec["red"], rec["green"], rec["blue"] = cols.T
            f.write(rec.tobytes())
        rec = np.zeros(len(faces), dtype=np.dtype([("n", "u1"), ("v", "<i4", 3)]))
        rec["n"] = 3
        rec["v"] = faces
        f.write(rec.tobytes())


def read_mesh_ply(path: str):
    """Triangle mesh -> (vertices [V,3] f32, faces [F,3] i64)."""
    data = read_ply(path)
    v = data["vertex"]
    verts = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    faces = np.stack([np.asarray(row["vertex_indices"], np.int64)
                      for row in data["face"]])
    return verts, faces


def fetch_point_cloud(path: str):
    """Input ply -> (points [N,3] f32, colors [N,3] f32 in [0,1], normals [N,3]).

    Matches reference fetchPly (scene/dataset_readers.py:241-248)."""
    data = read_ply(path)["vertex"]
    names = data.dtype.names
    pts = np.stack([data["x"], data["y"], data["z"]], axis=1).astype(np.float32)
    if "red" in names:
        scale = 255.0 if data["red"].dtype == np.uint8 else 1.0
        col = np.stack([data["red"], data["green"], data["blue"]], axis=1).astype(np.float32) / scale
    else:
        col = np.ones_like(pts) * 0.5
    if "nx" in names:
        nrm = np.stack([data["nx"], data["ny"], data["nz"]], axis=1).astype(np.float32)
    else:
        nrm = np.zeros_like(pts)
    return pts, col, nrm


def store_point_cloud(path: str, points: np.ndarray, colors: np.ndarray):
    """Write an input-style ply with uchar colors (reference storePly,
    scene/dataset_readers.py:251-265)."""
    points = np.asarray(points, np.float32)
    colors8 = np.clip(np.asarray(colors) * 255.0, 0, 255).astype(np.uint8)
    normals = np.zeros_like(points)
    dtype = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                      ("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4"),
                      ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    rec = np.zeros(len(points), dtype=dtype)
    for i, c in enumerate(("x", "y", "z")):
        rec[c] = points[:, i]
        rec[("nx", "ny", "nz")[i]] = normals[:, i]
        rec[("red", "green", "blue")[i]] = colors8[:, i]
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {len(points)}\n".encode())
        for c in ("x", "y", "z", "nx", "ny", "nz"):
            f.write(f"property float {c}\n".encode())
        for c in ("red", "green", "blue"):
            f.write(f"property uchar {c}\n".encode())
        f.write(b"end_header\n")
        f.write(rec.tobytes())

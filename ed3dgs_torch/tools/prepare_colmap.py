"""Dataset preprocessing: video frame extraction + COLMAP project
construction (port of ed3dgs_tpu/tools/prepare_colmap.py; the reference
script/pre_nersemble.py:44-209, script/thirdparty/pre_colmap.py,
script/thirdparty/my_utils.py:31-66, script/thirdparty/helper3dg.py:130-190).

1. `extract_frames` -- per-camera mp4 -> images/<cam>/%04d.png: OpenCV
   decodes the video (without `cv2` it raises an ImportError that names
   the video); the port's codec writes the PNGs.
2. `prepare_input_images` -- copy each camera's frame 0 to colmap/input/.
3. `convert_poses_to_colmap_db` -- poses_bounds.npy (LLFF convention) ->
   COLMAP-schema sqlite `colmap/input.db` with known camera priors +
   `colmap/manual/{cameras,images,points3D}.txt` for point_triangulator.
4. `run_colmap_pipeline` -- drives the external `colmap` binary
   (feature_extractor -> exhaustive_matcher -> point_triangulator ->
   image_undistorter -> patch_match_stereo -> stereo_fusion); gated on the
   binary being on PATH.

The sqlite schema matches COLMAP's database.py so the real binary consumes
the output directly. Host numpy and the standard library.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sqlite3
import subprocess
import sys
from glob import glob

import numpy as np

MAX_IMAGE_ID = 2 ** 31 - 1

_SCHEMA = [
    """CREATE TABLE IF NOT EXISTS cameras (
        camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
        model INTEGER NOT NULL, width INTEGER NOT NULL,
        height INTEGER NOT NULL, params BLOB,
        prior_focal_length INTEGER NOT NULL)""",
    f"""CREATE TABLE IF NOT EXISTS images (
        image_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
        name TEXT NOT NULL UNIQUE, camera_id INTEGER NOT NULL,
        prior_qw REAL, prior_qx REAL, prior_qy REAL, prior_qz REAL,
        prior_tx REAL, prior_ty REAL, prior_tz REAL,
        CONSTRAINT image_id_check CHECK(image_id >= 0 and image_id < {MAX_IMAGE_ID}),
        FOREIGN KEY(camera_id) REFERENCES cameras(camera_id))""",
    """CREATE TABLE IF NOT EXISTS keypoints (
        image_id INTEGER PRIMARY KEY NOT NULL,
        rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
        FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE)""",
    """CREATE TABLE IF NOT EXISTS descriptors (
        image_id INTEGER PRIMARY KEY NOT NULL,
        rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
        FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE)""",
    """CREATE TABLE IF NOT EXISTS matches (
        pair_id INTEGER PRIMARY KEY NOT NULL,
        rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB)""",
    """CREATE TABLE IF NOT EXISTS two_view_geometries (
        pair_id INTEGER PRIMARY KEY NOT NULL,
        rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
        config INTEGER NOT NULL, F BLOB, E BLOB, H BLOB,
        qvec BLOB, tvec BLOB)""",
    "CREATE UNIQUE INDEX IF NOT EXISTS index_name ON images(name)",
]


class COLMAPDatabase(sqlite3.Connection):
    """Minimal COLMAP database writer (camera + image-prior subset of
    COLMAP's database.py, which the reference vendors at
    script/thirdparty/pre_colmap.py)."""

    @staticmethod
    def connect(path) -> "COLMAPDatabase":
        return sqlite3.connect(path, factory=COLMAPDatabase)

    def create_tables(self):
        for stmt in _SCHEMA:
            self.executescript(stmt)

    def add_camera(self, model, width, height, params,
                   prior_focal_length=False, camera_id=None):
        params = np.asarray(params, np.float64)
        cur = self.execute(
            "INSERT INTO cameras VALUES (?, ?, ?, ?, ?, ?)",
            (camera_id, model, int(width), int(height), params.tobytes(),
             int(prior_focal_length)))
        return cur.lastrowid

    def add_image(self, name, camera_id, prior_q=np.full(4, np.nan),
                  prior_t=np.full(3, np.nan), image_id=None):
        cur = self.execute(
            "INSERT INTO images VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (image_id, name, camera_id, *map(float, prior_q),
             *map(float, prior_t)))
        return cur.lastrowid


def rotmat2qvec(R):
    """Rotation matrix -> COLMAP (w,x,y,z) quaternion
    (reference script/thirdparty/my_utils.py:68-80)."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz]]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


def llff_poses_to_w2c(poses):
    """LLFF [N,3,5] pose blocks -> list of [4,4] world->cam matrices
    (reference my_utils.py:31-66, called on the [3,5,N] transpose: column
    reshuffle [c1, c0, -c2, c3] turns the LLFF [down,right,back] axes into
    OpenCV [right,down,forward] c2w, which is then inverted)."""
    poses = np.asarray(poses)
    reordered = np.concatenate([poses[:, :, 1:2], poses[:, :, 0:1],
                                -poses[:, :, 2:3], poses[:, :, 3:4]], axis=2)
    c2w = np.concatenate([reordered,
                          np.tile(np.array([[[0., 0., 0., 1.]]]),
                                  (len(poses), 1, 1))], axis=1)
    return [np.linalg.inv(m) for m in c2w]


def extract_frames(video_path: str, end_frame: int, out_root=None) -> int:
    """mp4 -> images/<camname>/%04d.png (reference pre_nersemble.py:44-70)."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{video_path}: decoding a video needs OpenCV "
                          "(pip install opencv-python)") from e
    from ..data.image_io import write_png

    cam_name = os.path.basename(video_path)[:-4]
    out_root = out_root or os.path.join(os.path.dirname(video_path), "images",
                                        cam_name)
    os.makedirs(out_root, exist_ok=True)
    existing = sum(os.path.exists(os.path.join(out_root, f"{i:04d}.png"))
                   for i in range(end_frame))
    if existing == end_frame:
        return end_frame
    cap = cv2.VideoCapture(video_path)
    n = 0
    while n < end_frame:
        ok, frame = cap.read()
        if not ok:
            break
        write_png(os.path.join(out_root, f"{n:04d}.png"), frame[..., ::-1])   # BGR -> RGB
        n += 1
    cap.release()
    return n


def prepare_input_images(folder: str):
    """Copy each camera's frame 0 into colmap/input/<cam>.png
    (reference pre_nersemble.py:73-86)."""
    cams = sorted(glob(os.path.join(folder, "images", "cam*", "")))
    savedir = os.path.join(folder, "colmap", "input")
    os.makedirs(savedir, exist_ok=True)
    for cam_dir in cams:
        src = os.path.join(cam_dir, "0000.png")
        if os.path.exists(src):
            shutil.copy(src, os.path.join(
                savedir, os.path.basename(os.path.dirname(cam_dir)) + ".png"))


def convert_poses_to_colmap_db(path: str):
    """poses_bounds.npy -> colmap/input.db + colmap/manual/*.txt
    (reference pre_nersemble.py:88-170). Returns {png_name: [qw qx qy qz
    tx ty tz fx fy]}."""
    poses_bounds = np.load(os.path.join(path, "poses_bounds.npy"))
    poses = poses_bounds[:, :15].reshape(-1, 3, 5)
    video_paths = sorted(glob(os.path.join(path, "cam*.mp4")))
    names = ([os.path.basename(v)[:-4] for v in video_paths]
             if len(video_paths) == len(poses)
             else [f"cam{i:02d}" for i in range(len(poses))])

    project = os.path.join(path, "colmap")
    manual = os.path.join(project, "manual")
    os.makedirs(manual, exist_ok=True)
    db_path = os.path.join(project, "input.db")
    if os.path.exists(db_path):
        os.remove(db_path)
    db = COLMAPDatabase.connect(db_path)
    db.create_tables()

    w2c_list = llff_poses_to_w2c(poses)
    image_lines, camera_lines, params_dict = [], [], {}
    for i, (m, name) in enumerate(zip(w2c_list, names)):
        H, W, focal = poses[i, :, -1]
        q = rotmat2qvec(m[:3, :3])
        t = m[:3, 3]
        png = name + ".png"
        params = np.array([focal, focal, W // 2, H // 2])
        cam_id = db.add_camera(1, W, H, params)       # model 1 = PINHOLE
        db.add_image(png, cam_id, prior_q=q, prior_t=t, image_id=i + 1)
        params_dict[png] = [*q, *t, focal, focal]
        image_lines.append(
            f"{i + 1} " + " ".join(str(v) for v in q) + " "
            + " ".join(str(v) for v in t) + f" {cam_id} {png}\n\n")
        camera_lines.append(
            f"{i + 1} PINHOLE {int(W)} {int(H)} {focal} {focal} "
            f"{int(W) // 2} {int(H) // 2}\n")
    db.commit()
    db.close()

    with open(os.path.join(manual, "images.txt"), "w") as f:
        f.writelines(image_lines)
    with open(os.path.join(manual, "cameras.txt"), "w") as f:
        f.writelines(camera_lines)
    open(os.path.join(manual, "points3D.txt"), "w").close()
    return params_dict


def run_colmap_pipeline(folder: str, colmap_bin: str = "colmap",
                        dense: bool = True):
    """Known-pose triangulation + dense reconstruction via the external
    COLMAP binary (reference helper3dg.py:130-190). Raises RuntimeError with
    a clear message when the binary is not on PATH."""
    if shutil.which(colmap_bin) is None:
        raise RuntimeError(
            f"'{colmap_bin}' binary not found on PATH; install COLMAP or run "
            "this stage on a machine that has it. The input.db/manual model "
            "built by convert_poses_to_colmap_db is ready for it.")
    project = os.path.join(folder, "colmap")
    db = os.path.join(project, "input.db")
    inputs = os.path.join(project, "input")
    distorted = os.path.join(project, "distorted/sparse/0")
    workspace = os.path.join(project, "dense/workspace")
    os.makedirs(distorted, exist_ok=True)
    os.makedirs(workspace, exist_ok=True)
    steps = [
        [colmap_bin, "feature_extractor", "--database_path", db,
         "--image_path", inputs],
        [colmap_bin, "exhaustive_matcher", "--database_path", db],
        [colmap_bin, "point_triangulator", "--database_path", db,
         "--image_path", inputs, "--input_path",
         os.path.join(project, "manual"), "--output_path", distorted],
        [colmap_bin, "image_undistorter", "--image_path", inputs,
         "--input_path", distorted, "--output_path", workspace],
    ]
    if dense:
        steps += [
            [colmap_bin, "patch_match_stereo", "--workspace_path", workspace],
            [colmap_bin, "stereo_fusion", "--workspace_path", workspace,
             "--output_path", os.path.join(workspace, "fused.ply")],
        ]
    for cmd in steps:
        subprocess.run(cmd, check=True)


def cmd_pre_dataset(args):
    videos = sorted(glob(os.path.join(args.path, "cam*.mp4")))
    for v in videos:
        n = extract_frames(v, args.frames)
        print(f"{os.path.basename(v)}: {n} frames", flush=True)
    prepare_input_images(args.path)
    convert_poses_to_colmap_db(args.path)
    print(f"COLMAP project written to {os.path.join(args.path, 'colmap')}",
          flush=True)
    if args.run_colmap:
        run_colmap_pipeline(args.path, dense=not args.no_dense)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--path", required=True,
                   help="scene dir with cam*.mp4 + poses_bounds.npy")
    p.add_argument("--frames", type=int, default=300)
    p.add_argument("--run_colmap", action="store_true",
                   help="also run the external colmap binary pipeline")
    p.add_argument("--no_dense", action="store_true")
    args = p.parse_args(argv)
    cmd_pre_dataset(args)


if __name__ == "__main__":
    sys.exit(main())

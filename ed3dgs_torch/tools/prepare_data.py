"""Dataset preparation CLI, offline preprocessing (port of
ed3dgs_tpu/tools/prepare_data.py).

  * `nersemble`  -- raw NerSemble capture -> per-camera frame PNGs with
    Cheung2004 colour correction (per-camera CCM json), alpha compositing
    to white (+ saved alpha masks), tongue segmentations extracted from
    facer colour masks, and an LLFF poses_bounds.npy
    (nersemble_scripts/prepare_nersemble_4_ed3dgs.py).
  * `add-tongue-points` -- inject red seed points near the cloud centroid
    so tongue Gaussians initialise (nersemble_scripts/add_tongue_points.py;
    non-interactive, backs up the original).
  * `downsample` -- voxel-downsample a dense ply until <= max points
    (script/downsample_point.py).

Host numpy, as the JAX tool. PNGs go through the port's codec
(data/image_io.py) and the alpha maps through its replay of PIL's
`convert("L")` and `BILINEAR` resize; JPEG frames (`images-2x/*.jpg`) need
Pillow, and without it raise an ImportError that names the file.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

import numpy as np

from ..data.image_io import read_image, resize_bilinear, to_gray, write_png
from ..data.ply import fetch_point_cloud, store_point_cloud

TONGUE_COLOR = (168, 91, 73)  # facer segmentation color (reference :46)


# --- color correction (Cheung 2004) ---------------------------------------

def _augment_cheung2004(rgb: np.ndarray, terms: int) -> np.ndarray:
    """Polynomial augmentation of Cheung et al. (2004), matching
    colour-science's matrix_augmented_Cheung2004 term sets."""
    r, g, b = rgb[:, 0], rgb[:, 1], rgb[:, 2]
    one = np.ones_like(r)
    tables = {
        3: [r, g, b],
        4: [r, g, b, one],
        5: [r, g, b, r * g * b, one],
        7: [r, g, b, r * g, r * b, g * b, one],
        8: [r, g, b, r * g, r * b, g * b, r * g * b, one],
        10: [r, g, b, r * g, r * b, g * b, r * r, g * g, b * b, one],
        11: [r, g, b, r * g, r * b, g * b, r * r, g * g, b * b, r * g * b, one],
        14: [r, g, b, r * g, r * b, g * b, r * r, g * g, b * b, r * g * b,
             r ** 3, g ** 3, b ** 3, one],
    }
    if terms not in tables:
        raise ValueError(f"unsupported Cheung2004 term count: {terms}")
    return np.stack(tables[terms], axis=1)


def srgb_decode(v):
    v = np.asarray(v, np.float64)
    return np.where(v > 0.04045, ((v + 0.055) / 1.055) ** 2.4, v / 12.92)


def srgb_encode(v):
    v = np.clip(np.asarray(v, np.float64), 0, None)
    return np.where(v > 0.0031308, 1.055 * v ** (1 / 2.4) - 0.055, 12.92 * v)


def apply_ccm(image: np.ndarray, ccm: np.ndarray) -> np.ndarray:
    """Color-correct an sRGB [0,1] image with a precomputed CCM
    (reference colour_correction_Cheung2004_precomputed :15-24, wrapped in
    the sRGB decode/encode of :64-66)."""
    shape = image.shape
    lin = srgb_decode(image).reshape(-1, 3)
    aug = _augment_cheung2004(lin, ccm.shape[-1])
    out = (ccm @ aug.T).T.reshape(shape)
    return np.clip(srgb_encode(out), 0, 1)


def read_alpha(path: str, width: int, height: int) -> np.ndarray:
    """An alpha map as PIL's `Image.open(path).convert("L").resize((width,
    height), Image.BILINEAR)` gives it: uint8 [height, width]."""
    return resize_bilinear(to_gray(read_image(path)), width, height)


# --- subcommands ----------------------------------------------------------

def cmd_downsample(args):
    pts, cols, _ = fetch_point_cloud(args.input)
    voxel = 0.001
    while len(pts) > args.max_points:
        keys = np.floor(pts / voxel).astype(np.int64)
        _, idx = np.unique(keys, axis=0, return_index=True)
        pts, cols = pts[idx], cols[idx]
        print(f"voxel {voxel:.4f}: {len(pts)} points")
        voxel += 0.005
    store_point_cloud(args.output, pts, cols)
    print(f"wrote {len(pts)} points -> {args.output}")


def cmd_add_tongue_points(args):
    pts, cols, _ = fetch_point_cloud(args.file)
    centroid = pts.mean(axis=0)
    rng = np.random.default_rng(args.seed)
    normals = rng.standard_normal((args.num_points, 3))
    scale = np.array([0.01, 0.01, 0.015])
    offset = np.array(args.offset)
    new_pts = centroid + offset + normals * scale
    new_cols = np.tile([[1.0, 0.0, 0.0]], (args.num_points, 1))
    backup = os.path.splitext(args.file)[0] + "_original" + os.path.splitext(args.file)[1]
    shutil.copy(args.file, backup)
    store_point_cloud(args.file,
                      np.concatenate([pts, new_pts.astype(np.float32)]),
                      np.concatenate([cols, new_cols.astype(np.float32)]))
    print(f"added {args.num_points} tongue seed points; original -> {backup}")


def cmd_nersemble(args):
    root, out = args.root_folder, args.output_folder
    ts_dir = os.path.join(root, "sequences", args.scene_folder, "timesteps")
    timesteps = sorted(os.listdir(ts_dir))
    if args.number_of_frames:
        timesteps = timesteps[: args.number_of_frames]

    with open(os.path.join(root, "calibration", "camera_params.json")) as f:
        calib = json.load(f)
    ccm = None
    if args.ccm_json and os.path.exists(args.ccm_json):
        with open(args.ccm_json) as f:
            ccm = {k: np.array(v) for k, v in json.load(f).items()}

    cameras = list(calib["world_2_cam"].keys())
    _save_pose_bounds(out, calib, cameras, args.width, args.height)

    for ci, camera in enumerate(cameras):
        img_dir = os.path.join(out, "images", f"cam{ci:02d}")
        mask_dir = os.path.join(out, "alpha_masks", f"cam{ci:02d}")
        seg_dir = os.path.join(out, "segmentations", f"cam{ci:02d}")
        for d in (img_dir, mask_dir, seg_dir):
            os.makedirs(d, exist_ok=True)
        for fi, ts in enumerate(timesteps):
            src = os.path.join(ts_dir, ts, "images-2x", f"cam_{camera}.jpg")
            if not os.path.exists(src):
                src = os.path.join(ts_dir, ts, "images-2x", f"cam_{camera}.png")
            img = np.asarray(read_image(src), np.float64)[..., :3] / 255.0
            if ccm is not None and camera in ccm:
                img = apply_ccm(img, ccm[camera])
            # alpha compositing to white (reference apply_alpha_mask)
            mpath = os.path.join(ts_dir, ts, "alpha_map", f"cam_{camera}.png")
            if args.alpha_mask and os.path.exists(mpath):
                m = read_alpha(mpath, img.shape[1], img.shape[0])
                a = np.asarray(m, np.float64)[..., None] / 255.0
                img = img * a + (1.0 - a)
                write_png(os.path.join(mask_dir, f"{fi:04d}.png"), m)
            write_png(os.path.join(img_dir, f"{fi:04d}.png"),
                      (np.clip(img, 0, 1) * 255).astype(np.uint8))
            # tongue segmentation from the facer color mask
            spath = os.path.join(ts_dir, ts, "facer_segmentation_masks",
                                 f"color_segmentation_cam_{camera}.png")
            if os.path.exists(spath):
                seg = read_image(spath)[..., :3]
                binary = np.all(seg == np.array(TONGUE_COLOR), axis=-1)
                write_png(os.path.join(seg_dir, f"{fi:04d}.png"),
                          (binary * 255).astype(np.uint8))
    print(f"prepared {len(cameras)} cameras x {len(timesteps)} frames -> {out}")


def _save_pose_bounds(out, calib, cameras, width, height):
    """LLFF poses_bounds.npy with [down, right, backwards] axes
    (reference create_pose_bounds/save_poses :79-148)."""
    os.makedirs(out, exist_ok=True)
    K = np.array(calib["intrinsics"])
    focal = float(np.mean([K[0][0], K[1][1]]))
    mapping = np.array([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, -1.0]])
    rows = []
    for cam in cameras:
        w2c = np.array(calib["world_2_cam"][cam])
        c2w = np.linalg.inv(w2c)
        pose = np.hstack([c2w[:3, :3] @ mapping, c2w[:3, 3].reshape(-1, 1)])
        rows.append(np.concatenate([
            np.hstack([pose, np.array([height, width, focal]).reshape(-1, 1)]).ravel(),
            [np.nan, np.nan]]))
    np.save(os.path.join(out, "poses_bounds.npy"), np.asarray(rows))


def main(argv=None):
    p = argparse.ArgumentParser(description="dataset preparation")
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("downsample")
    d.add_argument("input")
    d.add_argument("output")
    d.add_argument("--max_points", type=int, default=100_000)
    d.set_defaults(fn=cmd_downsample)

    t = sub.add_parser("add-tongue-points")
    t.add_argument("file")
    t.add_argument("--num_points", type=int, default=5000)
    t.add_argument("--offset", type=float, nargs=3,
                   default=[0.025, -0.06, 0.055])
    t.add_argument("--seed", type=int, default=0)
    t.set_defaults(fn=cmd_add_tongue_points)

    n = sub.add_parser("nersemble")
    n.add_argument("root_folder")
    n.add_argument("scene_folder")
    n.add_argument("output_folder")
    n.add_argument("--alpha_mask", action="store_true")
    n.add_argument("--number_of_frames", type=int, default=None)
    n.add_argument("--ccm_json", default=None)
    n.add_argument("--width", type=int, default=1100)
    n.add_argument("--height", type=int, default=1604)
    n.set_defaults(fn=cmd_nersemble)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

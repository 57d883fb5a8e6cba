"""Per-timestep NerSemble -> COLMAP-model export, the RaDe-GS sibling
pipeline (port of ed3dgs_tpu/tools/prepare_radegs.py; the reference
nersemble_scripts/prepare_single_nersemble_4_radegs.py:1-463 and its batch
script prepare_all_nersemble_4_radegs.py:1-19).

The COLMAP binary writers are data/colmap.py's (read_write_model.py's byte
layout), the Cheung2004 colour correction tools/prepare_data.apply_ccm, the
.pcd reader data/pcd.py. Host numpy. PNG masks go through the port's codec
and its replay of PIL's `convert("L")` and `BILINEAR`; the frames are JPEG
(`images-2x/cam_*.jpg`), so compositing them (`--apply_alpha_mask`) needs
Pillow, and without it raises an ImportError that names the file. Without
the flag the frames are copied as they are.

Usage:
  python -m ed3dgs_torch.tools.prepare_radegs single <root> <scene> <out> <timestep>
  python -m ed3dgs_torch.tools.prepare_radegs all <root> <scene> <out>
both accept --apply_alpha_mask and --ccm_json.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil

import numpy as np

from ..data.colmap import (ColmapCamera, ColmapImage, rotmat_to_qvec,
                           write_cameras_binary, write_images_binary,
                           write_points3d_binary)
from ..data.image_io import read_image, write_image
from ..data.pcd import read_pcd, read_pcd_colors
from .prepare_data import apply_ccm, read_alpha

CAMERA_ID = 1
# full-resolution NerSemble frame; images-2x sources are half-res but the
# reference writes the intrinsics at this fixed size
# (prepare_single_nersemble_4_radegs.py:172-173)
WIDTH, HEIGHT = 1100, 1604


def _load_calib(root_folder):
    with open(os.path.join(root_folder, "calibration",
                           "camera_params.json")) as f:
        return json.load(f)


def build_cameras(calib):
    intr = np.asarray(calib["intrinsics"])
    params = [intr[0][0], intr[1][1], intr[0][2], intr[1][2]]
    return {CAMERA_ID: ColmapCamera(CAMERA_ID, "PINHOLE", WIDTH, HEIGHT,
                                    np.asarray(params, np.float64))}


def build_images(calib):
    """world_2_cam matrices -> COLMAP images dict (wxyz quaternions),
    reference prepare_extrinsics (prepare_single_nersemble_4_radegs.py:188-219)."""
    images = {}
    for idx, (cam_name, mat) in enumerate(calib["world_2_cam"].items(), 1):
        m = np.asarray(mat, np.float64)
        images[idx] = ColmapImage(
            idx, rotmat_to_qvec(m[:3, :3]), m[:3, 3], CAMERA_ID,
            f"cam_{cam_name}.jpg")
    return images


def _write_image(src, mask_path, dest, ccm):
    img = np.asarray(read_image(src), np.float64)[..., :3] / 255.0
    if mask_path and os.path.exists(mask_path):
        m = read_alpha(mask_path, img.shape[1], img.shape[0])
        a = np.asarray(m, np.float64)[..., None] / 255.0
        img = img * a + (1.0 - a)          # composite to white
    if ccm is not None:
        img = apply_ccm(img, ccm)
    write_image(dest, (np.clip(img, 0, 1) * 255).astype(np.uint8))


def prepare_single(root_folder, scene_name, output_folder, timestep,
                   apply_alpha_mask=False, ccm=None):
    ts_root = os.path.join(root_folder, "sequences", scene_name, "timesteps",
                           timestep)
    images_src = os.path.join(ts_root, "images-2x")
    masks_src = os.path.join(ts_root, "alpha_map")
    pcd_src = os.path.join(ts_root, "colmap", "pointclouds",
                           "pointcloud_16.pcd")
    images_dst = os.path.join(output_folder, "images")
    sparse_dst = os.path.join(output_folder, "sparse", "0")
    os.makedirs(images_dst, exist_ok=True)
    os.makedirs(sparse_dst, exist_ok=True)

    calib = _load_calib(root_folder)

    if os.path.isdir(images_src):
        for filename in sorted(os.listdir(images_src)):
            cam_name = filename.split("_")[-1].split(".")[0]
            src = os.path.join(images_src, filename)
            dst = os.path.join(images_dst, filename)
            if not os.path.isfile(src):
                continue
            if apply_alpha_mask and os.path.isdir(masks_src):
                mask = os.path.join(
                    masks_src, os.path.splitext(filename)[0] + ".png")
                _write_image(src, mask, dst,
                             ccm.get(cam_name) if ccm else None)
            else:
                shutil.copy2(src, dst)
    else:
        print(f"warning: image folder missing: {images_src}")

    write_cameras_binary(os.path.join(sparse_dst, "cameras.bin"),
                         build_cameras(calib))
    write_images_binary(os.path.join(sparse_dst, "images.bin"),
                        build_images(calib))
    if os.path.exists(pcd_src):
        pts, _ = read_pcd(pcd_src)
        cols = read_pcd_colors(pcd_src)
        if cols is None:
            cols = np.full_like(pts, 0.5)
        write_points3d_binary(os.path.join(sparse_dst, "points3D.bin"),
                              pts, (cols * 255).astype(np.uint8))
    else:
        print(f"warning: pointcloud missing: {pcd_src}")
    return output_folder


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("mode", choices=["single", "all"])
    p.add_argument("root_folder")
    p.add_argument("scene_name")
    p.add_argument("output_folder")
    p.add_argument("timestep", nargs="?", default=None,
                   help="required for mode=single")
    p.add_argument("--apply_alpha_mask", action="store_true")
    p.add_argument("--ccm_json", default=None,
                   help="per-camera Cheung2004 CCM json (nersemble ccm_443)")
    args = p.parse_args(argv)

    ccm = None
    if args.ccm_json and os.path.exists(args.ccm_json):
        with open(args.ccm_json) as f:
            ccm = {k: np.asarray(v) for k, v in json.load(f).items()}

    if args.mode == "single":
        if not args.timestep:
            p.error("mode=single requires a timestep")
        prepare_single(args.root_folder, args.scene_name, args.output_folder,
                       args.timestep, args.apply_alpha_mask, ccm)
        print(f"wrote {args.output_folder}")
        return
    ts_dir = os.path.join(args.root_folder, "sequences", args.scene_name,
                          "timesteps")
    for ts in sorted(os.listdir(ts_dir)):
        prepare_single(args.root_folder, args.scene_name,
                       os.path.join(args.output_folder, ts), ts,
                       args.apply_alpha_mask, ccm)
        print(f"wrote {os.path.join(args.output_folder, ts)}")


if __name__ == "__main__":
    main()

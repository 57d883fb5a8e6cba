"""Small offline NerSemble utilities (port of ed3dgs_tpu/tools/nersemble_utils.py;
the reference's loose-script tail).

Subcommands and their reference equivalents:
  pose-bounds <folder>            nersemble_scripts/print_pose_bounds.py:1-36
  seg-color <image> [x y]         nersemble_scripts/get_segmentation_color.py
                                  (headless: prints the RGB at (x, y), or the
                                  unique colors with pixel counts when no
                                  coordinate is given, in place of an
                                  interactive matplotlib window)
  copy-colmap-pcd <src> <dst>     copy_colmap_pcd_to_unprocessed_nersemble.py
  render-mesh <recon.ply> [out]   render_mesh_interactive.py:1-29 (headless:
                                  renders the three fixed pyvista views of the
                                  mesh to PNGs with the z-buffer splatter from
                                  tools/mesh_video.py, on --device, instead
                                  of an OpenGL window)

Host numpy but for render-mesh's splatter; PNGs through the port's codec
(data/image_io.py), any other image format through Pillow.
"""

from __future__ import annotations

import argparse
import os
import shutil

import numpy as np

# the reference viewer's three fixed (eye, focal_point, up) pyvista camera
# positions, zoom 3 (render_mesh_interactive.py:10-27)
INTERACTIVE_VIEWS = {
    "central": (np.array([1.66830635, -0.73332511, 1.93158995]),
                np.array([0.09087289, 0.09789378, -0.07711283]),
                np.array([-0.26515857, -0.94658707, -0.18347714])),
    "side": (np.array([2.29865688, -0.15459584, -1.58577013]),
             np.array([0.09087289, 0.09789378, -0.07711283]),
             np.array([-0.24215930, -0.95037234, -0.19532353])),
    "tongue": (np.array([0.99331655, -0.35115023, 0.14970680]),
               np.array([0.10369454, 0.13272482, -0.06655414]),
               np.array([-0.43076953, -0.88047529, -0.19799212])),
}


def cmd_pose_bounds(args):
    """Pretty-print poses_bounds.npy rows in the LLFF [R|t|hwf] layout."""
    path = os.path.join(args.folder, "poses_bounds.npy")
    if not os.path.exists(path):
        print(f"Error: The file {path} does not exist.")
        return 1
    pb = np.load(path)
    mats = pb[:, :15].reshape(-1, 3, 5)
    for i in range(pb.shape[0]):
        print(f"Camera: {i}")
        print("\tPose:")
        print("\t" + np.array2string(mats[i, :, :4]).replace("\n", "\n\t"))
        print(f"\tHeight:       {mats[i, 0, 4]}")
        print(f"\tWidth:        {mats[i, 1, 4]}")
        print(f"\tFocal:        {mats[i, 2, 4]}")
        print(f"\tClose bound:  {pb[i, 15]}")
        print(f"\tFar bound:    {pb[i, 16]}\n")
    return 0


def cmd_seg_color(args):
    from ..data.image_io import read_image

    img = read_image(args.image)[..., :3]
    if args.x is not None and args.y is not None:
        print(f"RGB values at ({args.x}, {args.y}): "
              f"{img[args.y, args.x, :].tolist()}")
        return 0
    colors, counts = np.unique(img.reshape(-1, 3), axis=0,
                               return_counts=True)
    for c, n in sorted(zip(colors.tolist(), counts.tolist()),
                       key=lambda t: -t[1]):
        print(f"{c}: {n} px")
    return 0


def cmd_copy_colmap_pcd(args):
    """Copy each timestep's colmap/ folder from a processed capture into an
    unprocessed one (replacing any empty placeholder)."""
    for ts in sorted(os.listdir(args.timesteps_w_colmap_path)):
        src = os.path.join(args.timesteps_w_colmap_path, ts, "colmap")
        dst = os.path.join(args.timesteps_wo_colmap_path, ts, "colmap")
        if not os.path.isdir(src):
            continue
        if os.path.isdir(dst):
            shutil.rmtree(dst)
        shutil.copytree(src, dst)
        print(f"{ts}: copied colmap/")
    return 0


def cmd_render_mesh(args):
    from .mesh_video import _load_colored_points, render_points
    from .render import save_img

    pts, cn, is_normals = _load_colored_points(args.mesh)
    out_dir = args.out or os.path.dirname(os.path.abspath(args.mesh))
    os.makedirs(out_dir, exist_ok=True)
    for name, (eye, target, up) in INTERACTIVE_VIEWS.items():
        img = render_points(pts, cn, eye, target, up, zoom=args.zoom,
                            width=args.width, height=args.height,
                            shaded=is_normals, device=args.device)
        path = os.path.join(out_dir, f"mesh_view_{name}.png")
        save_img(path, img)
        print(f"saved {path}")
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("pose-bounds", help="print poses_bounds.npy")
    s.add_argument("folder")
    s.set_defaults(fn=cmd_pose_bounds)

    s = sub.add_parser("seg-color", help="inspect segmentation mask colors")
    s.add_argument("image")
    s.add_argument("x", nargs="?", type=int, default=None)
    s.add_argument("y", nargs="?", type=int, default=None)
    s.set_defaults(fn=cmd_seg_color)

    s = sub.add_parser("copy-colmap-pcd",
                       help="copy per-timestep colmap/ folders")
    s.add_argument("--timesteps_w_colmap_path", required=True)
    s.add_argument("--timesteps_wo_colmap_path", required=True)
    s.set_defaults(fn=cmd_copy_colmap_pcd)

    s = sub.add_parser("render-mesh", help="render the 3 fixed mesh views")
    s.add_argument("mesh")
    s.add_argument("out", nargs="?", default=None)
    s.add_argument("--zoom", type=float, default=3.0)
    s.add_argument("--width", type=int, default=550)
    s.add_argument("--height", type=int, default=802)
    s.add_argument("--device", default="cuda",
                   help="torch device to splat on (default: the GPU)")
    s.set_defaults(fn=cmd_render_mesh)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())

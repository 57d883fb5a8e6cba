"""Mesh-vs-GT-pointcloud evaluation CLI (port of
ed3dgs_tpu/tools/evaluate_mesh.py; the reference evaluate_pointcloud_mesh.py).

Walks <model_path>/meshes/<timestep>/recon.ply against per-timestep GT point
clouds, prints mean point-to-mesh distance (mm) and mean normal cosine
similarity (evaluate_pointcloud_mesh.py:107-168), and writes
<model_path>/mesh_eval.json as the JAX tool does. The closest points are
found on the card unless `--device cpu` is passed; without a GPU the
default raises.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import numpy as np

from ..data.ply import read_mesh_ply, read_ply
from ..mesh.mesh_eval import evaluate_mesh_against_pointcloud


def load_gt_pointcloud(path: str):
    """GT cloud from .ply or .pcd (NerSemble ships pointcloud_16.pcd,
    reference evaluate_pointcloud_mesh.py:86,111), with optional normals."""
    from ..data.pcd import load_pointcloud_any
    pts, normals = load_pointcloud_any(path)
    return pts.astype(np.float64), (None if normals is None
                                    else normals.astype(np.float64))


def main(argv=None):
    """Evaluate every timestep's mesh; returns what mesh_eval.json holds."""
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", "-m", required=True)
    p.add_argument("--gt_dir", required=True,
                   help="dir with per-timestep GT clouds <ts>/pointcloud.ply "
                        "or flat <ts>.ply files")
    p.add_argument("--scale_mm", type=float, default=1000.0)
    p.add_argument("--max_points", type=int, default=10000)
    p.add_argument("--device", default="cuda",
                   help="torch device for the closest-point search (default: the GPU)")
    args = p.parse_args(argv)

    from ..device import resolve_device
    device = resolve_device(args.device)

    mesh_dirs = sorted(glob.glob(os.path.join(args.model_path, "meshes", "*")))
    results = {}
    dists, sims = [], []
    for md in mesh_dirs:
        ts = os.path.basename(md)
        mesh_path = os.path.join(md, "recon.ply")
        gt_candidates = [
            os.path.join(args.gt_dir, ts, "pointcloud.ply"),
            os.path.join(args.gt_dir, f"{ts}.ply"),
            # NerSemble raw layout (reference evaluate_pointcloud_mesh.py:86)
            os.path.join(args.gt_dir, "timesteps",
                         f"frame_{int(ts):05d}" if ts.isdigit() else ts,
                         "colmap", "pointclouds", "pointcloud_16.pcd"),
            os.path.join(args.gt_dir, f"{ts}.pcd"),
        ]
        gt_path = next((g for g in gt_candidates if os.path.exists(g)), None)
        if gt_path is None or not os.path.exists(mesh_path):
            continue
        verts, faces = read_mesh_ply(mesh_path)
        gt_pts, gt_normals = load_gt_pointcloud(gt_path)
        if len(gt_pts) > args.max_points:
            idx = np.random.default_rng(0).choice(len(gt_pts), args.max_points,
                                                  replace=False)
            gt_pts = gt_pts[idx]
            gt_normals = gt_normals[idx] if gt_normals is not None else None
        d, s = evaluate_mesh_against_pointcloud(verts, faces, gt_pts,
                                                gt_normals, args.scale_mm, device)
        results[ts] = {"mean_distance_mm": d, "normal_similarity": s}
        dists.append(d)
        if s is not None:
            sims.append(s)
        print(f"{ts}: distance {d:.3f} mm, normal similarity "
              f"{s if s is None else round(s, 4)}", flush=True)
    if dists:
        print(f"avg distance: {np.mean(dists):.3f} mm")
    if sims:
        print(f"avg normal similarity: {np.mean(sims):.4f}")
    with open(os.path.join(args.model_path, "mesh_eval.json"), "w") as f:
        json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
    sys.exit(0)

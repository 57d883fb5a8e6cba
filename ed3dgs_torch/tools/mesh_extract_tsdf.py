"""TSDF-fusion mesh extraction CLI (port of
ed3dgs_tpu/tools/mesh_extract_tsdf.py; the reference
mesh_extract_tsdf_fusion.py).

Usage:
  python -m ed3dgs_torch.tools.mesh_extract_tsdf -m <model_dir> -s <scene_dir> \
      [--timestep_index 0] [--engine sparse|dense] [--voxel_size 0.002]

Renders every train view at a timestep through `tools.FrameRenderer` (on
the card a CUDA graph captured once and replayed a view, as the JAX tool
jits `render_view`; K1, K4 and K5a), masks its median depth by the
rendered alpha and the GT mask,
fuses the views into a TSDF volume on the same device (`mesh/tsdf_sparse.py`,
the default, or the dense `mesh/tsdf.py`) and writes
<model_dir>/recon_tsdf.ply. It runs on the card unless `--device cpu` is
passed; without a GPU the default raises. The JAX tool renders with its
"xla" backend at `max_per_tile=2048`; the port's one backend keeps a tile's
`chunk * 512` pairs.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from . import FrameRenderer, add_model_flags, load_trained


def main(argv=None):
    """Fuse one timestep; returns its counts (views, blocks, voxels,
    vertices, faces), the render ms of each view and the fuse and
    extraction seconds (host clock after a synchronise), the output path,
    the mesh (vertices, faces, colours), the volume, and the fused inputs (depths, colours, world-view
    matrices, focals)."""
    p = argparse.ArgumentParser()
    add_model_flags(p)
    p.add_argument("--timestep_index", type=int, default=0)
    p.add_argument("--voxel_size", type=float, default=0.002)
    p.add_argument("--engine", choices=("sparse", "dense"), default="sparse",
                   help="sparse = block-hashed voxel grid (memory ~ surface area; "
                        "default); dense = full bounding-box grid (small scenes only)")
    p.add_argument("--alpha_thres", type=float, default=0.5)
    p.add_argument("--depth_max", type=float, default=8.0)
    args = p.parse_args(argv)

    import torch

    from ..data.ply import write_mesh_ply
    from ..device import resolve_device
    from ..mesh import tsdf
    from ..mesh.tsdf_sparse import fuse_volume_sparse
    from ..ops.rasterize import RasterConfig

    device = resolve_device(args.device)
    cfg, scene, dparams = load_trained(args, device)
    model, opt = cfg.model, cfg.opt
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    views = sorted([c for c in scene.train_cameras if c.frame_no == args.timestep_index],
                   key=lambda c: c.cam_no)
    m0 = views[0].matrices()
    rcfg = RasterConfig(width=m0.width, height=m0.height, focal_x=m0.focal_x,
                        focal_y=m0.focal_y, pair_capacity=opt.pair_capacity,
                        chunk=opt.raster_chunk)
    bg = torch.ones(3, dtype=torch.float32, device=device)
    # one graph for the views (one raster config), as the JAX tool jits one
    # render_view; its outputs are overwritten by the next view, so the
    # depth is cloned and the colours copied by the clamp
    frame = FrameRenderer(cfg.hidden, bg, sh_degree=model.sh_degree,
                          kernel_size=model.kernel_size,
                          disable_filter3d=model.disable_filter3D,
                          num_down_emb=cfg.hidden.min_embeddings)
    trained = (scene.params, scene.aux, dparams)

    depths, colors, wvs, focals, render_ms = [], [], [], [], []
    for view in views:
        m = view.matrices()
        sync()
        t0 = time.perf_counter()
        out = frame("view", trained, rcfg, m.world_view, m.full_proj, m.campos, view.time)
        depth = out["median_depth"][0].clone()
        depth[out["mask"][0] < args.alpha_thres] = 0.0
        gt_mask = view.alpha_mask
        if gt_mask is not None:
            depth[torch.as_tensor(np.asarray(gt_mask)[0], device=device) < 0.5] = 0.0
        depths.append(depth)
        colors.append(torch.clamp(out["render"], 0, 1).permute(1, 2, 0))
        wvs.append(m.world_view)
        focals.append((m.focal_x, m.focal_y))
        sync()
        render_ms.append((time.perf_counter() - t0) * 1e3)
        view.release_image()

    t0 = time.perf_counter()
    if args.engine == "sparse":
        vol = fuse_volume_sparse(depths, colors, wvs, focals, voxel_size=args.voxel_size,
                                 depth_max=args.depth_max)
        blocks, voxels = vol.n_blocks, vol.n_blocks * vol.block ** 3
    else:
        vol = tsdf.fuse_volume(depths, colors, wvs, focals, voxel_size=args.voxel_size,
                               depth_max=args.depth_max)
        blocks, voxels = None, int(np.prod(vol.dims))
    sync()
    fuse_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    verts, faces, vcols = (vol.extract_surface() if args.engine == "sparse"
                           else tsdf.extract_surface(vol))
    extract_s = time.perf_counter() - t0
    out_path = os.path.join(model.model_path, "recon_tsdf.ply")
    write_mesh_ply(out_path, verts, faces, vcols)
    print(f"{len(verts)} vertices, {len(faces)} faces -> {out_path}", flush=True)
    return dict(views=len(views), blocks=blocks, voxels=voxels, vertices=len(verts),
                faces=len(faces), render_ms=render_ms, fuse_s=fuse_s, extract_s=extract_s,
                path=out_path, mesh=(verts, faces, vcols), volume=vol,
                inputs=(depths, colors, wvs, focals))


if __name__ == "__main__":
    main()
    sys.exit(0)

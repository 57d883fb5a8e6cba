"""Tetrahedra mesh extraction CLI (port of ed3dgs_tpu/tools/mesh_extract.py;
the reference mesh_extract_tetrahedra.py).

Usage:
  python -m ed3dgs_torch.tools.mesh_extract -m <model_dir> -s <scene_dir> \
      --start_timestep_index 0 --end_timestep_index 10 [--configs cfg.py]

Writes <model_dir>/meshes/<timestep>/recon.ply for each timestep, from the
train cameras of that frame (mesh/extract.py). It runs on the card unless
`--device cpu` is passed; without a GPU the default raises.
"""

from __future__ import annotations

import argparse
import os
import sys

from . import add_model_flags, load_trained


def main(argv=None):
    """Extract the timesteps the flags ask for; returns {timestep index:
    (vertex count, face count, extract_mesh_at_timestep's stats)}."""
    p = argparse.ArgumentParser()
    add_model_flags(p)
    p.add_argument("--start_timestep_index", type=int, default=0)
    p.add_argument("--end_timestep_index", type=int, default=1)
    p.add_argument("--binary_steps", type=int, default=8)
    args = p.parse_args(argv)

    from ..device import resolve_device
    from ..mesh.extract import export_mesh, extract_mesh_at_timestep

    cfg, scene, dparams = load_trained(args, resolve_device(args.device))
    model, hidden, opt = cfg.model, cfg.hidden, cfg.opt

    maxtime = scene.maxtime
    train_cams = sorted(scene.train_cameras, key=lambda c: (c.cam_no, c.frame_no))
    m0 = train_cams[0].matrices()

    meshes_dir = os.path.join(model.model_path, "meshes")
    done = {}
    for ts_idx in range(args.start_timestep_index, args.end_timestep_index):
        views = [c for c in train_cams if c.frame_no == ts_idx]
        t = ts_idx / maxtime
        stats = {}
        verts, faces = extract_mesh_at_timestep(
            scene.params, scene.aux, dparams, hidden, views,
            timestep=t, width=m0.width, height=m0.height,
            focal_x=m0.focal_x, focal_y=m0.focal_y,
            kernel_size=model.kernel_size, num_down_emb=hidden.min_embeddings,
            loaded_iter=scene.loaded_iter or 10 ** 9,
            n_binary_steps=args.binary_steps,
            pair_capacity=opt.pair_capacity, sh_degree=model.sh_degree, stats=stats)
        out = os.path.join(meshes_dir, f"{ts_idx:05d}", "recon.ply")
        export_mesh(out, verts, faces)
        print(f"timestep {ts_idx}: {len(verts)} vertices, {len(faces)} faces "
              f"-> {out}", flush=True)
        done[ts_idx] = (len(verts), len(faces), stats)
    return done


if __name__ == "__main__":
    main()
    sys.exit(0)

"""Gaussian-ellipsoid mesh export CLI (port of
ed3dgs_tpu/tools/gaussians_to_mesh.py; the reference gaussians_to_mesh.py).

Usage:
  python -m ed3dgs_torch.tools.gaussians_to_mesh -m <model_dir> -s <scene_dir> \
      [--start_timestep_index 0] [--end_timestep_index 1] [--random_colors]

Per timestep: deform the cloud (mesh/extract.py `deformed_gaussians`), emit
one icosphere per visible Gaussian coloured by its SH-DC colour and write
<model_dir>/gaussian_meshes/<timestep>.ply. It runs on the card unless
`--device cpu` is passed; without a GPU the default raises.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from . import add_model_flags, load_trained


def main(argv=None):
    """Export the timesteps the flags ask for; returns {timestep: (vertex
    count, seconds)}."""
    p = argparse.ArgumentParser()
    add_model_flags(p)
    p.add_argument("--start_timestep_index", type=int, default=0)
    p.add_argument("--end_timestep_index", type=int, default=1)
    p.add_argument("--scale_factor", type=float, default=1.5)
    p.add_argument("--opacity_threshold", type=float, default=0.01)
    p.add_argument("--random_colors", action="store_true")
    args = p.parse_args(argv)

    import torch

    from ..core.sh import sh_to_rgb_dc
    from ..data.ply import write_mesh_ply
    from ..device import resolve_device
    from ..mesh.extract import deformed_gaussians
    from ..mesh.gaussians_viz import gaussians_to_mesh

    device = resolve_device(args.device)
    cfg, scene, dparams = load_trained(args, device)
    hidden = cfg.hidden
    alive = scene.aux.alive

    done = {}
    for ts in range(args.start_timestep_index, args.end_timestep_index):
        t0 = time.perf_counter()
        with torch.no_grad():
            xyz, scales_f, rot_raw, opac_f, shs_f = deformed_gaussians(
                scene.params, scene.aux, dparams, hidden, ts / scene.maxtime,
                hidden.min_embeddings, scene.loaded_iter or 10 ** 9)
        colors = sh_to_rgb_dc(shs_f[:, 0, :])
        verts, faces, vcols = gaussians_to_mesh(
            xyz[alive], scales_f[alive], rot_raw[alive], colors[alive], opac_f[alive],
            scale_factor=args.scale_factor, opacity_threshold=args.opacity_threshold,
            random_colors=args.random_colors)
        out = os.path.join(cfg.model.model_path, "gaussian_meshes", f"{ts:05d}.ply")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        write_mesh_ply(out, verts, faces, vcols)
        done[ts] = (len(verts), time.perf_counter() - t0)
        print(f"timestep {ts}: {len(verts)} verts -> {out}", flush=True)
    return done


if __name__ == "__main__":
    main()
    sys.exit(0)

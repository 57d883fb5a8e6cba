"""Interactive viewer server CLI (port of ed3dgs_tpu/tools/viewer.py): serve
renders of a checkpoint over the SIBR remote-viewer socket protocol
(render/network_gui.py).

Usage:
  python -m ed3dgs_torch.tools.viewer -m <model_dir> -s <scene_dir> \
      [--ip 127.0.0.1] [--port 6009] [--time 0.0]

Each request renders through `render()` (K1, K4 and K5a on the card) at
the request's resolution, any width and height; the raster setup of each
resolution is made at its first request, with the focals of that
request's fovs, and a later request at that size with other fovs keeps
them, as the JAX tool does (ROADMAP Queue 3). On the card each resolution's
render is a CUDA graph captured at its first request and replayed
(tools.FrameRenderer), as the JAX tool jits one per resolution. It runs
on the card unless `--device cpu` is passed; without a GPU the default
raises.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from . import FrameRenderer, add_model_flags, load_trained


def make_handler(cfg, scene, dparams, time: float = 0.0):
    """handle(camera dict from `ViewerServer.read_request`) -> the render
    [3, H, W] on the model's device, at timeline position `time`: on the
    card a CUDA graph captured per resolution and replayed."""
    import torch

    from ..ops.rasterize import RasterConfig

    device = scene.params.xyz.device
    bg = torch.ones(3, dtype=torch.float32, device=device)
    model, hidden = cfg.model, cfg.hidden
    frame = FrameRenderer(hidden, bg, sh_degree=model.sh_degree,
                          kernel_size=model.kernel_size,
                          disable_filter3d=model.disable_filter3D,
                          num_down_emb=hidden.min_embeddings)
    trained = (scene.params, scene.aux, dparams)
    configs = {}

    def handle(cam):
        key = (cam["width"], cam["height"])
        if key not in configs:
            w, h = key
            configs[key] = RasterConfig(width=w, height=h,
                                        focal_x=w / (2 * np.tan(cam["fovx"] / 2)),
                                        focal_y=h / (2 * np.tan(cam["fovy"] / 2)),
                                        pair_capacity=cfg.opt.pair_capacity,
                                        chunk=cfg.opt.raster_chunk)
        wv = cam["world_view"]
        # the frame's own tensor: the next request at this size replays into it
        return frame(key, trained, configs[key], wv, cam["full_proj"],
                     np.linalg.inv(wv)[:3, 3], time)["render"].clone()
    return handle


def main(argv=None):
    p = argparse.ArgumentParser()
    add_model_flags(p)
    p.add_argument("--ip", default="127.0.0.1")
    p.add_argument("--port", type=int, default=6009)
    p.add_argument("--time", type=float, default=0.0,
                   help="timeline position to render")
    args = p.parse_args(argv)

    from ..device import resolve_device
    from ..render.network_gui import ViewerServer

    cfg, scene, dparams = load_trained(args, resolve_device(args.device))
    handle = make_handler(cfg, scene, dparams, args.time)
    server = ViewerServer(args.ip, args.port)
    print(f"viewer server on {args.ip}:{args.port}", flush=True)
    try:
        server.serve_forever(handle, verify=cfg.model.model_path)
    finally:
        server.close()


if __name__ == "__main__":
    sys.exit(main())

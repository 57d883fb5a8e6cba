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
them, as the JAX tool does (ROADMAP Queue 3). It runs on the card unless
`--device cpu` is passed; without a GPU the default raises.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from . import add_model_flags, load_trained, render_eval


def make_handler(cfg, scene, dparams, time: float = 0.0):
    """handle(camera dict from `ViewerServer.read_request`) -> the render
    [3, H, W] on the model's device, at timeline position `time`."""
    import torch

    from ..ops.rasterize import RasterConfig
    from ..render import RenderSettings

    device = scene.params.xyz.device
    f32 = dict(dtype=torch.float32, device=device)
    bg = torch.ones(3, **f32)
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
        s = RenderSettings(torch.as_tensor(wv, **f32), torch.as_tensor(cam["full_proj"], **f32),
                           torch.as_tensor(np.linalg.inv(wv)[:3, 3], **f32),
                           torch.tensor(time, **f32), None)
        return render_eval(cfg, scene, dparams, s, configs[key], bg)["render"]
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

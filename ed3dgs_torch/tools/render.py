"""Rendering CLI (port of ed3dgs_tpu/tools/render.py; the reference render.py).

Usage:
  python -m ed3dgs_torch.tools.render -m <model_dir> [-s <scene_dir>] \
      [--configs cfg.py] [--iteration N] [--skip_train] [--max_frames N] ...

Renders the train/test/video camera sets of a saved model (either
package's `point_cloud/iteration_N/`): RGB, depth, Phong-shaded normal
maps, tongue masks and, with `--tongue_renders`, the tongue / no-tongue
subset renders (render.py:30-121), into
`<model>/<split>/ours_<iter>/{renders,gt,depth,normal,tongue}`, with an FPS
line per split and a video of the renders. The PNGs are the JAX tool's,
quantised as it does (clip to [0, 1], then truncate `x * 255` to uint8),
and written by the port's own encoder (data/image_io.py).

It runs on the card unless `--device cpu` is passed; without a GPU the
default raises. On the card each frame replays a CUDA graph captured for
its tongue filter (tools.FrameRenderer), as the JAX tool jits one render
per filter. `--backend` is accepted for the JAX tool's command lines and
ignored: the port has one backend. The video goes through imageio, else
Pillow (an animated GIF); where neither is installed it is skipped with a
line that says so (the JAX tool raises ImportError there).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from . import FrameRenderer, add_model_flags, load_trained


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ed3dgs_torch renderer")
    add_model_flags(p)
    p.add_argument("--skip_train", action="store_true")
    p.add_argument("--skip_test", action="store_true")
    p.add_argument("--skip_video", action="store_true")
    p.add_argument("--tongue_renders", action="store_true")
    p.add_argument("--backend", default="auto",
                   help="accepted for the JAX tool's command lines and ignored: the port "
                        "has one backend")
    p.add_argument("--max_frames", type=int, default=0,
                   help="cap rendered frames per split (0 = all)")
    return p.parse_args(argv)


def phong_shade(normal_img: np.ndarray) -> np.ndarray:
    """Phong-shaded normal visualization (reference phong_reflection,
    render.py:140-179): headlight diffuse+specular on the normal map."""
    n = normal_img  # [3, H, W], camera space
    light = np.array([0.0, 0.0, -1.0])
    ndotl = np.clip(-(n[0] * light[0] + n[1] * light[1] + n[2] * light[2]), 0, 1)
    ambient, diffuse, spec_pow = 0.1, 0.7, 16
    spec = np.clip(ndotl, 0, 1) ** spec_pow * 0.2
    shade = ambient + diffuse * ndotl + spec
    return np.clip(np.stack([shade] * 3), 0, 1)


def save_img(path, chw, clip=True):
    """[C, H, W] / [H, W] floats -> 8-bit PNG, as the JAX tool quantises:
    clip to [0, 1], then truncate x * 255."""
    from ..data.image_io import write_png

    arr = np.asarray(chw)
    if arr.ndim == 3:
        arr = arr.transpose(1, 2, 0)
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[..., 0]
    if clip:
        arr = np.clip(arr, 0, 1)
    write_png(path, (arr * 255).astype(np.uint8))


def export_video(frame_dir: str, out_path: str, fps: int = 30):
    """mp4 via imageio if available, else an animated GIF through Pillow;
    with neither installed, no video and one line that says so."""
    import glob
    frames = sorted(glob.glob(os.path.join(frame_dir, "*.png")))
    if not frames:
        return
    try:
        import imageio.v2 as imageio
        with imageio.get_writer(out_path, fps=fps) as w:
            for fpath in frames:
                w.append_data(imageio.imread(fpath))
        return
    except Exception:
        pass
    try:
        from PIL import Image
    except ImportError:
        print(f"{out_path}: no video written (neither imageio nor Pillow is installed)",
              flush=True)
        return
    imgs = [Image.open(f) for f in frames]
    gif = out_path.rsplit(".", 1)[0] + ".gif"
    imgs[0].save(gif, save_all=True, append_images=imgs[1:],
                 duration=int(1000 / fps), loop=0)


def render_set(out_dir, name, cams, renderer, tongue_renders=False, max_frames=0):
    """Render and save one split. Each render is timed after a synchronise
    of its device, so that the FPS line times the render and not the
    host's enqueue (the JAX tool blocks on the render). Returns the split's
    frames, FPS (frames after the first), and each frame's render ms and
    PNG-save ms (host clock)."""
    import torch

    renders_dir = os.path.join(out_dir, name, "renders")
    gt_dir = os.path.join(out_dir, name, "gt")
    extra_dirs = {k: os.path.join(out_dir, name, k)
                  for k in ("depth", "normal", "tongue")}
    for d in [renders_dir, gt_dir, *extra_dirs.values()]:
        os.makedirs(d, exist_ok=True)

    if max_frames:
        cams = cams[:max_frames]
    t_total = 0.0
    render_ms, save_ms = [], []
    fps = None
    for i, cam in enumerate(cams):
        t0 = time.time()
        out = renderer(cam)
        if out["render"].is_cuda:
            torch.cuda.synchronize(out["render"].device)
        dt = time.time() - t0
        render_ms.append(dt * 1e3)
        if i > 0:
            t_total += dt
        t1 = time.time()
        fname = f"{i:05d}.png"
        save_img(os.path.join(renders_dir, fname), out["render"].cpu().numpy())
        d = out["expected_depth"].cpu().numpy()[0]
        dmax = d.max() or 1.0
        save_img(os.path.join(extra_dirs["depth"], fname), d / dmax)
        save_img(os.path.join(extra_dirs["normal"], fname),
                 phong_shade(out["normal"].cpu().numpy()))
        save_img(os.path.join(extra_dirs["tongue"], fname),
                 out["tongue_mask"].cpu().numpy()[0])
        gt = cam.image
        if gt is not None:
            save_img(os.path.join(gt_dir, fname), gt)
        cam.release_image()
        if tongue_renders:
            for mode, sub in (("only", "tongue_render"), ("without", "wo_tongue_render")):
                sub_dir = os.path.join(out_dir, name, sub)
                os.makedirs(sub_dir, exist_ok=True)
                save_img(os.path.join(sub_dir, fname),
                         renderer(cam, tongue_filter=mode)["render"].cpu().numpy())
        save_ms.append((time.time() - t1) * 1e3)
    if len(cams) > 1:
        fps = (len(cams) - 1) / max(t_total, 1e-9)
        print(f"{name}: {fps:.2f} FPS", flush=True)
    export_video(renders_dir, os.path.join(out_dir, name, "video.mp4"))
    return {"frames": len(cams), "fps": fps, "render_ms": render_ms, "save_ms": save_ms}


def main(argv=None):
    """Render the splits the flags ask for; returns {split: render_set's
    numbers}."""
    args = parse_args(argv)
    import torch

    from ..device import resolve_device
    from ..ops.rasterize import RasterConfig

    device = resolve_device(args.device)
    cfg, scene, dparams = load_trained(args, device)
    model, hidden, opt = cfg.model, cfg.hidden, cfg.opt
    trained = (scene.params, scene.aux, dparams)

    cam0 = (scene.test_cameras or scene.train_cameras)[0].matrices()
    rcfg = RasterConfig(width=cam0.width, height=cam0.height,
                        focal_x=cam0.focal_x, focal_y=cam0.focal_y,
                        pair_capacity=opt.pair_capacity, chunk=opt.raster_chunk)
    bg = torch.full((3,), 1.0 if model.white_background else 0.0, dtype=torch.float32,
                    device=device)
    # one graph per tongue filter, as the JAX tool jits one render per filter
    frame = FrameRenderer(hidden, bg, sh_degree=model.sh_degree,
                          kernel_size=model.kernel_size,
                          disable_filter3d=model.disable_filter3D,
                          num_down_emb=hidden.min_embeddings)

    def renderer(cam, tongue_filter=None):
        m = cam.matrices()
        return frame(tongue_filter or "full", trained, rcfg, m.world_view, m.full_proj,
                     m.campos, cam.time, tongue_filter=tongue_filter)

    # reference directory layout: <model_path>/<split>/ours_<iter>/{renders,gt}
    out_dir = model.model_path
    it = scene.loaded_iter
    stats = {}
    if not args.skip_train:
        stats["train"] = render_set(
            out_dir, f"train/ours_{it}",
            sorted(scene.train_cameras, key=lambda c: (c.cam_no, c.frame_no)),
            renderer, args.tongue_renders, args.max_frames)
    if not args.skip_test:
        stats["test"] = render_set(
            out_dir, f"test/ours_{it}",
            sorted(scene.test_cameras, key=lambda c: (c.cam_no, c.frame_no)),
            renderer, args.tongue_renders, args.max_frames)
    if not args.skip_video and scene.video_cameras:
        stats["video"] = render_set(out_dir, f"video/ours_{it}", scene.video_cameras,
                                    renderer, False, args.max_frames)
    return stats


if __name__ == "__main__":
    main()
    sys.exit(0)

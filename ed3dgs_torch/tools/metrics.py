"""Image metrics CLI (port of ed3dgs_tpu/tools/metrics.py; the reference
metrics.py).

Usage:
  python -m ed3dgs_torch.tools.metrics -m <model_dir> [...] [--split test]

Walks <model_path>/<split>/ours_<iter>/{renders,gt}, computes per-image PSNR,
SSIM and (when pretrained weights are locally available) LPIPS, and writes
results.json / per_view.json in the reference's format (metrics.py:37-101),
key for key as the JAX tool writes them. PNGs are read by the port's own
decoder; PSNR and SSIM are the training losses' (train/losses.py, cuDNN's
TF32 off) on the 8-bit values in float64; LPIPS is utils/lpips.py on the
weights the JAX package would use, reported as null where there are none.

It runs on the card unless `--device cpu` is passed; without a GPU the
default raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def load_image(path):
    from ..data.image_io import read_png
    return np.asarray(read_png(path), np.float32)[..., :3] / 255.0


def compute_lpips(renders, gts, net="vgg", device="cpu"):
    """Per-image LPIPS, or None where no converted weights are present."""
    from ..utils.lpips import load_lpips
    model = load_lpips(net, device=device)
    if model is None:
        return None
    vals = []
    for r, g in zip(renders, gts):
        vals.append(float(model(r.transpose(2, 0, 1)[None],
                                g.transpose(2, 0, 1)[None])[0]))
    return vals


def evaluate(model_paths, split="test", device="cuda"):
    """Score every method directory of each model path; returns
    {model_path: results} (what results.json holds)."""
    import torch

    from ..device import resolve_device
    from ..train.losses import psnr as psnr_fn
    from ..train.losses import ssim as ssim_fn

    device = resolve_device(device)
    scores = {}
    for model_path in model_paths:
        results, per_view = {}, {}
        split_dir = os.path.join(model_path, split)
        if not os.path.isdir(split_dir):
            print(f"no {split} renders in {model_path}")
            continue
        for method in sorted(os.listdir(split_dir)):
            rdir = os.path.join(split_dir, method, "renders")
            gdir = os.path.join(split_dir, method, "gt")
            if not (os.path.isdir(rdir) and os.path.isdir(gdir)):
                continue
            names = sorted(os.listdir(rdir))
            names = [n for n in names if os.path.exists(os.path.join(gdir, n))]
            renders = [load_image(os.path.join(rdir, n)) for n in names]
            gts = [load_image(os.path.join(gdir, n)) for n in names]
            psnrs, ssims = [], []
            # float64: the CPU's float32 depthwise convolution misses the
            # exact SSIM by ~1e-5, the JAX tool's by ~3e-7
            f64 = torch.float64
            with torch.no_grad():
                for r, g in zip(renders, gts):
                    rc = torch.as_tensor(r.transpose(2, 0, 1), dtype=f64, device=device)[None]
                    gc = torch.as_tensor(g.transpose(2, 0, 1), dtype=f64, device=device)[None]
                    psnrs.append(float(psnr_fn(rc, gc)[0]))
                    ssims.append(float(ssim_fn(rc, gc)))
            lp = compute_lpips(renders, gts, "vgg", device)
            lpa = compute_lpips(renders, gts, "alex", device)
            entry = {
                "PSNR": float(np.mean(psnrs)) if psnrs else None,
                "SSIM": float(np.mean(ssims)) if ssims else None,
                "LPIPS-vgg": float(np.mean(lp)) if lp else None,
                "LPIPS-alex": float(np.mean(lpa)) if lpa else None,
            }
            results[method] = entry
            per_view[method] = {
                "PSNR": dict(zip(names, psnrs)),
                "SSIM": dict(zip(names, ssims)),
                "LPIPS-vgg": dict(zip(names, lp)) if lp else {},
                "LPIPS-alex": dict(zip(names, lpa)) if lpa else {},
            }
            print(model_path, method, {k: (round(v, 4) if v else v)
                                       for k, v in entry.items()}, flush=True)
        with open(os.path.join(model_path, "results.json"), "w") as f:
            json.dump(results, f, indent=2)
        with open(os.path.join(model_path, "per_view.json"), "w") as f:
            json.dump(per_view, f, indent=2)
        scores[model_path] = results
    return scores


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_paths", "-m", nargs="+", required=True)
    p.add_argument("--split", default="test")
    p.add_argument("--device", default="cuda",
                   help="torch device to score on (default: the GPU)")
    args = p.parse_args(argv)
    return evaluate(args.model_paths, args.split, args.device)


if __name__ == "__main__":
    main()
    sys.exit(0)

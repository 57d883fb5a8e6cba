"""The train PSNR of tools.train on a tongue scene, with and without the
tongue terms.

Usage:
    python3 scripts/torch_tongue_psnr.py [--iterations 400] [--window 50] [--out FILE]

Generates chip_smoke.py's tongue scene on the card (`generate_scene` with
its cli phase's cameras, frames and points and tongue_frac 0.1) and trains
it through `ed3dgs_torch.tools.train.main` three times at full width with
chip_smoke.py's TONGUE_CLI_SET schedule: configs/nersemble/tongue.py, the
same with `tongue_mask_loss_enabled=false`, and configs/nersemble/default.py.
Prints for each run the mean train PSNR and loss of every `--window`
iterations, the test PSNRs, the densify events and, with the tongue terms,
each term's window means. The last line is one JSON object. Needs one CUDA
device.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iterations", type=int, default=400)
    ap.add_argument("--window", type=int, default=50)
    ap.add_argument("--out", default=None, help="also write the JSON object here")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from ed3dgs_torch.data.synthetic import generate_scene
    from ed3dgs_torch.tools import train as train_tool

    def windows(xs):
        xs = np.asarray(xs, np.float64)
        return [float(xs[i:i + args.window].mean()) for i in range(0, len(xs), args.window)]

    runs = (("tongue", "tongue.py", []),
            ("tongue_terms_off", "tongue.py", ["tongue_mask_loss_enabled=false"]),
            ("default", "default.py", []))
    result = {"card": cs.card_line()}
    print(result["card"], flush=True)
    with tempfile.TemporaryDirectory(prefix="ed3dgs_tongue_psnr_") as tmp:
        scene = os.path.join(tmp, "scene")
        generate_scene(scene, n_cams=cs.CLI_CAMS, n_frames=cs.CLI_FRAMES, width=cs.WIDTH,
                       height=cs.HEIGHT, n_points=cs.CLI_POINTS, seed=1,
                       tongue_frac=cs.TONGUE_FRAC, device="cuda")
        for name, cfg, extra in runs:
            t0 = time.perf_counter()
            _, _, _, log = train_tool.main(
                ["-s", scene, "-m", os.path.join(tmp, name), "--configs",
                 os.path.join(REPO, "configs", "nersemble", cfg), "--duration",
                 str(cs.CLI_FRAMES), "--test_every", str(args.window), "--quiet", "--seed", "0",
                 "--iterations", str(args.iterations), "--no_tensorboard",
                 "--set", *cs.TONGUE_CLI_SET, *extra])
            run = dict(seconds=time.perf_counter() - t0, psnr=windows(log["psnr"]),
                       loss=windows(log["loss"]),
                       test_psnr=[(int(i), float(v)) for i, v in log["test_psnr"]],
                       densify=log["densify"])
            for k in train_tool.TONGUE_TERMS:
                if k in log:
                    run[k] = windows(log[k])
            result[name] = run
            print(f"{name}: " + ", ".join(f"{k}={v}" for k, v in run.items()), flush=True)
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()

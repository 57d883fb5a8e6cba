"""Count the host-device waits of the eager train step and of a frame.

Usage:
    python3 scripts/torch_step_waits.py [--tree DIR] [--out FILE]

Builds chip_smoke.py's main-path train step (configs/nersemble/default.py at
full width, the bench cloud of 100,000 Gaussians in a capacity of 100,352,
802x550, the config's batch, reg_coef 1) with the ed3dgs_torch package of
DIR (default: this checkout; another tree, such as a parent commit unpacked
by `git archive`, is imported instead), takes one warm-up step, then runs
one step with SSIM off, one with SSIM on and one `render()` of the bench
frame under `torch.cuda.set_sync_debug_mode("warn")`. Every warning that
mode raises is a call that made the host wait for the card (a synchronise,
a read of a device value, a copy from pageable host memory). Each is
reported with the innermost frame of the package that made it and the
frame's own caller, counted by place. Then one step runs under mode
"error" with autograd's anomaly mode: the first wait raises, and where it
is in the backward pass, anomaly mode names the forward call of the node
that waited. The eager step is asked for with `graph=False` where
`make_train_step` takes that argument.

It also reports whether a float32 CUDA tensor divided by a 0-d CPU float32
tensor equals the same tensor multiplied by the divisor's float32
reciprocal, bit for bit, and whether it equals the division by the same
divisor on the card: the Adam update divides by its bias corrections that
way. The last line is one JSON object. Needs one CUDA device.
"""

import argparse
import collections
import importlib.util
import inspect
import json
import os
import sys
import traceback
import warnings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_smoke():
    """chip_smoke.py of this checkout (its cloud, camera, setup and batch
    helpers), by path: another tree first on sys.path has its own."""
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def count_waits(torch, fn, pkg):
    """Run fn under sync debug mode "warn"; returns [(place, message)] for
    every wait, the place being the package's innermost frame and its
    caller."""
    waits = []

    def hook(message, category, filename, lineno, file=None, line=None):
        frames = [f for f in traceback.extract_stack()[:-1] if f.filename.startswith(pkg)]
        where = " <- ".join(f"{os.path.relpath(f.filename, os.path.dirname(pkg))}:{f.lineno}"
                            f" ({f.name})" for f in frames[::-1][:2])
        waits.append((where or f"{filename}:{lineno}", str(message).splitlines()[0]))

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return waits


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=REPO, help="checkout whose ed3dgs_torch is measured")
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    smoke = load_smoke()

    import ed3dgs_torch
    from ed3dgs_torch.config.loader import load_full_config
    from ed3dgs_torch.convert import gaussians_from_numpy
    from ed3dgs_torch.models.gaussians import compute_3d_filter
    from ed3dgs_torch.models.deformation import init_deform_params
    from ed3dgs_torch.ops import cuda_lib
    from ed3dgs_torch.render import raster_config_from_camera, render, settings_from_camera
    from ed3dgs_torch.train.trainer import (KNN_CAPS_DEFAULT, init_train_state,
                                            make_train_step, refresh_knn_cache)
    pkg = os.path.dirname(os.path.abspath(ed3dgs_torch.__file__))
    if os.path.dirname(pkg) != tree:
        sys.exit(f"imported {pkg}, not the package of {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smoke.card_line()
    print(f"{card}; ed3dgs_torch from {pkg}", flush=True)
    cuda_lib.build()

    dev = "cuda"
    cfg = load_full_config(os.path.join(tree, "configs", "nersemble", "default.py"))
    model, hidden, opt = cfg.model, cfg.hidden, cfg.opt
    fields = smoke.bench_cloud(smoke.N_GAUSS)
    params, aux = gaussians_from_numpy(fields, capacity=smoke.CAPACITY, device=dev)
    cam = smoke.bench_camera(smoke.WIDTH, smoke.HEIGHT)
    rcfg = raster_config_from_camera(cam, pair_capacity=smoke.PAIR_CAPACITY,
                                     chunk=opt.raster_chunk)
    fargs, extent = smoke.filter_cameras(torch, dev)
    aux = aux._replace(filter_3d=compute_3d_filter(params.xyz, aux.alive, *fargs))
    knn_cache = refresh_knn_cache(params, aux, dict(KNN_CAPS_DEFAULT),
                                  coverage_target=opt.knn_coverage_target)
    setup = smoke.train_setup(cfg, rcfg)
    B = setup.batch_size
    state, optimizer = init_train_state(params, hidden, opt, extent, seed=0)
    state = state._replace(iteration=smoke.TRAIN_ITERATION)
    kw = ({"graph": False} if "graph" in inspect.signature(make_train_step).parameters
          else {})
    step = make_train_step(setup, optimizer, **kw)
    state, taux, _ = step(state, aux, smoke.make_batch(torch, cam, B, 0.05, True, 99, dev),
                          knn_cache)

    result = {"card": card, "tree": tree}
    for name, ssim in (("step_ssim_off", False), ("step_ssim_on", True)):
        batch = smoke.make_batch(torch, cam, B, 0.3, ssim, 100, dev)
        waits = count_waits(torch, lambda: step(state, taux, batch, knn_cache), pkg)
        by_place = collections.Counter(w for w, _ in waits)
        print(f"{name}: {len(waits)} waits", flush=True)
        for place, n in by_place.most_common():
            print(f"  {n:3d} x {place}", flush=True)
        result[name] = dict(waits=len(waits), by_place=dict(by_place),
                            messages=sorted({m for _, m in waits}))

    # the first wait of a step under sync debug mode "error", with autograd's
    # anomaly mode naming the forward call of a backward node that waits
    batch = smoke.make_batch(torch, cam, B, 0.3, True, 100, dev)
    first = {"error": None, "forward_of_backward": None}
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.autograd.detect_anomaly(check_nan=False):
                step(state, taux, batch, knn_cache)
        except RuntimeError as e:
            first["error"] = "".join(traceback.format_exception(e)[-6:])
        finally:
            torch.cuda.set_sync_debug_mode(0)
    for w in caught:
        if "Traceback of forward call" in str(w.message):
            first["forward_of_backward"] = str(w.message)[-1500:]
    torch.cuda.synchronize()
    print(f"first wait under mode error: {first['error']}\nforward of the backward node: "
          f"{first['forward_of_backward']}", flush=True)
    result["first_wait"] = first

    dparams = init_deform_params(hidden, seed=0, device=dev)
    bg = torch.full((3,), 1.0 if model.white_background else 0.0, device=dev)

    def frame():
        with torch.no_grad():
            render(params, aux, dparams, hidden, settings_from_camera(cam, time=0.5, device=dev),
                   rcfg, bg, iteration=10 ** 9, sh_degree=model.sh_degree,
                   kernel_size=model.kernel_size, disable_filter3d=model.disable_filter3D,
                   num_down_emb_c=hidden.min_embeddings, num_down_emb_f=hidden.min_embeddings)
    frame()
    waits = count_waits(torch, frame, pkg)
    by_place = collections.Counter(w for w, _ in waits)
    print(f"frame: {len(waits)} waits", flush=True)
    for place, n in by_place.most_common():
        print(f"  {n:3d} x {place}", flush=True)
    result["frame"] = dict(waits=len(waits), by_place=dict(by_place))

    # the Adam update's division by a 0-d CPU float32 tensor, on the card
    g = torch.Generator().manual_seed(0)
    x = (torch.rand(1 << 20, generator=g) * 10 - 5).to(dev)
    bc = torch.tensor(1 - 0.999 ** 3, dtype=torch.float32)
    by_cpu = x / bc
    by_recip = x * (1.0 / bc).item()
    by_card = x / bc.to(dev)
    result["div_cpu_scalar"] = dict(
        equals_reciprocal_multiply=bool(torch.equal(by_cpu, by_recip)),
        equals_division_on_card=bool(torch.equal(by_cpu, by_card)))
    print(f"x / cpu scalar: equals x * float32(1/d) {result['div_cpu_scalar']}", flush=True)
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()

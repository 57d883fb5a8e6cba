"""The port's command-line tools. `load_trained` is the model loading the
offline tools share: the config with the command line's overrides, the
scene's saved Gaussians and its deformation network, on `device`."""

from __future__ import annotations

import json
import os


def config_overrides(args) -> dict:
    """The paths and loader the flags give, then each `--set KEY=VALUE`
    (a JSON value where it parses as one, else the string)."""
    overrides = {k: v for k, v in {
        "source_path": args.source_path, "model_path": args.model_path,
        "loader": args.loader}.items() if v is not None}
    for kv in args.set:
        k, v = kv.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v
    return overrides


def load_trained(args, device):
    """(cfg, scene, deformation parameters) of the saved model the flags
    name (`--iteration`, -1 for the latest)."""
    from ..config.loader import load_full_config
    from ..convert import deform_from_flat
    from ..data.scene import Scene, read_deformation

    cfg = load_full_config(args.configs, config_overrides(args))
    scene = Scene(cfg.model, cfg.hidden, capacity=cfg.opt.max_number_gaussians,
                  duration=args.duration, load_iteration=args.iteration,
                  shuffle=False, device=device)
    dparams = deform_from_flat(read_deformation(os.path.join(
        cfg.model.model_path, "point_cloud", f"iteration_{scene.loaded_iter}")), device=device)
    return cfg, scene, dparams


def add_model_flags(p) -> None:
    """The flags every model-loading tool takes."""
    p.add_argument("--model_path", "-m", required=True)
    p.add_argument("--source_path", "-s", default=None)
    p.add_argument("--configs", default=None)
    p.add_argument("--iteration", type=int, default=-1)
    p.add_argument("--loader", default=None)
    p.add_argument("--duration", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the GPU; 'cpu' runs the "
                        "kernels' plain versions)")
    p.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE")


def render_eval(cfg, scene, dparams, settings, rcfg, bg):
    """`render()` as the offline tools call it, without gradients: every
    schedule done (iteration 10**9) and the fewest embeddings."""
    import torch

    from ..render import render

    model, hidden = cfg.model, cfg.hidden
    with torch.no_grad():
        return render(scene.params, scene.aux, dparams, hidden, settings, rcfg, bg,
                      iteration=10 ** 9, sh_degree=model.sh_degree,
                      kernel_size=model.kernel_size, disable_filter3d=model.disable_filter3D,
                      num_down_emb_c=hidden.min_embeddings,
                      num_down_emb_f=hidden.min_embeddings)

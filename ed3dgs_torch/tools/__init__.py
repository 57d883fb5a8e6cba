"""The port's command-line tools. `load_trained` is the model loading the
offline tools share: the config with the command line's overrides, the
scene's saved Gaussians and its deformation network, on `device`.
`FrameRenderer` is the frame the serving tools and the trainer's test
render run: `render()` as a CUDA graph captured per key."""

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


# the render() outputs a FrameRenderer returns
FRAME_OUTPUTS = ("render", "mask", "expected_coord", "median_coord", "expected_depth",
                 "median_depth", "normal", "tongue_mask", "num_pairs", "tile_overflow",
                 "radii", "visibility_filter")


class FrameRenderer:
    """`render()` of one camera without gradients, run on the card as a
    CUDA graph captured per key and replayed (the JAX tools' jit per key,
    ed3dgs_tpu/tools/render.py:165-182, viewer.py:58-84, train.py:465-480).

    Call it with the host values of a camera: `(key, model, rcfg,
    world_view, full_proj, campos, time, iteration=10**9, cam_no=None,
    tongue_filter=None)`, model = (params, aux, deformation parameters).
    The key is the caller's (a tongue filter, a resolution, a raster
    config); the graph's key adds the raster config, the tongue filter and
    whether a camera id is given. The camera's matrices, centre, time and
    the iteration the deformation reads are written into static buffers
    through pinned memory before each replay, and the model is copied into
    static buffers on the card at each call (a model of other shapes gets
    new buffers, and the graphs of the old ones go). It returns
    FRAME_OUTPUTS as static tensors that the next call with the same key
    overwrites: a caller that keeps one clones it.

    On the CPU, or with graph=False, it renders eagerly (the same outputs,
    fresh tensors).

    Each call is the tracer's host span "frame" (children "scalars",
    "copy_in", "launch"; its call id the renderer's frame number) and its
    render the device region "frame" (utils/trace.py)."""

    def __init__(self, hidden, bg, *, sh_degree, kernel_size, disable_filter3d,
                 num_down_emb, graph=True):
        self.hidden, self.bg = hidden, bg
        self.kw = dict(sh_degree=sh_degree, kernel_size=kernel_size,
                       disable_filter3d=disable_filter3d, num_down_emb_c=num_down_emb,
                       num_down_emb_f=num_down_emb)
        self.graph = graph
        self.graphs = None
        self._inputs = None         # PinnedScalars: view 16, proj 16, campos 3, time, iteration
        self._cam_no = None
        self._model = None          # {path: static tensor}: the model's copy
        self.frames = 0             # calls so far: the frame's number

    def __call__(self, key, model, rcfg, world_view, full_proj, campos, time,
                 iteration=10 ** 9, cam_no=None, tongue_filter=None) -> dict:
        from ..utils import trace
        self.frames += 1
        with trace.span("frame", call=self.frames) as sp:
            return self._frame(sp, key, model, rcfg, world_view, full_proj, campos, time,
                               iteration, cam_no, tongue_filter)

    def _frame(self, sp, key, model, rcfg, world_view, full_proj, campos, time, iteration,
               cam_no, tongue_filter) -> dict:
        import numpy as np
        import torch

        from ..render import RenderSettings, render
        from ..utils import trace
        params, aux, dparams = model
        dev = params.xyz.device
        f32 = dict(dtype=torch.float32, device=dev)
        if dev.type != "cuda" or not self.graph:
            s = RenderSettings(torch.as_tensor(np.asarray(world_view), **f32),
                               torch.as_tensor(np.asarray(full_proj), **f32),
                               torch.as_tensor(np.asarray(campos), **f32),
                               torch.tensor(float(time), **f32),
                               None if cam_no is None else torch.tensor(cam_no, device=dev))
            with torch.no_grad(), trace.region("frame", dev):
                out = render(params, aux, dparams, self.hidden, s, rcfg, self.bg,
                             iteration=iteration, tongue_filter=tongue_filter, **self.kw)
            return {k: out[k] for k in FRAME_OUTPUTS}

        from ..train.optim import flatten_params, unflatten_params
        from ..utils.graphs import GraphCache, PinnedScalars, copy_in
        gkey = (key, rcfg, tongue_filter, cam_no is not None)
        sp.replayed = self.graphs is not None and gkey in self.graphs
        with trace.span("scalars"):
            if self.graphs is None:
                self.graphs = GraphCache(dev, "frame")
                self._inputs = PinnedScalars(37, dev)
                self._cam_no = torch.zeros((), dtype=torch.int64, device=dev)
            host = np.concatenate([np.asarray(world_view, np.float32).ravel(),
                                   np.asarray(full_proj, np.float32).ravel(),
                                   np.asarray(campos, np.float32).ravel(),
                                   np.float32([time, iteration])])
            self._inputs.write(torch.from_numpy(host))
            if cam_no is not None:
                self._cam_no.fill_(int(cam_no))
        with trace.span("copy_in"):
            flat = flatten_params({"gaussians": params, "deform": dparams})
            flat.update({f"aux/{f}": getattr(aux, f) for f in aux._fields})
            if self._model is None or any(self._model[k].shape != t.shape
                                          for k, t in flat.items()):
                self._model = {k: torch.empty_like(t) for k, t in flat.items()}
                self.graphs.clear()
                sp.replayed = False
            nbytes = sum(copy_in(self._model[k], t) for k, t in flat.items())
            trace.count("copy_in_bytes", "frame", nbytes)
            trace.count("copy_in_calls", "frame")
        with trace.span("launch"):
            flat = self._model
            v = self._inputs.values
            static_cam = None if cam_no is None else self._cam_no
            tree = unflatten_params({k: t for k, t in flat.items() if not k.startswith("aux/")})
            static_aux = aux._replace(**{f: flat[f"aux/{f}"] for f in aux._fields})

            def body():
                s = RenderSettings(v[:16].view(4, 4), v[16:32].view(4, 4), v[32:35], v[35],
                                   static_cam)
                with torch.no_grad(), trace.region("frame", dev):
                    out = render(tree["gaussians"], static_aux, tree["deform"], self.hidden, s,
                                 rcfg, self.bg, iteration=v[36], tongue_filter=tongue_filter,
                                 **self.kw)
                return {k: out[k] for k in FRAME_OUTPUTS}
            return self.graphs.run(gkey, body)

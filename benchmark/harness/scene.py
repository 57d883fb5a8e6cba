"""The inputs of a cell, made from the seed: the camera rig, the Gaussian
cloud and the deformation network's weights (on the card, by a
torch.Generator, in a few large calls), the training targets (rendered by
the plain reference) and the order of the serving requests.

Everything here is the benchmark's: it hands the same inputs to the
program and to the reference.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from reference import camera_math
from reference.gaussians import GaussianAux, GaussianParams

HEADS = {"pos": 3, "scale": 3, "rot": 4, "opacity": 1, "sh": 48}


def look_at(eye, target, up, fovx, width, height):
    """{world_view, full_proj, campos, focal_x, focal_y, width, height} of a camera at
    `eye` looking at `target` (OpenCV axes: +z into the screen)."""
    eye, target, up = (np.asarray(v, np.float64) for v in (eye, target, up))
    fwd = (target - eye) / np.linalg.norm(target - eye)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=1)
    fovy = 2 * math.atan(math.tan(fovx / 2) * height / width)
    w2v = camera_math.world_to_view(R, -R.T @ eye)
    proj = camera_math.projection_matrix(0.01, 100.0, fovx, fovy)
    return dict(world_view=w2v, full_proj=(proj @ w2v).astype(np.float32),
                campos=np.linalg.inv(w2v)[:3, 3].astype(np.float32),
                focal_x=camera_math.fov2focal(fovx, width),
                focal_y=camera_math.fov2focal(fovy, height), width=width, height=height)


def rig(cfg: dict, yaws=None, pitches=None) -> list:
    """The cameras of the config's rig: `cameras` eyes in `rows` rows on an
    arc of +-yaw_deg and +-pitch_deg at `radius` from `target`, each looking
    at it; or the eyes at the given angles (degrees)."""
    r = cfg["rig"]
    n, rows = cfg["cameras"], r["rows"]
    if yaws is None:
        per_row = -(-n // rows)
        yaws = [r["yaw_deg"] * (2 * (i % per_row) / max(per_row - 1, 1) - 1) for i in range(n)]
        pitches = [r["pitch_deg"] * (2 * (i // per_row) / max(rows - 1, 1) - 1)
                   for i in range(n)]
    target = np.asarray(r["target"], np.float64)
    cams = []
    for yaw, pitch in zip(yaws, pitches):
        a, b = math.radians(yaw), math.radians(pitch)
        eye = target + r["radius"] * np.array([math.sin(a) * math.cos(b), math.sin(b),
                                               -math.cos(a) * math.cos(b)])
        cams.append(look_at(eye, target, (0.0, -1.0, 0.0), math.radians(r["fovx_deg"]),
                            cfg["width"], cfg["height"]))
    return cams


def cloud(cfg: dict, gen: torch.Generator, device) -> tuple:
    """(GaussianParams, GaussianAux) of `gaussians` alive Gaussians in
    `capacity` slots (dead slots: zeros, log-scale -10), made on the card.
    The 3D filter is left at zero: the program and the reference each work
    it out."""
    n, C, c = cfg["gaussians"], cfg["capacity"], cfg["cloud"]
    f32 = dict(dtype=torch.float32, device=device)

    def u(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, **f32)

    def nrm(shape, mean, std):
        return mean + std * torch.randn(shape, generator=gen, **f32)
    if c["layout"] == "box":
        lo, hi = torch.tensor(c["box_min"], **f32), torch.tensor(c["box_max"], **f32)
        xyz = lo + (hi - lo) * torch.rand((n, 3), generator=gen, **f32)
    else:
        # over the frustum of the rig's centre camera (it looks down +z)
        r = cfg["rig"]
        tanx = math.tan(math.radians(r["fovx_deg"]) / 2)
        tany = tanx * cfg["height"] / cfg["width"]
        z = u((n,), c["depth_min"], c["depth_max"])
        xyz = torch.stack([u((n,), -1, 1) * z * tanx, u((n,), -1, 1) * z * tany,
                           z + (r["target"][2] - r["radius"])], 1)
    sh = torch.randn((n, 16, 3), generator=gen, **f32) * 0.3
    sh[:, 0] *= 3.0
    sh[:, 1:] *= 0.3
    q = torch.randn((n, 4), generator=gen, **f32)
    opac = u((n, 1), 0.3, 0.95)
    fields = dict(xyz=xyz, features_dc=sh[:, :1], features_rest=sh[:, 1:],
                  scaling=nrm((n, 3), c["log_scale_mean"], c["log_scale_std"]),
                  rotation=q / torch.linalg.vector_norm(q, dim=1, keepdim=True),
                  opacity=torch.log(opac / (1 - opac)),
                  embedding=nrm((n, cfg["hidden"]["gaussian_embedding_dim"]), 0.0, 0.1))

    def pad(x, fill=0.0):
        return torch.cat([x, torch.full((C - n, *x.shape[1:]), fill, dtype=x.dtype,
                                        device=device)])
    params = GaussianParams(**{k: pad(v, -10.0 if k == "scaling" else 0.0)
                               for k, v in fields.items()})
    zeros = torch.zeros(C, **f32)
    aux = GaussianAux(alive=torch.arange(C, device=device) < n,
                      tongue_class=torch.zeros((C, 1), **f32),
                      filter_3d=torch.zeros((C, 1), **f32), max_radii2d=zeros,
                      xyz_grad_accum=zeros.clone(), denom=zeros.clone())
    return params, aux


def deform_weights(cfg: dict, gen: torch.Generator, device) -> dict:
    """The deformation network's parameters in the program's structure,
    drawn on the card: the temporal table N(0, 0.01 / sqrt(D)), each linear
    layer U(+-1/sqrt(fan_in)) (torch.nn.Linear's init), the heads' last
    layers scaled by `deform_head_scale`."""
    h = cfg["hidden"]
    W = h["net_width"]
    f32 = dict(dtype=torch.float32, device=device)

    def linear(fan_in, fan_out, scale=1.0):
        bound = scale / math.sqrt(fan_in)
        return {"w": (2 * torch.rand((fan_in, fan_out), generator=gen, **f32) - 1) * bound,
                "b": (2 * torch.rand((fan_out,), generator=gen, **f32) - 1) * bound}

    def tower():
        feature = [linear(h["temporal_embedding_dim"] + h["gaussian_embedding_dim"], W)]
        feature += [linear(W, W) for _ in range(h["defor_depth"] - 1)]
        heads = {k: [linear(W, W), linear(W, d, cfg["deform_head_scale"])]
                 for k, d in HEADS.items()}
        return {"feature": feature, "heads": heads}
    D = h["temporal_embedding_dim"]
    weight = torch.randn((h["max_embeddings"], D), generator=gen, **f32) * (0.01 / math.sqrt(D))
    return {"weight": weight, "offsets": torch.zeros((h["max_cameras"], 1), **f32),
            "coarse": tower(), "fine": tower()}


def frame_times(cfg: dict) -> list:
    """The frames the targets are rendered at (spread over the sequence) and
    their times, frame / maxtime."""
    m, k = cfg["opt"]["maxtime"], cfg["frames_per_camera"]
    frames = [int((i + 0.5) * m / k) for i in range(k)]
    return [(f, f / m) for f in frames]

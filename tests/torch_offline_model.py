"""A hermetic scene and model that both packages' offline tools read (not a
test module): the port's generator writes a 3-camera, 2-frame scene, and a
model of its own points (opaque, 3 cm Gaussians, random deformation
weights) is saved by the port's writers."""

import math
import os

import torch

from ed3dgs_torch.config.params import DeformHiddenConfig
from ed3dgs_torch.data.ply import fetch_point_cloud
from ed3dgs_torch.data.scene import save_deformation
from ed3dgs_torch.data.synthetic import generate_scene
from ed3dgs_torch.models import gaussians as tgm

CAP = 384
# bf16_activations=false: the repo's parity pin for a whole render
SET = ["max_number_gaussians=%d" % CAP, "pair_capacity=16384", "net_width=32",
       "min_embeddings=5", "max_embeddings=10", "bf16_activations=false"]


def make_model(root, width=64, height=64, n_points=300):
    """(scene dir, model dir, the flags both packages' tools take)."""
    from ed3dgs_torch.models.deformation import init_deform_params

    scene = generate_scene(os.path.join(root, "scene"), n_cams=3, n_frames=2, width=width,
                           height=height, n_points=n_points, device="cpu")
    pts, cols, _ = fetch_point_cloud(os.path.join(scene, "points3D_downsample.ply"))
    params, aux = tgm.create_from_points(pts, cols, capacity=CAP, device="cpu")
    params = params._replace(opacity=torch.full_like(params.opacity, 2.0),
                             scaling=torch.full_like(params.scaling, math.log(0.03)))
    model = os.path.join(root, "model")
    it_dir = os.path.join(model, "point_cloud", "iteration_10")
    tgm.save_ply(os.path.join(it_dir, "point_cloud.ply"), params, aux)
    save_deformation(it_dir, init_deform_params(
        DeformHiddenConfig(net_width=32, min_embeddings=5, max_embeddings=10), seed=1,
        device="cpu"))
    flags = ["-m", model, "-s", scene, "--loader", "dynerf", "--duration", "2"]
    return scene, model, flags

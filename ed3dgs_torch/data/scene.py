"""Scene orchestration: dataset loading + Gaussian init + checkpoint layout
(port of ed3dgs_tpu/data/scene.py; the files it writes are the JAX
package's, so either package loads the other's models).

Reference parity: scene/__init__.py:25-149 — loader dispatch, input.ply /
cameras.json provenance dump, camera-extent normalization, load-or-init
Gaussians, `save(iteration)` writing point_cloud.ply + deformation weights in
the reference's directory layout (so renders/mesh tools can resume either
implementation's checkpoints).
"""

from __future__ import annotations

import json
import os
import random
from typing import Optional

import numpy as np
import torch

from ..config.params import DeformHiddenConfig, ModelConfig
from ..device import resolve_device
from ..models import gaussians as gm
from .readers import SCENE_READERS, SceneInfo, make_image_loader


def to_numpy(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def flatten_pytree(tree, prefix=""):
    """Nested dict/list/namedtuple pytree of tensors or arrays -> flat
    {path: numpy array}."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_pytree(v, f"{prefix}{k}/"))
    elif hasattr(tree, "_fields"):  # NamedTuple: stable field names
        for k in tree._fields:
            out.update(flatten_pytree(getattr(tree, k), f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_pytree(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = to_numpy(tree)
    return out


def unflatten_into(template, flat, prefix=""):
    """Inverse of flatten_pytree against a structural template: each leaf a
    tensor on the template leaf's device."""
    if isinstance(template, dict):
        return {k: unflatten_into(v, flat, f"{prefix}{k}/") for k, v in template.items()}
    if hasattr(template, "_fields"):
        return type(template)(*[unflatten_into(getattr(template, k), flat,
                                               f"{prefix}{k}/")
                                for k in template._fields])
    if isinstance(template, (list, tuple)):
        seq = [unflatten_into(v, flat, f"{prefix}{i}/") for i, v in enumerate(template)]
        return type(template)(seq)
    dev = template.device if isinstance(template, torch.Tensor) else None
    return torch.as_tensor(np.array(flat[prefix[:-1]]), device=dev)


def save_deformation(path: str, deform_params):
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "deformation.npz"),
             **flatten_pytree(deform_params))


def read_deformation(path: str) -> dict:
    """<path>/deformation.npz as its flat {key: array} (flatten_pytree's keys)."""
    with np.load(os.path.join(path, "deformation.npz")) as data:
        return dict(data)


def load_deformation(path: str, template):
    return unflatten_into(template, read_deformation(path))


class Scene:
    def __init__(
        self,
        model_cfg: ModelConfig,
        hidden_cfg: DeformHiddenConfig,
        *,
        capacity: int,
        duration: Optional[int] = None,
        load_iteration: Optional[int] = None,
        shuffle: bool = True,
        seed: int = 0,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.model_path = model_cfg.model_path
        self.loaded_iter = None
        loader = model_cfg.loader
        if loader not in SCENE_READERS:
            raise ValueError(f"unknown loader '{loader}'")
        defaults = {"dynerf": 300, "nersemble": 110, "technicolor": 50,
                    "colmap": 300}
        duration = duration or defaults.get(loader)  # None -> reader default
        image_loader = make_image_loader(
            white_background=model_cfg.white_background,
            load_tongue=model_cfg.tongue_mask_loss_enabled)
        self.info: SceneInfo = SCENE_READERS[loader](
            model_cfg.source_path, duration=duration,
            resolution=model_cfg.resolution, image_loader=image_loader,
            extension=model_cfg.extension)
        self.maxtime = self.info.maxtime

        if load_iteration is not None:
            if load_iteration == -1:
                pc_dir = os.path.join(self.model_path, "point_cloud")
                iters = [int(d.split("_")[-1]) for d in os.listdir(pc_dir)
                         if d.startswith("iteration_")]
                load_iteration = max(iters)
            self.loaded_iter = load_iteration

        if not self.loaded_iter and self.model_path:
            os.makedirs(self.model_path, exist_ok=True)
            if self.info.point_cloud is not None and os.path.exists(self.info.ply_path):
                with open(self.info.ply_path, "rb") as src, open(
                        os.path.join(self.model_path, "input.ply"), "wb") as dst:
                    dst.write(src.read())
            self._dump_cameras_json()

        if shuffle:
            rng = random.Random(seed)
            rng.shuffle(self.info.train_cameras)
            rng.shuffle(self.info.test_cameras)

        self.cameras_extent = self.info.nerf_normalization["radius"]

        if self.loaded_iter:
            ply = os.path.join(self.model_path, "point_cloud",
                               f"iteration_{self.loaded_iter}", "point_cloud.ply")
            self.params, self.aux = gm.load_ply(ply, capacity=capacity,
                                                sh_degree=model_cfg.sh_degree,
                                                device=self.device)
        else:
            pts, cols, _ = self.info.point_cloud
            self.params, self.aux = gm.create_from_points(
                pts, cols, capacity=capacity,
                embedding_dim=hidden_cfg.gaussian_embedding_dim,
                sh_degree=model_cfg.sh_degree,
                tongue_mask_loss_enabled=model_cfg.tongue_mask_loss_enabled,
                device=self.device)

    def _dump_cameras_json(self):
        entries = []
        for i, cam in enumerate(self.info.test_cameras + self.info.train_cameras):
            m = cam.matrices()
            w2v = m.world_view
            c2w = np.linalg.inv(w2v)
            entries.append({
                "id": i, "img_name": cam.image_name,
                "width": cam.width, "height": cam.height,
                "position": c2w[:3, 3].tolist(),
                "rotation": c2w[:3, :3].tolist(),
                "fx": float(m.focal_x), "fy": float(m.focal_y),
            })
        with open(os.path.join(self.model_path, "cameras.json"), "w") as f:
            json.dump(entries, f, indent=2)

    # --- checkpointing (reference scene.save :134-137) ---------------------
    def save(self, iteration: int, params, aux, deform_params):
        out = os.path.join(self.model_path, "point_cloud", f"iteration_{iteration}")
        os.makedirs(out, exist_ok=True)
        gm.save_ply(os.path.join(out, "point_cloud.ply"), params, aux)
        save_deformation(out, deform_params)

    def load_deformation(self, template, iteration=None):
        it = iteration or self.loaded_iter
        return load_deformation(
            os.path.join(self.model_path, "point_cloud", f"iteration_{it}"),
            template)

    @property
    def train_cameras(self):
        return self.info.train_cameras

    @property
    def test_cameras(self):
        return self.info.test_cameras

    @property
    def video_cameras(self):
        return self.info.video_cameras

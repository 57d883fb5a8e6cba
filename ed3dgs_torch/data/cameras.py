"""Camera model (host-side, numpy) and its device-facing view (port of
ed3dgs_tpu/data/cameras.py; pure numpy, so the code is the same).

Mirrors the information content of the reference Camera
(reference scene/cameras.py:22-140) without the torch module machinery:
R is the cam->world rotation, T the world->cam translation (COLMAP
convention), plus per-camera time / id metadata and the lazily loaded
image, alpha mask and tongue mask (`image_loader`, data/readers.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, NamedTuple, Optional

import math

import numpy as np

from ..core import camera_math


class CameraMatrices(NamedTuple):
    """Static per-camera arrays handed to the renderer (all float32 numpy)."""

    world_view: np.ndarray   # [4,4] world->view (math convention)
    full_proj: np.ndarray    # [4,4] proj @ world_view
    campos: np.ndarray       # [3] camera center in world space
    tan_fovx: float
    tan_fovy: float
    focal_x: float
    focal_y: float
    width: int
    height: int


@dataclass
class Camera:
    R: np.ndarray
    T: np.ndarray
    fovx: float
    fovy: float
    width: int
    height: int
    time: float = 0.0
    cam_no: int = 0
    frame_no: int = 0
    image_name: str = ""
    image_path: str = ""
    cx_ratio: float = 0.0  # principal-point shift ratios (Technicolor)
    cy_ratio: float = 0.0
    znear: float = 0.01
    zfar: float = 100.0
    trans: tuple = (0.0, 0.0, 0.0)
    scale: float = 1.0
    # lazy image/mask loading like reference scene/cameras.py:126-136
    _image: Optional[np.ndarray] = field(default=None, repr=False)
    _mask: Optional[np.ndarray] = field(default=None, repr=False)
    _tongue_mask: Optional[np.ndarray] = field(default=None, repr=False)
    image_loader: Optional[Callable[["Camera"], tuple]] = field(default=None, repr=False)

    def matrices(self) -> CameraMatrices:
        w2v = camera_math.world_to_view(self.R, self.T, self.trans, self.scale)
        if self.cx_ratio != 0.0 or self.cy_ratio != 0.0:
            proj = camera_math.projection_matrix_cv(
                self.znear, self.zfar, self.fovx, self.fovy, self.cx_ratio, self.cy_ratio
            )
        else:
            proj = camera_math.projection_matrix(self.znear, self.zfar, self.fovx, self.fovy)
        full = (proj @ w2v).astype(np.float32)
        c2w = np.linalg.inv(w2v)
        return CameraMatrices(
            world_view=w2v.astype(np.float32),
            full_proj=full,
            campos=c2w[:3, 3].astype(np.float32),
            tan_fovx=math.tan(self.fovx * 0.5),
            tan_fovy=math.tan(self.fovy * 0.5),
            focal_x=camera_math.fov2focal(self.fovx, self.width),
            focal_y=camera_math.fov2focal(self.fovy, self.height),
            width=self.width,
            height=self.height,
        )

    # --- lazy image access -------------------------------------------------
    def load_image(self):
        if self._image is None and self.image_loader is not None:
            self._image, self._mask, self._tongue_mask = self.image_loader(self)
        return self._image

    @property
    def image(self) -> Optional[np.ndarray]:
        return self.load_image()

    @property
    def alpha_mask(self) -> Optional[np.ndarray]:
        self.load_image()
        return self._mask

    @property
    def tongue_mask(self) -> Optional[np.ndarray]:
        self.load_image()
        return self._tongue_mask

    def release_image(self):
        self._image = None
        self._mask = None
        self._tongue_mask = None


def look_at_camera(eye, target, up, fovx, fovy, width, height, **kw) -> Camera:
    """Convenience constructor for synthetic scenes/tests: a camera at `eye`
    looking at `target` (world +z into the screen, OpenCV convention)."""
    eye = np.asarray(eye, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    # camera-to-world rotation: columns are camera axes in world coords
    R_c2w = np.stack([right, down, fwd], axis=1)
    t = -R_c2w.T @ eye  # world->cam translation
    return Camera(R=R_c2w, T=t, fovx=fovx, fovy=fovy, width=width, height=height, **kw)

"""Nerfies/HyperNeRF camera model with radial + tangential distortion (the
port's own copy of ed3dgs_tpu/data/nerfies_camera.py, pure numpy).

Reference parity: scene/utils.py:28-96 (Newton undistortion solve) and
:98-330 (Camera: pixel->ray generation, projection with distortion, pixel->
point unprojection, scaling). NOTE ON USAGE: in the reference, NO runtime
code path ever invokes the distortion solve — hyper_loader.py:159-231 reads
only orientation/position/focal_length/principal_point from the camera, and
the rasterizer is pinhole — so the render path here is also pinhole
(data/hyper.py). This module provides the component itself for dataset
preparation / ray-based tooling: distortion-aware projection, exact ray
generation, and image undistortion.

Everything is vectorized numpy over [..., 2]/[..., 3] batches (host-side
data-prep code; not in the training hot path).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np


def distort(x: np.ndarray, y: np.ndarray, k1: float, k2: float, k3: float,
            p1: float, p2: float):
    """Forward Brown–Conrady distortion of normalized camera coords."""
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + k3 * r2))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + 2.0 * p2 * x * y + p1 * (r2 + 2.0 * y * y)
    return xd, yd


def undistort(xd: np.ndarray, yd: np.ndarray, k1: float, k2: float,
              k3: float, p1: float, p2: float, *, iterations: int = 10,
              eps: float = 1e-9):
    """Invert `distort` by Newton's method on the 2x2 residual Jacobian
    (scene/utils.py:63-96; 10 fixed iterations, guarded step)."""
    x, y = np.array(xd, np.float64), np.array(yd, np.float64)
    for _ in range(iterations):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + k3 * r2))
        fx = radial * x + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x) - xd
        fy = radial * y + 2.0 * p2 * x * y + p1 * (r2 + 2.0 * y * y) - yd
        dradial = k1 + r2 * (2.0 * k2 + 3.0 * k3 * r2)
        # Jacobian of (fx, fy) wrt (x, y)
        j00 = radial + 2.0 * x * x * dradial + 2.0 * p1 * y + 6.0 * p2 * x
        j01 = 2.0 * x * y * dradial + 2.0 * p1 * x + 2.0 * p2 * y
        j10 = 2.0 * x * y * dradial + 2.0 * p2 * y + 2.0 * p1 * x
        j11 = radial + 2.0 * y * y * dradial + 2.0 * p2 * x + 6.0 * p1 * y
        det = j00 * j11 - j01 * j10
        safe = np.abs(det) > eps
        inv = np.where(safe, 1.0 / np.where(safe, det, 1.0), 0.0)
        x = x - (fx * j11 - fy * j01) * inv
        y = y - (fy * j00 - fx * j10) * inv
    return x, y


@dataclass
class NerfiesCamera:
    """orientation: world->camera rotation (rows = camera axes);
    position: camera center in world coordinates."""

    orientation: np.ndarray
    position: np.ndarray
    focal_length: float
    principal_point: np.ndarray            # (cx, cy) pixels
    image_size: np.ndarray                 # (W, H)
    skew: float = 0.0
    pixel_aspect_ratio: float = 1.0
    radial_distortion: np.ndarray = field(
        default_factory=lambda: np.zeros(3))
    tangential_distortion: np.ndarray = field(
        default_factory=lambda: np.zeros(2))

    @classmethod
    def from_json_dict(cls, cj: dict) -> "NerfiesCamera":
        if "tangential" in cj:                      # old schema
            cj = dict(cj, tangential_distortion=cj["tangential"])
        return cls(
            orientation=np.asarray(cj["orientation"], np.float64),
            position=np.asarray(cj["position"], np.float64),
            focal_length=float(cj["focal_length"]),
            principal_point=np.asarray(cj["principal_point"], np.float64),
            image_size=np.asarray(cj["image_size"], np.int64),
            skew=float(cj.get("skew", 0.0)),
            pixel_aspect_ratio=float(cj.get("pixel_aspect_ratio", 1.0)),
            radial_distortion=np.asarray(
                cj.get("radial_distortion", [0, 0, 0]), np.float64),
            tangential_distortion=np.asarray(
                cj.get("tangential_distortion", [0, 0]), np.float64))

    @property
    def has_distortion(self) -> bool:
        return bool(np.any(self.radial_distortion != 0)
                    or np.any(self.tangential_distortion != 0))

    def _coeffs(self):
        k = self.radial_distortion
        p = self.tangential_distortion
        return float(k[0]), float(k[1]), float(k[2]), float(p[0]), float(p[1])

    # --- rays -------------------------------------------------------------
    def pixel_to_local_rays(self, pixels: np.ndarray) -> np.ndarray:
        """[..., 2] pixels -> [..., 3] unit directions in camera frame,
        undistorting when the camera carries distortion."""
        y = (pixels[..., 1] - self.principal_point[1]) / (
            self.focal_length * self.pixel_aspect_ratio)
        x = (pixels[..., 0] - self.principal_point[0]
             - y * self.skew) / self.focal_length
        if self.has_distortion:
            x, y = undistort(x, y, *self._coeffs())
        d = np.stack([x, y, np.ones_like(x)], axis=-1)
        return d / np.linalg.norm(d, axis=-1, keepdims=True)

    def pixels_to_rays(self, pixels: np.ndarray) -> np.ndarray:
        """[..., 2] pixels -> [..., 3] unit world-space ray directions."""
        local = self.pixel_to_local_rays(np.asarray(pixels, np.float64))
        world = local @ self.orientation          # R^T @ d, batched
        return world / np.linalg.norm(world, axis=-1, keepdims=True)

    def pixels_to_points(self, pixels: np.ndarray,
                         depth: np.ndarray) -> np.ndarray:
        """Unproject pixels at optical-axis depth `depth` to world points."""
        rays = self.pixels_to_rays(pixels)
        cosa = rays @ self.orientation[2]
        return rays * (depth / cosa)[..., None] + self.position

    # --- projection ---------------------------------------------------------
    def project(self, points: np.ndarray) -> np.ndarray:
        """[..., 3] world points -> [..., 2] distorted pixel positions."""
        local = (np.asarray(points, np.float64) - self.position) \
            @ self.orientation.T
        x = local[..., 0] / local[..., 2]
        y = local[..., 1] / local[..., 2]
        xd, yd = distort(x, y, *self._coeffs())
        px = self.focal_length * xd + self.skew * yd + self.principal_point[0]
        py = (self.focal_length * self.pixel_aspect_ratio * yd
              + self.principal_point[1])
        return np.stack([px, py], axis=-1)

    def get_pixel_centers(self) -> np.ndarray:
        w, h = int(self.image_size[0]), int(self.image_size[1])
        xx, yy = np.meshgrid(np.arange(w, dtype=np.float64),
                             np.arange(h, dtype=np.float64))
        return np.stack([xx, yy], axis=-1) + 0.5

    def scale(self, s: float) -> "NerfiesCamera":
        if s <= 0:
            raise ValueError("scale must be positive")
        return replace(
            self,
            focal_length=self.focal_length * s,
            principal_point=self.principal_point * s,
            image_size=np.array([int(round(self.image_size[0] * s)),
                                 int(round(self.image_size[1] * s))]))

    # --- dataset prep -------------------------------------------------------
    def undistort_image(self, image: np.ndarray) -> np.ndarray:
        """Resample a distorted [H, W, C] image onto the ideal pinhole grid
        (bilinear): for each undistorted pixel, sample the distorted image at
        the forward-distorted position. Enables pinhole training on raw
        Nerfies captures (the reference has no such utility)."""
        h, w = image.shape[:2]
        centers = self.get_pixel_centers()            # undistorted targets
        y = (centers[..., 1] - self.principal_point[1]) / (
            self.focal_length * self.pixel_aspect_ratio)
        x = (centers[..., 0] - self.principal_point[0]
             - y * self.skew) / self.focal_length
        xd, yd = distort(x, y, *self._coeffs())
        sx = self.focal_length * xd + self.skew * yd \
            + self.principal_point[0] - 0.5
        sy = self.focal_length * self.pixel_aspect_ratio * yd \
            + self.principal_point[1] - 0.5
        x0 = np.clip(np.floor(sx).astype(np.int64), 0, w - 1)
        y0 = np.clip(np.floor(sy).astype(np.int64), 0, h - 1)
        x1, y1 = np.minimum(x0 + 1, w - 1), np.minimum(y0 + 1, h - 1)
        fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
        img = image.reshape(h, w, -1).astype(np.float64)
        out = ((1 - fx) * (1 - fy) * img[y0, x0] + fx * (1 - fy) * img[y0, x1]
               + (1 - fx) * fy * img[y1, x0] + fx * fy * img[y1, x1])
        return out.reshape(image.shape).astype(image.dtype)

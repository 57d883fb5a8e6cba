"""Camera/frame sampling strategies (host-side numpy; port of
ed3dgs_tpu/train/sampling.py, the same code, so the same seed and recorded
losses give the same draws).

All five reference strategies (train.py:134-158, utils/train_utils.py:6-64,
utils/extra_utils.py:23-72):
  * default: distance-constrained camera walk + error-CDF frame sampling
    alternating with uniform-random frames,
  * sequential-frame, first-frame-then-sequential, preference-frames,
  * nerfies paired sampling is handled by the hyper data path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


def calculate_camera_distances(camera_centers: np.ndarray) -> np.ndarray:
    diff = camera_centers[:, None, :] - camera_centers[None, :, :]
    return np.sqrt(np.sum(diff ** 2, axis=-1))


def sample_camera_walk(distances, last_index, min_distance, rng) -> int:
    """Next camera at least min_distance away (extra_utils.py:64-72)."""
    valid = np.where(distances[last_index] >= min_distance)[0]
    valid = valid[valid != last_index]
    if len(valid) > 0:
        return int(rng.choice(valid))
    return int(rng.choice(distances.shape[0]))


def sample_frames_by_error(batch_size, loss_list, rng) -> np.ndarray:
    """Error-CDF frame sampling (extra_utils.py:23-54)."""
    loss_values = loss_list.sum(axis=0).reshape(1, -1)
    q_low, q_high = np.percentile(loss_values, 0), np.percentile(loss_values, 100)
    loss_values = np.clip(loss_values, q_low, q_high)
    denom = max(q_high - q_low, 1e-12)
    loss_values = (loss_values - q_low) / denom
    total = loss_values.sum()
    if total <= 0:
        return rng.integers(0, loss_list.shape[1], size=batch_size)
    probs = loss_values / total
    cdf = np.cumsum(probs)
    return np.searchsorted(cdf, rng.random(batch_size))


@dataclass
class CameraSampler:
    """Stateful sampler over the sorted (cam_no, frame_no) camera list."""

    num_cams: int
    maxtime: int
    camera_centers: np.ndarray
    batch_size: int = 1
    random_until: int = 10000
    num_multiview_ssim: int = 0
    # strategy switches (ModelConfig)
    sequential: bool = False
    first_frame_then_sequential: bool = False
    first_frame_change: int = 11_000
    is_sample_from_past: bool = False
    preference_frames: tuple = ()
    preference_probability: float = 0.5
    seed: int = 0

    def __post_init__(self):
        self.rng = np.random.default_rng(self.seed)
        self.distances = calculate_camera_distances(self.camera_centers)
        uniq = np.unique(self.distances)
        self.min_dist = uniq[int(uniq.shape[0] * 0.5)] if len(uniq) > 1 else 0.0
        self.last_camera = 0
        self.loss_list = np.full((self.num_cams, self.maxtime), 100.0)
        self._held_frames: Optional[np.ndarray] = None

    def record_loss(self, cam_nos, frame_nos, losses):
        for c, f, l in zip(cam_nos, frame_nos, losses):
            self.loss_list[c % self.num_cams, f % self.maxtime] = l

    def sample(self, iteration: int, final_iter: int):
        """Returns (cam_nos, frame_nos, use_ssim) index arrays of batch_size."""
        B = self.batch_size
        rng = self.rng
        if self.sequential:
            per_frame = max(final_iter // self.maxtime, 1)
            f = min((iteration - 1) // per_frame, self.maxtime - 1)
            if self.is_sample_from_past and f != 0 and iteration % 2 == 0:
                f = int(rng.integers(0, f))
            cams = rng.integers(0, self.num_cams, B)
            return cams, np.full(B, f), False
        if self.first_frame_then_sequential:
            if iteration <= self.first_frame_change:
                cams = rng.integers(0, self.num_cams, B)
                return cams, np.zeros(B, np.int64), False
            nit = final_iter - self.first_frame_change
            nf = self.maxtime - 1
            per_frame = max(nit // nf, 1)
            f = min((iteration - self.first_frame_change - 1) // per_frame + 1, nf)
            cams = rng.integers(0, self.num_cams, B)
            return cams, np.full(B, f), False
        if self.preference_frames:
            cams = rng.integers(0, self.num_cams, B)
            if rng.random() < self.preference_probability:
                frames = rng.choice(np.asarray(self.preference_frames), size=B)
            else:
                frames = rng.integers(0, self.maxtime, B)
            return cams, frames, False

        # default: camera walk + random/by-error frames (train.py:144-158)
        method = "random" if (iteration < self.random_until or iteration % 2 == 1) else "by_error"
        cams = []
        for _ in range(B):
            self.last_camera = sample_camera_walk(
                self.distances, self.last_camera, self.min_dist, rng)
            cams.append(self.last_camera)
        cams = np.asarray(cams)
        if self._held_frames is not None:
            frames = self._held_frames
        elif method == "random":
            frames = rng.integers(0, self.maxtime, B)
        else:
            frames = sample_frames_by_error(B, self.loss_list, rng)
        # multiview-ssim frame reuse window (train.py:155-158)
        if (iteration >= self.random_until and self.num_multiview_ssim > 0
                and iteration % 50 < self.num_multiview_ssim):
            self._held_frames = frames
        else:
            self._held_frames = None
        use_ssim = (method == "by_error" and iteration % 10 == 0
                    and self.num_multiview_ssim == 0) or self._held_frames is not None
        return cams, frames, bool(use_ssim)

"""Training losses (port of ed3dgs_tpu/train/losses.py: the reference's
utils/loss_utils.py, utils/image_utils.py and the loss assembly of
train.py:195-343)."""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core.camera_math import depth_to_normal, points_to_normal
from ..ops.knn import _dot3


def l1_loss(pred, gt, keepdim=False):
    d = torch.abs(pred - gt)
    if keepdim:
        return torch.mean(d.reshape(d.shape[0], -1), dim=1)
    return torch.mean(d)


def psnr(pred, gt):
    """Per-image PSNR, matching utils/image_utils.py:17."""
    mse = torch.mean(((pred - gt) ** 2).reshape(pred.shape[0], -1), dim=1)
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp_min(mse, 1e-20)))


@functools.lru_cache(maxsize=None)
def _gaussian_window_np(window_size: int = 11, sigma: float = 1.5):
    g = np.array([math.exp(-((x - window_size // 2) ** 2) / (2 * sigma ** 2))
                  for x in range(window_size)], dtype=np.float32)
    g = g / g.sum()
    return np.outer(g, g)


_WINDOWS: dict = {}


def _gaussian_window(window_size: int, dtype, device) -> torch.Tensor:
    """The window on `device`, copied there once: a copy from host memory
    makes the host wait for the card, and a captured graph cannot hold one."""
    key = (window_size, dtype, torch.device(device))
    w = _WINDOWS.get(key)
    if w is None:
        w = _WINDOWS[key] = torch.as_tensor(_gaussian_window_np(window_size), dtype=dtype,
                                            device=device)
    return w


def ssim(img1, img2, window_size: int = 11):
    """Gaussian-window SSIM, same constants and padding as the reference
    (utils/loss_utils.py:43-73). img: [B, C, H, W] or [C, H, W]; the window
    takes the images' dtype.

    The grouped convolutions run with cuDNN's TF32 off: TF32 keeps about
    three decimal digits, and cuDNN uses it for float32 by default."""
    if img1.dim() == 3:
        img1, img2 = img1[None], img2[None]
    C = img1.shape[1]
    w = _gaussian_window(window_size, img1.dtype, img1.device)
    kernel = w[None, None].expand(C, 1, window_size, window_size).contiguous()
    pad = window_size // 2

    def conv(x):
        return F.conv2d(x, kernel, padding=pad, groups=C)

    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        mu1, mu2 = conv(img1), conv(img2)
        mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
        s1 = conv(img1 * img1) - mu1_sq
        s2 = conv(img2 * img2) - mu2_sq
        s12 = conv(img1 * img2) - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * s12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return torch.mean(ssim_map)


def embedding_knn_loss(embedding, neighbor_indices, neighbor_weight, mask=None):
    """Per-Gaussian embedding smoothness against its cached K nearest
    neighbours (train.py:231-235); masked rows contribute 0. The small-scale
    oracle of the fused loss the train step runs (ops/knn_loss.py)."""
    emb_knn = embedding[neighbor_indices.long()]             # [N, K, E]
    d2 = torch.sum((embedding[:, None, :] - emb_knn) ** 2, dim=-1)
    per = torch.sqrt(d2 * neighbor_weight + 1e-20)
    if mask is None:
        return torch.mean(per)
    m = mask.to(torch.float32)[:, None]
    return torch.sum(per * m) / torch.clamp_min(torch.sum(m) * per.shape[1], 1.0)


def temporal_tv_loss(weight):
    """Smoothness of the temporal table. Reproduces the reference's exact
    (quirky) formula (train.py:240-245): differences are taken against the
    broadcast *last row*, twice, not consecutive rows."""
    n = weight.shape[0]
    first = weight[1:, :] - weight[n - 1, :]
    second = first[1:, :] - first[n - 2, :]
    return torch.mean(torch.square(second))


def opacity_mean_loss(opacity_raw, alive):
    """sigmoid of the mean raw opacity over alive Gaussians (train.py:213-215)."""
    m = alive.to(torch.float32)[:, None]
    mean_raw = torch.sum(opacity_raw * m) / torch.clamp_min(torch.sum(m), 1.0)
    return torch.sigmoid(mean_raw)


def depth_normal_loss(rendered_normal, expected_depth, median_depth,
                      width, height, focal_x, focal_y, depth_ratio=0.6):
    """RaDe-GS depth-normal consistency (train.py:248-271 with
    depth_double_to_normal): normals from finite differences of the
    unprojected expected and median depth maps against the rendered normal."""
    n_exp = depth_to_normal(expected_depth[0], width, height, focal_x, focal_y)
    n_med = depth_to_normal(median_depth[0], width, height, focal_x, focal_y)
    err_exp = 1.0 - torch.sum(rendered_normal * n_exp, dim=0)
    err_med = 1.0 - torch.sum(rendered_normal * n_med, dim=0)
    return (1.0 - depth_ratio) * torch.mean(err_exp) + depth_ratio * torch.mean(err_med)


def coord_normal_loss(rendered_normal, expected_coord, median_coord, depth_ratio=0.6):
    """use_coord_map variant (train.py:258-262): normals from the rendered
    camera-space coordinate maps directly."""
    n_exp = points_to_normal(expected_coord)
    n_med = points_to_normal(median_coord)
    err_exp = 1.0 - torch.sum(rendered_normal * n_exp, dim=0)
    err_med = 1.0 - torch.sum(rendered_normal * n_med, dim=0)
    return (1.0 - depth_ratio) * torch.mean(err_exp) + depth_ratio * torch.mean(err_med)


def colmap_pcd_loss(pcd_points, gaussian_positions, alive, chunk: int = 500):
    """COLMAP point-cloud supervision (train.py:273-295,
    utils/train_utils.py:73-89): for each GT point, the squared distance in
    millimeters (x1000 per axis) to its nearest deformed Gaussian; mean over
    points. Dead capacity slots are excluded. Chunked over GT points as the
    JAX package chunks them, each chunk's distances formed in its order,
    |p|^2 + (|g|^2 + dead_bump) - 2 p.g, with the arithmetic of its jitted
    step on the CPU: the squared norms are fused multiply-add chains (as
    ops/knn.py forms them), the cross term a matmul. The nearest distance
    is `torch.amin`, whose gradient splits a tie evenly between its entries
    as `jnp.min`'s does (`torch.min(dim)` would give it all to one)."""
    g = gaussian_positions * 1000.0                       # [C,3] mm
    g2 = _dot3(g, g)                                      # [C]
    # finite: an inf would break the min's gradient
    dead_bump = torch.where(alive, torch.zeros_like(g2), torch.full_like(g2, 3e38))
    P = pcd_points.shape[0]
    if P % chunk:  # colmap_pcd_samples need not divide the default chunk
        chunk = math.gcd(P, chunk)
    p = pcd_points.reshape(-1, chunk, 3) * 1000.0         # [n,chunk,3]
    p2 = _dot3(p, p)                                      # [n,chunk]
    d = torch.stack([torch.amin(pc2[:, None] + (g2 + dead_bump)[None, :]
                                - 2.0 * pc @ g.T, dim=1) for pc, pc2 in zip(p, p2)])
    return torch.mean(torch.maximum(d, torch.zeros((), device=d.device)))

"""Relayout of the blend kernel's tile-packed output: kernels K5a and K5b
(port of ed3dgs_tpu/ops/relayout.py, `unpack_image` and its custom_vjp).

The blend kernel writes [gy, GXP, C, 256]: one 16x16 tile per (tile row,
tile column), channel-major, with the tile columns padded to a multiple of 8
(GXP). `unpack_image` turns that into the [C, gy*16, GXP*16] image:

    out[c, ty*16 + y, tx*16 + x] = packed[ty, tx, c, 16*y + x]

Tile columns grid_x..GXP are never written by the blend kernel, so callers
slice [:, :H, :W] before any arithmetic. `pack_image` (K5b) is the exact
inverse, and `unpack` is the differentiable relayout: an autograd Function
whose backward packs the image cotangent (the JAX package's
`unpack_image.defvjp`).

On a CUDA tensor each wrapper launches its kernel in csrc/relayout.cu; on a
CPU tensor it runs its plain version.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .common import TILE

PIX = TILE * TILE
GROUP = 8    # tile columns are padded to whole groups of 8 (128 pixels)


def pad_grid_x(grid_x: int) -> int:
    """Tile columns rounded up to whole groups of 8."""
    return -(-grid_x // GROUP) * GROUP


def unpack_image_plain(packed: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K5a: reshape + permute + copy."""
    gy, gxp, C, _ = packed.shape
    return (packed.reshape(gy, gxp, C, TILE, TILE).permute(2, 0, 3, 1, 4)
            .reshape(C, gy * TILE, gxp * TILE).contiguous())


def unpack_image(packed: torch.Tensor) -> torch.Tensor:
    """[gy, GXP, C, 256] float32 tile-packed -> [C, gy*16, GXP*16] image."""
    if not packed.is_cuda:
        return unpack_image_plain(packed)
    cuda_lib.check_cuda(packed, "packed", torch.float32, 4)
    gy, gxp, C, pix = packed.shape
    if pix != PIX:
        raise ValueError(f"packed tiles must hold {PIX} pixels, got {pix}")
    out = torch.empty((C, gy * TILE, gxp * TILE), dtype=torch.float32,
                      device=packed.device)
    with torch.cuda.device(packed.device):
        err = cuda_lib.kernels("relayout", packed).ed3dgs_unpack_image(
            packed.data_ptr(), out.data_ptr(), gy, gxp, C,
            cuda_lib.stream_of(packed))
    cuda_lib.check_launch(err, "unpack_image")
    cuda_lib.count_launch(unpack_image)
    return out


unpack_image.launches = 0


def pack_image_plain(img: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K5b: reshape + permute + copy."""
    C, H, W = img.shape
    gy, gxp = H // TILE, W // TILE
    return (img.reshape(C, gy, TILE, gxp, TILE).permute(1, 3, 0, 2, 4)
            .reshape(gy, gxp, C, PIX).contiguous())


def pack_image(img: torch.Tensor) -> torch.Tensor:
    """[C, gy*16, GXP*16] float32 image -> [gy, GXP, C, 256] tile-packed."""
    C, H, W = img.shape
    if H % TILE or W % (TILE * GROUP):
        raise ValueError(f"image {H}x{W} is not whole tile rows of 8-tile groups")
    if not img.is_cuda:
        return pack_image_plain(img)
    cuda_lib.check_cuda(img, "img", torch.float32, 3)
    gy, gxp = H // TILE, W // TILE
    out = torch.empty((gy, gxp, C, PIX), dtype=torch.float32, device=img.device)
    with torch.cuda.device(img.device):
        err = cuda_lib.kernels("relayout", img).ed3dgs_pack_image(
            img.data_ptr(), out.data_ptr(), gy, gxp, C, cuda_lib.stream_of(img))
    cuda_lib.check_launch(err, "pack_image")
    cuda_lib.count_launch(pack_image)
    return out


pack_image.launches = 0


class _Unpack(torch.autograd.Function):
    @staticmethod
    def forward(ctx, packed):
        return unpack_image(packed)

    @staticmethod
    def backward(ctx, cot):
        return pack_image(cot.contiguous())


def unpack(packed: torch.Tensor) -> torch.Tensor:
    """Differentiable `unpack_image`: the backward runs `pack_image`."""
    return _Unpack.apply(packed)

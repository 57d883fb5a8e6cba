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

Frozen copy of the plain versions, on any device.
"""

from __future__ import annotations

import torch

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


unpack_image = unpack_image_plain


def pack_image_plain(img: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K5b: reshape + permute + copy."""
    C, H, W = img.shape
    gy, gxp = H // TILE, W // TILE
    return (img.reshape(C, gy, TILE, gxp, TILE).permute(1, 3, 0, 2, 4)
            .reshape(gy, gxp, C, PIX).contiguous())


pack_image = pack_image_plain


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

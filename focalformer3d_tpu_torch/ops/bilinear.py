"""Bilinear sampling on (H, W, C) feature maps.

Port of ``focalformer3d_tpu/ops/bilinear.py``: four gathers and lerp
weights with ``F.grid_sample(align_corners=False, padding_mode='zeros')``
semantics, on the JAX package's channels-last layout.
"""
from __future__ import annotations

import torch


def bilinear_sample(feat: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """feat (H, W, C); xy (..., 2) in texel-center pixel coords (feat[i, j]
    sits at x=j, y=i); taps outside the map read zero. Returns (..., C)."""
    H, W, C = feat.shape
    x, y = xy[..., 0], xy[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0)[..., None], (y - y0)[..., None]
    x0i, y0i = x0.long(), y0.long()

    def gather(yi, xi):
        v = feat[yi.clamp(0, H - 1), xi.clamp(0, W - 1)]
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        return torch.where(inb[..., None], v, 0.0)

    return (
        gather(y0i, x0i) * (1 - wx) * (1 - wy)
        + gather(y0i, x0i + 1) * wx * (1 - wy)
        + gather(y0i + 1, x0i) * (1 - wx) * wy
        + gather(y0i + 1, x0i + 1) * wx * wy
    )


def grid_sample_norm(feat: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """feat (H, W, C); grid (..., 2) normalized to [-1, 1] (x, y). Maps to
    pixel centers via ((g + 1) * size - 1) / 2."""
    H, W, _ = feat.shape
    x = ((grid[..., 0] + 1.0) * W - 1.0) * 0.5
    y = ((grid[..., 1] + 1.0) * H - 1.0) * 0.5
    return bilinear_sample(feat, torch.stack([x, y], dim=-1))

"""Points in rotated boxes (mmdet3d ``points_in_boxes_gpu``).

Port of ``focalformer3d_tpu/ops/points_in_boxes.py``, which the head's
``boxcls`` mask mode reads (``models/focal_decoder._boxcls_mask``). Boxes
are LiDAR-frame [x, y, z (bottom), dx, dy, dz, yaw]; a point belongs to
the first box that holds it (the lowest index), -1 if none, as the CUDA
op assigns each point once. An (N, M) test, as the JAX function.
"""
from __future__ import annotations

from typing import Optional

import torch


def points_in_boxes_mask(points: torch.Tensor,
                         boxes: torch.Tensor) -> torch.Tensor:
    """points (N, >=3), boxes (M, 7) -> bool (N, M) containment."""
    p = points[:, None, :3]
    c = boxes[None, :, :3]
    yaw = boxes[None, :, 6]
    dx = p[..., 0] - c[..., 0]
    dy = p[..., 1] - c[..., 1]
    cos, sin = torch.cos(-yaw), torch.sin(-yaw)
    lx = dx * cos - dy * sin
    ly = dx * sin + dy * cos
    half = boxes[None, :, 3:6] * 0.5
    dz = p[..., 2] - c[..., 2]  # z is the box's bottom
    return ((lx.abs() <= half[..., 0]) & (ly.abs() <= half[..., 1])
            & (dz >= 0) & (dz <= boxes[None, :, 5]))


def points_in_boxes(points: torch.Tensor, boxes: torch.Tensor,
                    valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """points (N, >=3), boxes (M, 7) -> int32 (N,): the first box that
    holds each point, or -1; ``valid`` (M,) leaves padded boxes out."""
    m = points_in_boxes_mask(points, boxes)
    if valid is not None:
        m = m & valid[None, :]
    first = m.to(torch.uint8).argmax(1).to(torch.int32)
    return torch.where(m.any(1), first, -1)

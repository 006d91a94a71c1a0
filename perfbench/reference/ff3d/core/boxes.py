"""3D box utilities in the LiDAR frame, on tensors of any leading shape.

Port of ``focalformer3d_tpu/core/boxes.py``. Box layout (mmdet3d
``LiDARInstance3DBoxes``):

    box = (x, y, z_bottom, dx, dy, dz, yaw[, vx, vy])

``(x, y, z_bottom)`` is the bottom centre, ``(dx, dy, dz)`` the full extents
along the box's own axes, ``yaw`` the rotation about +z (0: the box's x along
the world's x), ``(vx, vy)`` the BEV velocity (nuScenes, code size 10).
No function here has a data-dependent shape: padded boxes are the caller's
to mask.
"""
from __future__ import annotations

import math

import torch


def gravity_center(boxes: torch.Tensor) -> torch.Tensor:
    """(..., >=7) boxes -> (..., 3) gravity centres (z_bottom + dz/2)."""
    return torch.stack(
        [boxes[..., 0], boxes[..., 1], boxes[..., 2] + 0.5 * boxes[..., 5]],
        dim=-1)


def bev_corners(boxes: torch.Tensor) -> torch.Tensor:
    """(..., >=7) boxes -> (..., 4, 2) BEV corners, counter-clockwise from
    (+dx/2, +dy/2) in the box frame."""
    x, y = boxes[..., 0], boxes[..., 1]
    hdx, hdy = 0.5 * boxes[..., 3], 0.5 * boxes[..., 4]
    c, s = torch.cos(boxes[..., 6]), torch.sin(boxes[..., 6])
    lx = torch.stack([hdx, -hdx, -hdx, hdx], dim=-1)
    ly = torch.stack([hdy, hdy, -hdy, -hdy], dim=-1)
    wx = x[..., None] + c[..., None] * lx - s[..., None] * ly
    wy = y[..., None] + s[..., None] * lx + c[..., None] * ly
    return torch.stack([wx, wy], dim=-1)


def corners_3d(boxes: torch.Tensor) -> torch.Tensor:
    """All 8 corners (..., 8, 3): the bottom 4, then the top 4, each in
    ``bev_corners``' order."""
    bev = bev_corners(boxes)
    zb = boxes[..., 2, None, None].expand(bev.shape[:-1] + (1,))
    zt = (boxes[..., 2] + boxes[..., 5])[..., None, None].expand_as(zb)
    return torch.cat([torch.cat([bev, zb], -1), torch.cat([bev, zt], -1)],
                     dim=-2)


def rotate_points_z(points: torch.Tensor, angle: torch.Tensor
                    ) -> torch.Tensor:
    """Rotate (..., N, >=2) points counter-clockwise about +z by ``angle``
    (...,); columns past the second stay."""
    c, s = torch.cos(angle)[..., None], torch.sin(angle)[..., None]
    x, y = points[..., 0], points[..., 1]
    xy = torch.stack([c * x - s * y, s * x + c * y], dim=-1)
    return torch.cat([xy, points[..., 2:]], dim=-1)


def points_in_boxes_bev(points_xy: torch.Tensor, boxes: torch.Tensor
                        ) -> torch.Tensor:
    """bool (..., N, M): BEV point n inside rotated box m (edges included).
    points_xy (..., N, 2), boxes (..., M, >=7)."""
    dx = points_xy[..., :, None, 0] - boxes[..., None, :, 0]
    dy = points_xy[..., :, None, 1] - boxes[..., None, :, 1]
    yaw = boxes[..., None, :, 6]
    c, s = torch.cos(yaw), torch.sin(yaw)
    lx = c * dx + s * dy  # world -> box frame
    ly = -s * dx + c * dy
    return ((lx.abs() <= 0.5 * boxes[..., None, :, 3])
            & (ly.abs() <= 0.5 * boxes[..., None, :, 4]))


def points_in_boxes_3d(points: torch.Tensor, boxes: torch.Tensor
                       ) -> torch.Tensor:
    """bool (..., N, M): 3D containment, bottom and top included."""
    z = points[..., :, None, 2]
    zb = boxes[..., None, :, 2]
    zt = zb + boxes[..., None, :, 5]
    return (points_in_boxes_bev(points[..., :2], boxes)
            & (z >= zb) & (z <= zt))


def flip_boxes(boxes: torch.Tensor, axis: str) -> torch.Tensor:
    """Flip over the BEV 'horizontal' (y -> -y) or 'vertical' (x -> -x)
    axis, as mmdet3d's box flip (and the TTA mapping back) does."""
    out = boxes.clone()
    if axis == "horizontal":
        out[..., 1] = -boxes[..., 1]
        out[..., 6] = -boxes[..., 6]
        if boxes.shape[-1] >= 9:
            out[..., 8] = -boxes[..., 8]
    elif axis == "vertical":
        out[..., 0] = -boxes[..., 0]
        out[..., 6] = -boxes[..., 6] + math.pi
        if boxes.shape[-1] >= 9:
            out[..., 7] = -boxes[..., 7]
    else:
        raise ValueError(axis)
    return out


def scale_boxes(boxes: torch.Tensor, scale) -> torch.Tensor:
    """Scale centres, extents and velocity by ``scale``; yaw stays."""
    return torch.cat([boxes[..., :6] * scale, boxes[..., 6:7],
                      boxes[..., 7:] * scale], dim=-1)


def rotate_boxes(boxes: torch.Tensor, angle) -> torch.Tensor:
    """Rotate boxes (centres, yaw, velocity) counter-clockwise about the
    world's z axis by ``angle``."""
    angle = torch.as_tensor(angle, dtype=boxes.dtype, device=boxes.device)
    c, s = torch.cos(angle), torch.sin(angle)
    parts = [torch.stack([c * boxes[..., 0] - s * boxes[..., 1],
                          s * boxes[..., 0] + c * boxes[..., 1]], dim=-1),
             boxes[..., 2:6], (boxes[..., 6] + angle)[..., None]]
    if boxes.shape[-1] > 7:
        parts.append(torch.stack([c * boxes[..., 7] - s * boxes[..., 8],
                                  s * boxes[..., 7] + c * boxes[..., 8]],
                                 dim=-1))
    return torch.cat(parts, dim=-1)

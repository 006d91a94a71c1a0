"""CenterPoint-style Gaussian heatmap targets.

Port of ``focalformer3d_tpu/core/gaussian.py``: one dense max over padded GT
slots (no per-GT loop), the exact semantics of mmdet3d
``draw_heatmap_gaussian`` (sigma (2r+1)/6, a square window of side 2r+1
around the integer centre, element-wise max).
"""
from __future__ import annotations

import torch


def gaussian_radius(det_size, min_overlap: float = 0.5) -> torch.Tensor:
    """CornerNet radius rule, elementwise; det_size = (length, width) in
    grid units."""
    height, width = det_size
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + torch.sqrt(torch.clamp(b1 ** 2 - 4 * c1, min=0.0))) / 2
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + torch.sqrt(torch.clamp(b2 ** 2 - 16 * c2, min=0.0))) / 2
    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + torch.sqrt(torch.clamp(b3 ** 2 - 4 * a3 * c3, min=0.0))) / 2
    return torch.minimum(torch.minimum(r1, r2), r3)


def draw_heatmap(centers_xy, radii, labels, valid, num_classes: int,
                 height: int, width: int) -> torch.Tensor:
    """Per-class Gaussian peaks of (G,) GTs, max-combined: (num_classes,
    height, width) float32. Row = y, column = x."""
    dev = centers_xy.device
    cx = torch.floor(centers_xy[:, 0]).to(torch.int32)
    cy = torch.floor(centers_xy[:, 1]).to(torch.int32)
    r = radii.to(torch.int32)
    sigma = (2.0 * radii + 1.0) / 6.0
    ys = torch.arange(height, dtype=torch.int32, device=dev)[:, None]
    xs = torch.arange(width, dtype=torch.int32, device=dev)[None, :]
    dx = xs[None] - cx[:, None, None]  # (G, H, W)
    dy = ys[None] - cy[:, None, None]
    g = torch.exp(-(dx.float() ** 2 + dy.float() ** 2)
                  / (2.0 * sigma[:, None, None] ** 2))
    window = ((dx.abs() <= r[:, None, None]) & (dy.abs() <= r[:, None, None])
              & valid[:, None, None])
    g = torch.where(window, g, 0.0)
    out = torch.zeros((num_classes, height, width), dtype=g.dtype,
                      device=dev)
    idx = labels.long()[:, None, None].expand_as(g)
    return out.scatter_reduce(0, idx, g, "amax", include_self=True)


def heatmap_targets(gt_boxes, gt_labels, gt_valid, num_classes: int,
                    pc_range, voxel_size, out_size_factor: int, feature_size,
                    gaussian_overlap: float = 0.1,
                    min_radius: int = 2) -> torch.Tensor:
    """Dense heatmap targets (num_classes, H, W) of one sample's (G, >=7)
    world boxes (bottom-centre z)."""
    H, W = feature_size
    sx = voxel_size[0] * out_size_factor
    sy = voxel_size[1] * out_size_factor
    dims_x = gt_boxes[:, 3] / sx
    dims_y = gt_boxes[:, 4] / sy
    radius = gaussian_radius((dims_y, dims_x), min_overlap=gaussian_overlap)
    radius = torch.clamp(torch.floor(radius), min=float(min_radius))
    ok = gt_valid & (dims_x > 0) & (dims_y > 0)
    centers = torch.stack([(gt_boxes[:, 0] - pc_range[0]) / sx,
                           (gt_boxes[:, 1] - pc_range[1]) / sy], dim=-1)
    return draw_heatmap(centers, radius, gt_labels, ok, num_classes, H, W)

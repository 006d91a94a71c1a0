"""TransFusion-style box codec between world boxes and BEV-grid units.

Port of ``focalformer3d_tpu/core/box_coder.py`` (``encode``,
``decode_center``, ``decode_box``, ``decode``): fixed-shape outputs plus a
validity mask instead of the reference's boolean filtering.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..configs import BBoxCoderConfig


def encode(cfg: BBoxCoderConfig, boxes: torch.Tensor) -> torch.Tensor:
    """(..., 7|9) world boxes -> (..., code_size) regression targets: xy in
    grid units, z bottom -> gravity centre, log dims, (sin, cos) yaw and,
    for code_size 10, the velocity (zero when the boxes carry none)."""
    sx, sy = cfg.grid_step
    out = [(boxes[..., 0] - cfg.pc_range[0]) / sx,
           (boxes[..., 1] - cfg.pc_range[1]) / sy,
           boxes[..., 2] + 0.5 * boxes[..., 5],
           torch.log(boxes[..., 3] + 1e-6),
           torch.log(boxes[..., 4] + 1e-6),
           torch.log(boxes[..., 5] + 1e-6),
           torch.sin(boxes[..., 6]),
           torch.cos(boxes[..., 6])]
    if cfg.code_size == 10:
        vel = boxes[..., 7:9] if boxes.shape[-1] >= 9 else \
            boxes.new_zeros(boxes.shape[:-1] + (2,))
        out += [vel[..., 0], vel[..., 1]]
    return torch.stack(out, dim=-1)


def decode_center(cfg: BBoxCoderConfig, center_xy: torch.Tensor):
    sx, sy = cfg.grid_step
    return torch.stack([center_xy[..., 0] * sx + cfg.pc_range[0],
                        center_xy[..., 1] * sy + cfg.pc_range[1]], dim=-1)


def decode_box(cfg: BBoxCoderConfig, center, height, dim, rot,
               vel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Regression outputs -> world boxes (..., Q, 7|9): x, y, z_bottom,
    dx, dy, dz, yaw[, vx, vy]."""
    xy = decode_center(cfg, center)
    dims = torch.exp(dim)
    z_bottom = height[..., 0] - 0.5 * dims[..., 2]
    yaw = torch.atan2(rot[..., 0], rot[..., 1])
    parts = [xy, z_bottom[..., None], dims, yaw[..., None]]
    if vel is not None:
        parts.append(vel)
    return torch.cat(parts, dim=-1)


def decode(cfg: BBoxCoderConfig, heatmap, center, height, dim, rot,
           vel: Optional[torch.Tensor] = None,
           apply_filter: bool = False) -> Dict[str, torch.Tensor]:
    """Per-query class scores (..., Q, num_classes) and regressions ->
    bboxes (..., Q, 7|9), scores, labels (int32, first max), mask."""
    scores, _ = heatmap.max(dim=-1)
    labels = torch.argmax(heatmap, dim=-1).to(torch.int32)
    bboxes = decode_box(cfg, center, height, dim, rot, vel)
    mask = torch.ones_like(scores, dtype=torch.bool)
    if apply_filter:
        if cfg.score_threshold is not None:
            mask &= scores > cfg.score_threshold
        if cfg.post_center_range is not None:
            pcr = torch.tensor(cfg.post_center_range, dtype=bboxes.dtype,
                               device=bboxes.device)
            ctr = bboxes[..., :3]
            mask &= (ctr >= pcr[:3]).all(dim=-1)
            mask &= (ctr <= pcr[3:6]).all(dim=-1)
    return {"bboxes": bboxes, "scores": scores, "labels": labels,
            "mask": mask}

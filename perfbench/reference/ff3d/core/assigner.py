"""HungarianAssigner3D: focal-cls + BEV-L1 + (-IoU3D) cost, padded, masked.

Port of ``focalformer3d_tpu/core/assigner.py`` (``hungarian_assign_3d``,
``apply_gt_center_limit``), batched: every leading (sample, round) index
is one assignment problem, and all of them are solved together
(``hungarian.assign``). GTs are padded to a static G with a validity mask;
the result is a (Q,) GT index per query, -1 for background.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import torch

from . import hungarian, iou, losses


@dataclasses.dataclass(frozen=True)
class AssignerConfig:
    cls_weight: float = 0.15
    reg_weight: float = 0.25
    iou_weight: float = 0.25
    cls_gamma: float = 2.0
    cls_alpha: float = 0.25
    method: str = "auction"  # or "scipy"


def hungarian_assign_3d(cfg: AssignerConfig, bboxes: torch.Tensor,
                        cls_logits: torch.Tensor, gt_bboxes: torch.Tensor,
                        gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                        pc_range: Sequence[float]) -> Dict[str, torch.Tensor]:
    """bboxes (..., Q, 7|9) decoded world boxes; cls_logits (..., Q, C);
    gt_bboxes (..., G, 7|9) padded; gt_labels, gt_valid (..., G).

    Returns assigned_gt (..., Q) int32 (-1 background), max_overlaps
    (..., Q) (IoU3D with the matched GT, 0 for background), labels (..., Q)
    (-1 background) and iterations (the auction's loop count)."""
    cost = (losses.focal_loss_cost(cls_logits, gt_labels, cfg.cls_gamma,
                                   cfg.cls_alpha, cfg.cls_weight)
            + losses.bbox_bev_l1_cost(bboxes, gt_bboxes, pc_range,
                                      cfg.reg_weight))
    iou3d = iou.boxes_iou_3d(bboxes, gt_bboxes)
    cost = cost + -iou3d * cfg.iou_weight
    cost = torch.where(gt_valid[..., None, :], cost, hungarian.BIG_COST)
    q_valid = torch.ones(bboxes.shape[:-1], dtype=torch.bool,
                         device=bboxes.device)
    row_to_col, iters = hungarian.assign(cost, q_valid, gt_valid,
                                         method=cfg.method)
    matched = row_to_col >= 0
    safe = row_to_col.clamp(0, gt_bboxes.shape[-2] - 1).long()
    overlaps = torch.gather(iou3d, -1, safe[..., None])[..., 0]
    return {
        "assigned_gt": row_to_col,
        "max_overlaps": torch.where(matched, overlaps, 0.0).clamp(0.0, 1.0),
        "labels": torch.where(matched, torch.gather(gt_labels, -1, safe),
                              -1),
        "iterations": iters,
    }


def apply_gt_center_limit(assigned_gt: torch.Tensor, bboxes: torch.Tensor,
                          gt_bboxes: torch.Tensor,
                          limit: float) -> torch.Tensor:
    """Unassign matches whose BEV centre distance exceeds ``limit``.
    assigned_gt (..., Q); bboxes (..., Q, >=2); gt_bboxes (..., G, >=2)."""
    safe = assigned_gt.clamp(0, gt_bboxes.shape[-2] - 1).long()
    gxy = torch.gather(gt_bboxes[..., :2], -2,
                       safe[..., None].expand(*safe.shape, 2))
    d = torch.linalg.norm(bboxes[..., :2] - gxy, dim=-1)
    keep = (assigned_gt >= 0) & (d <= limit)
    return torch.where(keep, assigned_gt, -1)

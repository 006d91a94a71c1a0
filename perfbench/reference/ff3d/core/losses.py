"""Loss functions (sigmoid focal, gaussian focal, weighted L1) and match costs.

Port of ``focalformer3d_tpu/core/losses.py``: the mmdet numerics the
reference configures (FocalLoss gamma 2 alpha 0.25, GaussianFocalLoss alpha
2 gamma 4, L1Loss) as fixed-shape functions with an explicit
``avg_factor``.
"""
from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

Factor = Union[torch.Tensor, float]


def _mean(loss: torch.Tensor, avg_factor: Factor,
          loss_weight: float) -> torch.Tensor:
    return loss_weight * loss.sum() / torch.clamp(
        torch.as_tensor(avg_factor, dtype=loss.dtype, device=loss.device),
        min=1.0)


def clip_sigmoid(x: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Sigmoid clamped away from {0, 1} (mmdet3d ``clip_sigmoid``)."""
    return torch.clamp(torch.sigmoid(x), eps, 1.0 - eps)


def sigmoid_focal_loss(logits: torch.Tensor, labels: torch.Tensor,
                       weights: Optional[torch.Tensor] = None,
                       gamma: float = 2.0, alpha: float = 0.25,
                       avg_factor: Factor = 1.0,
                       loss_weight: float = 1.0) -> torch.Tensor:
    """logits (N, C); labels (N,) with C meaning background; weights
    (N,) or None."""
    num_classes = logits.shape[-1]
    target = F.one_hot(labels.long(), num_classes + 1)[..., :num_classes]
    target = target.to(logits.dtype)
    p = torch.sigmoid(logits)
    pt = (1.0 - p) * target + p * (1.0 - target)
    focal_weight = (alpha * target + (1.0 - alpha) * (1.0 - target)) \
        * pt ** gamma
    bce = (torch.clamp(logits, min=0) - logits * target
           + torch.log1p(torch.exp(-logits.abs())))
    loss = (bce * focal_weight).sum(-1)
    if weights is not None:
        loss = loss * weights
    return _mean(loss, avg_factor, loss_weight)


def gaussian_focal_loss(pred: torch.Tensor, gaussian_target: torch.Tensor,
                        weights: Optional[torch.Tensor] = None,
                        alpha: float = 2.0, gamma: float = 4.0,
                        avg_factor: Factor = 1.0,
                        loss_weight: float = 1.0) -> torch.Tensor:
    """pred: probabilities in (0, 1); gaussian_target in [0, 1]."""
    eps = 1e-12
    pos_w = (gaussian_target == 1.0).to(pred.dtype)
    neg_w = (1.0 - gaussian_target) ** gamma
    pos_loss = -torch.log(pred + eps) * (1.0 - pred) ** alpha * pos_w
    neg_loss = -torch.log(1.0 - pred + eps) * pred ** alpha * neg_w
    loss = pos_loss + neg_loss
    if weights is not None:
        loss = loss * weights
    return _mean(loss, avg_factor, loss_weight)


def l1_loss(pred: torch.Tensor, target: torch.Tensor,
            weights: Optional[torch.Tensor] = None,
            avg_factor: Factor = 1.0,
            loss_weight: float = 1.0) -> torch.Tensor:
    loss = (pred - target).abs()
    if weights is not None:
        loss = loss * weights
    return _mean(loss, avg_factor, loss_weight)


def focal_loss_cost(cls_logits: torch.Tensor, gt_labels: torch.Tensor,
                    gamma: float = 2.0, alpha: float = 0.25,
                    weight: float = 1.0, eps: float = 1e-12) -> torch.Tensor:
    """mmdet ``FocalLossCost``: (..., Q, G) classification matching cost of
    logits (..., Q, C) against labels (..., G)."""
    p = torch.sigmoid(cls_logits)
    neg_cost = -torch.log(1.0 - p + eps) * (1.0 - alpha) * p ** gamma
    pos_cost = -torch.log(p + eps) * alpha * (1.0 - p) ** gamma
    cost = pos_cost - neg_cost  # (..., Q, C)
    idx = gt_labels.long()[..., None, :].expand(*cost.shape[:-1], -1)
    return torch.gather(cost, -1, idx) * weight


def bbox_bev_l1_cost(bboxes: torch.Tensor, gt_bboxes: torch.Tensor,
                     pc_range, weight: float = 1.0) -> torch.Tensor:
    """BBoxBEVL1Cost: L1 between pc-range-normalised BEV centres of
    (..., Q, >=2) and (..., G, >=2) boxes, (..., Q, G)."""
    start = torch.tensor(pc_range[:2], dtype=bboxes.dtype,
                         device=bboxes.device)
    extent = torch.tensor(pc_range[3:5], dtype=bboxes.dtype,
                          device=bboxes.device) - start
    q = (bboxes[..., :2] - start) / extent
    g = (gt_bboxes[..., :2] - start) / extent
    return weight * (q[..., :, None, :] - g[..., None, :, :]).abs().sum(-1)

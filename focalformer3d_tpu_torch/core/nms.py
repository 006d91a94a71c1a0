"""Score-based box selection: top-k, circle NMS and rotated-BEV NMS.

Port of ``focalformer3d_tpu/core/nms.py``. Every function returns a keep
mask over fixed-size inputs. Orders break ties as the JAX versions do (a
stable ascending sort, reversed): among equal scores the higher index
comes first.

The greedy pass of NMS is sequential over the boxes in score order. The
suppression matrix is built on the tensors' device; ``_suppress_loop``
then copies it to the host once and runs the greedy pass in numpy, so a
pass over N boxes costs one device sync, not N.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .iou import boxes_iou_bev


def _descending(scores: torch.Tensor) -> torch.Tensor:
    """``jnp.argsort(scores)[::-1]`` over the last axis."""
    return torch.sort(scores, dim=-1, stable=True).indices.flip(-1)


def _suppress_loop(order: torch.Tensor, suppress_mat: torch.Tensor
                   ) -> torch.Tensor:
    """Greedy NMS from a score order and a pairwise suppression matrix.

    order: (N,) indices by descending score; suppress_mat: (N, N) bool in
    the original index space, [i, j] true where i, if kept, suppresses j.
    Returns the keep mask (N,) in the original index space."""
    n = order.shape[0]
    sup = suppress_mat[order][:, order].cpu().numpy()
    alive = np.ones(n, dtype=bool)
    for i in np.flatnonzero(sup.any(axis=1)):  # rows that suppress at all
        if alive[i]:
            alive[i + 1:] &= ~sup[i, i + 1:]
    keep = torch.zeros(n, dtype=torch.bool, device=order.device)
    keep[order] = torch.from_numpy(alive).to(order.device)
    return keep


def _masked(scores: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return torch.where(valid, scores, torch.full_like(scores, -float("inf")))


def circle_nms(centers_xy: torch.Tensor, scores: torch.Tensor,
               valid: torch.Tensor, radius: float) -> torch.Tensor:
    """Centre-distance NMS: of two valid boxes closer than ``radius`` the
    higher-scored one stays (mmdet3d's squared-distance rule)."""
    order = _descending(_masked(scores, valid))
    d2 = ((centers_xy[:, None, :] - centers_xy[None, :, :]) ** 2).sum(-1)
    sup = (d2 < radius * radius) & valid[None, :] & valid[:, None]
    return _suppress_loop(order, sup) & valid


def nms_from_iou(iou: torch.Tensor, scores: torch.Tensor,
                 valid: torch.Tensor, iou_threshold: float,
                 pre_max_size: Optional[int] = None) -> torch.Tensor:
    """``rotated_nms_bev`` on a given (N, N) IoU matrix of the boxes."""
    masked = _masked(scores, valid)
    if pre_max_size is not None and pre_max_size < scores.shape[0]:
        kth = torch.sort(masked).values.flip(0)[pre_max_size - 1]
        valid = valid & (masked >= kth)
        masked = _masked(scores, valid)
    sup = (iou > iou_threshold) & valid[None, :] & valid[:, None]
    return _suppress_loop(_descending(masked), sup) & valid


def rotated_nms_bev(boxes: torch.Tensor, scores: torch.Tensor,
                    valid: torch.Tensor, iou_threshold: float,
                    pre_max_size: Optional[int] = None) -> torch.Tensor:
    """Rotated-rectangle IoU NMS over (N, >=7) world boxes; keep mask (N,).

    ``pre_max_size`` keeps only the top-K valid scores (ties at the K-th
    score all stay) before the greedy pass, as a mask."""
    return nms_from_iou(boxes_iou_bev(boxes, boxes), scores, valid,
                        iou_threshold, pre_max_size)


def top_k_mask(scores: torch.Tensor, valid: torch.Tensor,
               k: int) -> torch.Tensor:
    """Keep-mask over the last axis selecting the top-k valid scores."""
    idx = _descending(_masked(scores, valid))[..., :k]
    keep = torch.zeros_like(valid).scatter_(-1, idx, True)
    return keep & valid

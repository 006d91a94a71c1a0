"""Score-based box selection (port of ``top_k_mask`` from
``focalformer3d_tpu/core/nms.py``; rotated NMS is a later slice)."""
from __future__ import annotations

import torch


def top_k_mask(scores: torch.Tensor, valid: torch.Tensor,
               k: int) -> torch.Tensor:
    """Keep-mask over the last axis selecting the top-k valid scores.

    Ties break as in the JAX version (a stable ascending sort, reversed):
    among equal scores the higher index wins."""
    s = torch.where(valid, scores, torch.full_like(scores, -float("inf")))
    idx = torch.sort(s, dim=-1, stable=True).indices.flip(-1)[..., :k]
    keep = torch.zeros_like(valid).scatter_(-1, idx, True)
    return keep & valid

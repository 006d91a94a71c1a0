"""Multi-scale deformable attention sampling core (MSDeformAttn).

Port of ``focalformer3d_tpu/ops/msda.py``, batched. The JAX version is plain
XLA (per-level, per-head bilinear sampling); here each level is one
``F.grid_sample`` call with the heads folded into the batch, which has the
same align_corners=False / zero-padding convention. Sampling and the
weighted sum run in float32, and the result is cast back to the value dtype.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def msda_sample(value_levels: Sequence[torch.Tensor],
                locations: torch.Tensor, weights: torch.Tensor,
                num_heads: int) -> torch.Tensor:
    """value_levels: per level (B, H_l, W_l, C); locations (B, Q, nH, L, P,
    2) in [0, 1] per level; weights (B, Q, nH, L, P), softmaxed over
    (L, P). Returns (B, Q, C)."""
    B, Q, nH, L, P, _ = locations.shape
    C = value_levels[0].shape[-1]
    Dh = C // num_heads
    out = torch.zeros((B * nH, Dh, Q), dtype=torch.float32,
                      device=locations.device)
    for lvl, v in enumerate(value_levels):
        H, W = v.shape[1], v.shape[2]
        # (B, H, W, nH, Dh) -> (B*nH, Dh, H, W)
        vh = v.float().reshape(B, H, W, nH, Dh).permute(0, 3, 4, 1, 2)
        vh = vh.reshape(B * nH, Dh, H, W)
        grid = 2.0 * locations[:, :, :, lvl].float() - 1.0  # (B,Q,nH,P,2)
        grid = grid.permute(0, 2, 1, 3, 4).reshape(B * nH, Q, P, 2)
        s = F.grid_sample(vh, grid, mode="bilinear", padding_mode="zeros",
                          align_corners=False)  # (B*nH, Dh, Q, P)
        w = weights[:, :, :, lvl].float().permute(0, 2, 1, 3)
        out = out + (s * w.reshape(B * nH, 1, Q, P)).sum(-1)
    out = out.reshape(B, nH, Dh, Q).permute(0, 3, 1, 2).reshape(B, Q, C)
    return out.to(value_levels[0].dtype)

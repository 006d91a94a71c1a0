"""k x k local-window attention on 2D maps (the ``bevfusion`` neck's
``P_IML``).

Port of ``focalformer3d_tpu/ops/local_attn.py`` (``local_attention``) on
plain torch ops: the key and value maps are zero-padded by k // 2 once,
and each of the k^2 window offsets reads a shifted view of them, so the
peak footprint is (..., H, W, k^2) logits rather than (..., H, W, k^2, C)
gathered keys. Out-of-image neighbours get the logit -1e9 before the
softmax, as in JAX.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def local_attention(query: torch.Tensor, key: torch.Tensor,
                    value: torch.Tensor, kernel_size: int = 9
                    ) -> torch.Tensor:
    """query, key, value (..., H, W, C) -> (..., H, W, C).

    logits[p, d] = <query[p], key[p + d]>; out[p] = sum_d softmax_d(logits)
    * value[p + d], over the kernel_size^2 offsets d in row-major order
    (dy, then dx)."""
    H, W = query.shape[-3], query.shape[-2]
    r = kernel_size // 2
    pad = (0, 0, r, r, r, r)  # C, then W, then H
    kp = F.pad(key, pad)
    vp = F.pad(value, pad)
    offsets = [(dy, dx) for dy in range(kernel_size)
               for dx in range(kernel_size)]
    logits = torch.stack(
        [(query * kp[..., dy:dy + H, dx:dx + W, :]).sum(-1)
         for dy, dx in offsets], dim=-1)
    ones = F.pad(query.new_ones((H, W)), (r, r, r, r))
    valid = torch.stack([ones[dy:dy + H, dx:dx + W] > 0.5
                         for dy, dx in offsets], dim=-1)
    logits = torch.where(valid, logits, logits.new_tensor(-1e9))
    w = torch.softmax(logits, dim=-1)
    out = torch.zeros_like(value)
    for i, (dy, dx) in enumerate(offsets):
        out = out + vp[..., dy:dy + H, dx:dx + W, :] * w[..., i:i + 1]
    return out

"""GridMask image augmentation, drawn from an explicit ``torch.Generator``.

Port of ``focalformer3d_tpu/models/grid_mask.py`` (``grid_mask``), the
reference's GridMask with (use_h, use_w, rotate=1, offset=False,
ratio=0.5, mode=1, prob=0.7): with probability ``prob`` the images keep a
grid of horizontal and vertical strips (mode 1) and are zeroed elsewhere.
rotate=1 draws a rotation of 0 always, so there is none. The strip period
``d`` is drawn from [2, H), the strip width is ``round(d * ratio)``
clipped to [1, d - 1], and each axis's phase is drawn wide and taken mod
``d``, as JAX does; the mask is placed as the reference's 1.5x canvas
crops it. Every draw stays on the generator's device, so the step does not
wait for the host.

The draws cannot match JAX's ``jax.random`` ones, so the tests hold the
function to its properties, and replace it (``grid_mask`` is looked up on
this module by the train step) where a step is compared with JAX's.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def grid_mask(generator: Optional[torch.Generator], imgs: torch.Tensor,
              ratio: float = 0.5, mode: int = 1,
              prob: float = 0.7) -> torch.Tensor:
    """imgs (..., H, W, C) -> the same with one grid mask applied to all
    (or, with probability ``1 - prob``, unchanged)."""
    H, W = imgs.shape[-3], imgs.shape[-2]
    dev = imgs.device

    def draw_int(lo, hi):
        return torch.randint(lo, hi, (), generator=generator, device=dev)

    apply = torch.rand((), generator=generator, device=dev) < prob
    d = draw_int(2, H)
    l = torch.clamp(torch.floor(d * ratio + 0.5).long(), min=1)
    l = torch.minimum(l, d - 1)
    st_h = draw_int(0, 2 ** 30) % d
    st_w = draw_int(0, 2 ** 30) % d
    off_h = (math.floor(1.5 * H) - H) // 2
    off_w = (math.floor(1.5 * W) - W) // 2
    ii = torch.arange(H, device=dev)
    jj = torch.arange(W, device=dev)
    row_hit = torch.remainder(ii + off_h - st_h, d) < l
    col_hit = torch.remainder(jj + off_w - st_w, d) < l
    mask = ~(row_hit[:, None] | col_hit[None, :])  # 1 = keep (mode 0)
    if mode == 1:
        mask = ~mask
    out = imgs * mask.to(imgs.dtype)[..., None]
    return torch.where(apply, out, imgs)

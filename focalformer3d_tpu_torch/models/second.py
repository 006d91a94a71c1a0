"""SECOND BEV backbone + SECONDFPN neck, eval mode, NHWC.

Port of ``focalformer3d_tpu/models/second.py``. The modules mirror mmdet3d's
layout (``blocks.{i}`` = [Conv2d, BN, ReLU] * (layers + 1), ``deblocks.{i}``
= [Conv2d 1x1 or ConvTranspose2d 2x2/s2, BN, ReLU]) so reference checkpoint
keys load as they are. Batch norm eps is 1e-3 here, as in the reference.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import apply_bn, conv2d_nhwc


class SECOND(nn.Module):
    def __init__(self, in_channels: int,
                 out_channels: Sequence[int] = (128, 256),
                 layer_nums: Sequence[int] = (5, 5),
                 layer_strides: Sequence[int] = (1, 2)):
        super().__init__()
        self.strides = tuple(layer_strides)
        blocks = []
        cin = in_channels
        for ch, n in zip(out_channels, layer_nums):
            layers = []
            for j in range(n + 1):
                layers += [nn.Conv2d(cin if j == 0 else ch, ch, 3, bias=False),
                           nn.BatchNorm2d(ch, eps=1e-3), nn.ReLU()]
            blocks.append(nn.Sequential(*layers))
            cin = ch
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> List[torch.Tensor]:
        """x (B, H, W, C) -> per-block (B, H_i, W_i, C_i) maps."""
        outs = []
        for block, stride in zip(self.blocks, self.strides):
            mods = list(block)
            for j in range(0, len(mods), 3):
                x = conv2d_nhwc(x, mods[j].weight, None,
                                stride if j == 0 else 1, 1, dtype=dtype)
                x = F.relu(apply_bn(x, mods[j + 1]))
            outs.append(x)
        return outs


class SECONDFPN(nn.Module):
    def __init__(self, in_channels: Sequence[int],
                 out_channels: Sequence[int] = (256, 256),
                 upsample_strides: Sequence[int] = (1, 2)):
        super().__init__()
        self.strides = tuple(upsample_strides)
        deblocks = []
        for cin, ch, s in zip(in_channels, out_channels, upsample_strides):
            up = (nn.Conv2d(cin, ch, 1, bias=False) if s == 1 else
                  nn.ConvTranspose2d(cin, ch, s, stride=s, bias=False))
            deblocks.append(nn.Sequential(up, nn.BatchNorm2d(ch, eps=1e-3),
                                          nn.ReLU()))
        self.deblocks = nn.ModuleList(deblocks)

    def forward(self, feats: Sequence[torch.Tensor],
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        ups = []
        for x, deblock, s in zip(feats, self.deblocks, self.strides):
            up, bn = deblock[0], deblock[1]
            dt = dtype or x.dtype
            if s == 1:
                y = conv2d_nhwc(x, up.weight, dtype=dt)
            else:
                y = F.conv_transpose2d(x.permute(0, 3, 1, 2).to(dt),
                                       up.weight.to(dt), stride=s)
                y = y.permute(0, 2, 3, 1)
            ups.append(F.relu(apply_bn(y, bn)))
        return torch.cat(ups, dim=-1)

"""ResNet image backbone and FPN neck, NHWC at every forward.

Port of ``focalformer3d_tpu/models/resnet.py`` (``Bottleneck``,
``BasicBlockR``, ``ResNet``, ``FPN``): the mmdet modules of the LC configs
(ResNet-50, out_indices (0, 1, 2, 3), ``norm_eval``; FPN [256, 512, 1024,
2048] -> 256 x 5 outputs). Submodules carry the reference checkpoint's
names (``conv1``/``bn1``, ``layer{s}.{b}.conv{n}``/``bn{n}``/
``downsample.{0,1}``; ``lateral_convs.{i}.conv``, ``fpn_convs.{i}.conv``).

``norm_eval`` keeps every batch norm of the backbone in inference mode
when the module trains (``train()`` re-evals them), as mmdet and the JAX
module do. FPN upsamples with JAX's nearest rule (``jax.image.resize``:
source index ``floor((i + 0.5) * in / out)`` in float32), which is
``i // 2`` at the factor 2 of the configs' image sizes and differs from
``F.interpolate(mode="nearest")`` where a size does not halve evenly.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import apply_bn, conv2d_nhwc


def _conv_bn(x, conv: nn.Conv2d, bn, relu: bool):
    y = conv2d_nhwc(x, conv.weight, conv.bias, conv.stride[0],
                    conv.padding[0])
    y = apply_bn(y, bn)
    return F.relu(y) if relu else y


class Bottleneck(nn.Module):
    """torchvision/mmdet 'pytorch-style' bottleneck: stride on the 3x3."""

    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out)
        self.downsample = nn.Sequential(
            nn.Conv2d(cin, out, 1, stride, bias=False),
            nn.BatchNorm2d(out)) if downsample else None

    def forward(self, x):
        y = _conv_bn(x, self.conv1, self.bn1, True)
        y = _conv_bn(y, self.conv2, self.bn2, True)
        y = _conv_bn(y, self.conv3, self.bn3, False)
        identity = x if self.downsample is None else _conv_bn(
            x, self.downsample[0], self.downsample[1], False)
        return F.relu(y + identity)


class BasicBlockR(nn.Module):
    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = nn.Sequential(
            nn.Conv2d(cin, planes, 1, stride, bias=False),
            nn.BatchNorm2d(planes)) if downsample else None

    def forward(self, x):
        y = _conv_bn(x, self.conv1, self.bn1, True)
        y = _conv_bn(y, self.conv2, self.bn2, False)
        identity = x if self.downsample is None else _conv_bn(
            x, self.downsample[0], self.downsample[1], False)
        return F.relu(y + identity)


_ARCH = {
    18: (BasicBlockR, (2, 2, 2, 2)),
    34: (BasicBlockR, (3, 4, 6, 3)),
    50: (Bottleneck, (3, 4, 6, 3)),
    101: (Bottleneck, (3, 4, 23, 3)),
}


class ResNet(nn.Module):
    """Returns the feature maps at ``out_indices`` (strides 4/8/16/32)."""

    def __init__(self, depth: int = 50,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 norm_eval: bool = True):
        super().__init__()
        block, layers = _ARCH[depth]
        self.out_indices = tuple(out_indices)
        self.norm_eval = norm_eval
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        cin, planes = 64, 64
        self.out_channels: List[int] = []
        for stage, n_blocks in enumerate(layers):
            stride = 1 if stage == 0 else 2
            blocks = []
            for b in range(n_blocks):
                first = b == 0
                ds = first and (stride != 1
                                or cin != planes * block.expansion)
                blocks.append(block(cin, planes, stride if first else 1, ds))
                cin = planes * block.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
            self.out_channels.append(cin)
            planes *= 2

    def train(self, mode: bool = True):
        super().train(mode)
        if self.norm_eval:
            for m in self.modules():
                if isinstance(m, nn.BatchNorm2d):
                    m.eval()
        return self

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """x (B, H, W, 3) -> the maps at ``out_indices``, NHWC."""
        x = _conv_bn(x, self.conv1, self.bn1, True)
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        outs = []
        for stage in range(len(self.out_channels)):
            for block in getattr(self, f"layer{stage + 1}"):
                x = block(x)
            if stage in self.out_indices:
                outs.append(x)
        return tuple(outs)


class ConvModule(nn.Module):
    """mmcv ConvModule without norm or activation: ``.conv`` with bias."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, padding=(k - 1) // 2)

    def forward(self, x):
        return conv2d_nhwc(x, self.conv.weight, self.conv.bias, 1,
                           self.conv.padding[0])


def resize_nearest(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """(B, h, w, C) -> (B, H, W, C) by ``jax.image.resize``'s nearest rule:
    source index ``floor((i + 0.5) * in / out)``, computed in float32."""
    for axis, n in ((1, hw[0]), (2, hw[1])):
        m = x.shape[axis]
        if m == n:
            continue
        src = torch.floor((torch.arange(n, dtype=torch.float32,
                                        device=x.device) + 0.5)
                          * m / n).long()
        x = x.index_select(axis, src)
    return x


class FPN(nn.Module):
    """mmdet FPN: lateral 1x1 + nearest top-down sum + 3x3 output convs;
    outputs past the inputs' count by a stride-2 max-pool of the last."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 num_outs: int = 5):
        super().__init__()
        self.num_outs = num_outs
        self.lateral_convs = nn.ModuleList(
            ConvModule(c, out_channels, 1) for c in in_channels)
        self.fpn_convs = nn.ModuleList(
            ConvModule(out_channels, out_channels, 3) for _ in in_channels)

    def forward(self, feats: Sequence[torch.Tensor],
                num_levels: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
        """The first ``num_levels`` outputs (all ``num_outs`` by default);
        the top-down path always runs whole, the output convs of levels past
        ``num_levels`` do not."""
        n = self.num_outs if num_levels is None else num_levels
        laterals = [lat(f) for lat, f in zip(self.lateral_convs, feats)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + resize_nearest(
                laterals[i], laterals[i - 1].shape[1:3])
        outs = [conv(lat) for conv, lat in
                list(zip(self.fpn_convs, laterals))[:n]]
        while len(outs) < n:
            outs.append(outs[-1][:, ::2, ::2])
        return tuple(outs)

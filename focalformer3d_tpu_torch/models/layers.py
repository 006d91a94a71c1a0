"""Shared building blocks, NHWC at every forward.

Port of ``focalformer3d_tpu/models/layers.py`` (``ConvBN``,
``MaskedBatchNorm``, ``BasicBlock2d``, ``InvertedResidual``, ``MLP``,
``PredictionFFN``, ``sine_embed_2d``). Submodules carry the reference
checkpoint's names (mmcv ConvModule ``.conv``/``.bn``, torchvision
``InvertedResidual.conv.N``, DINO ``MLP.layers.N``, TransFusion FFN
``{head}.0.conv``/``{head}.0.bn``/``{head}.1``), so a reference-format
state dict loads with ``strict=True``.

Every forward takes and returns channels-last tensors, as the JAX modules
do; the convs run on NCHW views of them. Compute runs in the ``dtype``
argument (parameters stay float32 and are cast at use). Batch norm follows
its module's ``training`` flag (``apply_bn``): in eval it is the running
statistics' per-channel affine; in training it normalises with the batch
statistics and updates the running ones as flax does.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import mesh


def bn_affine(bn: nn.modules.batchnorm._BatchNorm):
    """(g, b) with bn(x) == x * g + b in eval mode, float32."""
    g = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    return g, bn.bias - bn.running_mean * g


def apply_bn(x: torch.Tensor, bn,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batch norm over the last (channel) axis, in x's dtype.

    Eval: the running statistics' affine. Training, with flax's semantics
    (statistics in f32, the biased variance, running averages updated in
    place with decay ``1 - bn.momentum``):

    - ``mask`` None: ``flax.linen.BatchNorm`` over every row, variance
      ``E[x^2] - E[x]^2`` clipped at 0, ``(x - mean) * (rsqrt(var + eps) *
      scale) + bias``;
    - ``mask`` given (broadcastable to x[..., 0]): ``MaskedBatchNorm``,
      statistics over the masked rows only (at least one counted), variance
      ``E[(x - mean)^2]``; every row is normalised.

    SyncBN: in training the statistics are sums over every rank's rows
    (JAX's batch axis is global, so its batch norm is cross-replica),
    through the differentiable ``mesh.all_reduce_sum``, which returns its
    input outside a process group: the plain branch one collective of
    (sum x, sum x^2, rows), the masked one two, (sum x, rows) and then
    sum m (x - mean)^2, JAX's two-pass formula; the one-row clamp applies
    to the global count. Eval runs no collective. Every rank must reach
    every training batch norm, in the same order."""
    if not bn.training:
        g, b = bn_affine(bn)
        return x * g.to(x.dtype) + b.to(x.dtype)
    xf = x.float()
    dims = tuple(range(x.dim() - 1))
    if mask is None:
        c = xf.shape[-1]
        s = mesh.all_reduce_sum(torch.cat([
            xf.sum(dims), (xf * xf).sum(dims),
            xf.new_full((1,), xf.numel() // c)]), "bn")
        mean = s[:c] / s[-1]
        var = torch.clamp(s[c:2 * c] / s[-1] - mean * mean, min=0.0)
        y = (xf - mean) * (torch.rsqrt(var + bn.eps) * bn.weight) + bn.bias
    else:
        m = mask.float()[..., None]
        s = mesh.all_reduce_sum(torch.cat([
            (xf * m).sum(dims), m.sum().reshape(1)]), "bn")
        cnt = torch.clamp(s[-1], min=1.0)
        mean = s[:-1] / cnt
        var = mesh.all_reduce_sum((m * (xf - mean) ** 2).sum(dims),
                                  "bn") / cnt
        y = (xf - mean) * torch.rsqrt(var + bn.eps) * bn.weight + bn.bias
    with torch.no_grad():
        decay = 1.0 - bn.momentum
        bn.running_mean.mul_(decay).add_(mean.detach() * bn.momentum)
        bn.running_var.mul_(decay).add_(var.detach() * bn.momentum)
    return y.to(x.dtype)


def conv2d_nhwc(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None, stride: int = 1,
                padding: int = 0, groups: int = 1,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """2D conv of a (B, H, W, C) tensor with a torch (O, I, kH, kW) weight."""
    dt = dtype or x.dtype
    y = F.conv2d(x.permute(0, 3, 1, 2).to(dt), weight.to(dt),
                 None if bias is None else bias.to(dt), stride, padding, 1,
                 groups)
    return y.permute(0, 2, 3, 1)


def linear(x: torch.Tensor, lin: nn.Module,
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    dt = dtype or x.dtype
    b = lin.bias.to(dt) if lin.bias is not None else None
    return F.linear(x.to(dt), lin.weight.to(dt), b)


def filled(values: Sequence[float], device) -> torch.Tensor:
    """A float32 vector of ``values`` on ``device``, written there one fill
    a value: ``torch.tensor`` of a Python list is a blocking copy from
    pageable host memory on a card, a host sync that no CUDA graph can
    capture. The values round to float32 as ``torch.tensor`` rounds
    them."""
    out = torch.empty(len(values), dtype=torch.float32, device=device)
    for i, v in enumerate(values):
        out[i].fill_(v)
    return out


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout`` in training, its bits from ``generator``: keep
    each element with probability ``1 - rate``, scaled by ``1 / (1 - rate)``.
    The caller applies it only in training."""
    if rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


class ConvBN(nn.Module):
    """mmcv ConvModule: Conv2d (no bias) + BatchNorm2d (+ ReLU)."""

    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1,
                 act: bool = True, eps: float = 1e-5):
        super().__init__()
        self.stride, self.pad, self.act = stride, (k - 1) // 2, act
        self.conv = nn.Conv2d(cin, cout, k, stride, self.pad, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=eps)

    def forward(self, x, dtype=None):
        y = conv2d_nhwc(x, self.conv.weight, None, self.stride, self.pad,
                        dtype=dtype)
        y = apply_bn(y, self.bn)
        return F.relu(y) if self.act else y


class BasicBlock2d(nn.Module):
    """torchvision ``resnet.BasicBlock`` (two 3x3 conv + BN, identity
    skip; ``conv1``/``bn1``/``conv2``/``bn2``), the camera BEV's
    ``iterimg`` block. Batch norm decay 0.9, as the JAX ``ConvBN``."""

    def __init__(self, c: int):
        super().__init__()
        self.conv1 = nn.Conv2d(c, c, 3, 1, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(c)
        self.conv2 = nn.Conv2d(c, c, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(c)

    def forward(self, x, dtype=None):
        y = conv2d_nhwc(x, self.conv1.weight, None, 1, 1, dtype=dtype)
        y = F.relu(apply_bn(y, self.bn1))
        y = conv2d_nhwc(y, self.conv2.weight, None, 1, 1, dtype=dtype)
        y = apply_bn(y, self.bn2)
        return F.relu(y + x)


# flax's BatchNorm decay 0.99 as torch's momentum (InvertedResidual,
# SECOND, the prediction heads and the RoI MLP; ConvBN keeps 0.9 = 0.1)
FLAX_BN_MOMENTUM = 0.01


def _conv_bn_relu6(cin: int, cout: int, k: int, groups: int = 1):
    return nn.Sequential(
        nn.Conv2d(cin, cout, k, 1, (k - 1) // 2, groups=groups, bias=False),
        nn.BatchNorm2d(cout, momentum=FLAX_BN_MOMENTUM),
        nn.ReLU6(),
    )


class InvertedResidual(nn.Module):
    """torchvision MobileNetV2 inverted residual, stride 1: expand 1x1
    (skipped when expand == 1) -> depthwise 3x3 -> project 1x1; residual
    only when cin == cout."""

    def __init__(self, cin: int, cout: int, expand: int):
        super().__init__()
        hidden = cin * expand
        layers = []
        if expand != 1:
            layers.append(_conv_bn_relu6(cin, hidden, 1))
        layers += [
            _conv_bn_relu6(hidden, hidden, 3, groups=hidden),
            nn.Conv2d(hidden, cout, 1, bias=False),
            nn.BatchNorm2d(cout, momentum=FLAX_BN_MOMENTUM),
        ]
        self.conv = nn.Sequential(*layers)
        self.use_res = cin == cout

    def forward(self, x, dtype=None):
        y = x
        mods = list(self.conv)
        for block in mods[:-2]:
            conv, bn = block[0], block[1]
            y = conv2d_nhwc(y, conv.weight, None, 1, conv.padding[0],
                            conv.groups, dtype)
            y = F.relu6(apply_bn(y, bn))
        y = conv2d_nhwc(y, mods[-2].weight, dtype=dtype)
        y = apply_bn(y, mods[-1])
        return (x + y).to(y.dtype) if self.use_res else y


class MLP(nn.Module):
    """DINO MLP: ReLU between layers, linear out (``layers.N``)."""

    def __init__(self, cin: int, hidden: int, cout: int, num_layers: int):
        super().__init__()
        dims = [cin] + [hidden] * (num_layers - 1) + [cout]
        self.layers = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:])
        )

    def forward(self, x, dtype=None):
        for i, lin in enumerate(self.layers):
            x = linear(x, lin, dtype)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class _ConvModule1d(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, 1, bias=False)
        self.bn = nn.BatchNorm1d(cout, momentum=FLAX_BN_MOMENTUM)


class PredictionFFN(nn.ModuleDict):
    """TransFusion FFN prediction heads over (B, Q, C) query features: per
    head Conv1d(k=1, no bias) + BN1d + ReLU, then Conv1d(k=1) out. Outputs
    are float32."""

    def __init__(self, cin: int, heads: Dict[str, int], head_conv: int = 64):
        super().__init__({
            name: nn.Sequential(
                _ConvModule1d(cin, head_conv),
                nn.Conv1d(head_conv, out, 1, bias=True),
            )
            for name, out in heads.items()
        })

    def forward(self, x, dtype=None) -> Dict[str, torch.Tensor]:
        dt = dtype or x.dtype
        out = {}
        for name, (cm, conv_out) in self.items():
            y = F.linear(x.to(dt), cm.conv.weight[..., 0].to(dt))
            y = F.relu(apply_bn(y, cm.bn))
            y = F.linear(y, conv_out.weight[..., 0].to(dt),
                         conv_out.bias.to(dt))
            out[name] = y.float()
        return out


def sine_embed_2d(pos: torch.Tensor, num_feats: int = 128) -> torch.Tensor:
    """(..., 2) normalized positions -> (..., 2*num_feats): interleaved
    sin/cos with 10000^(2i/num_feats) temperatures, y block then x."""
    scale = 2 * math.pi
    dim_t = torch.arange(num_feats, dtype=torch.float32, device=pos.device)
    dim_t = 10000.0 ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                        / num_feats)

    def embed(v):
        p = v[..., None] * scale / dim_t
        e = torch.stack([torch.sin(p[..., 0::2]), torch.cos(p[..., 1::2])],
                        dim=-1)
        return e.reshape(*e.shape[:-2], -1)

    return torch.cat([embed(pos[..., 1]), embed(pos[..., 0])], dim=-1)

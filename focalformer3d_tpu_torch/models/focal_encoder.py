"""FocalEncoder fusion neck, LiDAR-only ``bevfusionmb2`` branch, eval, NHWC.

Port of ``focalformer3d_tpu/models/focal_encoder.py`` without the camera
branch: a shared 3x3 conv projects the SECOND-FPN BEV to the hidden width,
each layer mixes it with MobileNetV2 inverted residuals (``P_IML``,
``P_out_proj``, ``P_integration``), and ``extra_output`` adds the decoder's
value map. The camera projections (LSS, I2P) and the ``bevfusion`` local
attention variant are later slices.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from .layers import ConvBN, InvertedResidual, conv2d_nhwc


class FocalEncoderLayer(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.P_IML = InvertedResidual(hidden, hidden, 2)
        self.P_out_proj = InvertedResidual(2 * hidden, hidden, 1)
        self.P_integration = InvertedResidual(2 * hidden, hidden, 1)

    def forward(self, lidar_feat, dtype=None):
        # LiDAR-only: the image-to-BEV feature is the LiDAR map itself
        p2p = self.P_IML(lidar_feat, dtype)
        aug = self.P_out_proj(torch.cat([lidar_feat, p2p], dim=-1), dtype)
        return self.P_integration(torch.cat([aug, lidar_feat], dim=-1), dtype)


class FocalEncoder(nn.Module):
    def __init__(self, pts_in: int, hidden: int = 128, num_layers: int = 1,
                 iterbev: str = "bevfusionmb2", extra_feat: bool = True):
        super().__init__()
        if iterbev != "bevfusionmb2":
            raise NotImplementedError(f"iterbev {iterbev!r} is not ported")
        self.shared_conv_pts = nn.Conv2d(pts_in, hidden, 3, padding=1)
        self.fusion_blocks = nn.ModuleList(
            FocalEncoderLayer(hidden) for _ in range(num_layers)
        )
        self.extra_output = (ConvBN(hidden, hidden, 3, act=False)
                             if extra_feat else None)

    def forward(self, pts_feats: torch.Tensor,
                dtype: Optional[torch.dtype] = None
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """pts_feats (B, H, W, C) -> (pts_feat_conv, stage feats [+ extra])."""
        x = conv2d_nhwc(pts_feats, self.shared_conv_pts.weight,
                        self.shared_conv_pts.bias, 1, 1, dtype=dtype)
        pts_feat_conv = x
        stage_feats = []
        for layer in self.fusion_blocks:
            x = layer(x, dtype)
            stage_feats.append(x)
        if not stage_feats:
            stage_feats = [x]
        if self.extra_output is not None:
            stage_feats.append(self.extra_output(stage_feats[-1], dtype))
        return pts_feat_conv, stage_feats

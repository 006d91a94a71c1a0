"""FocalEncoder fusion neck, NHWC.

Port of ``focalformer3d_tpu/models/focal_encoder.py``
(``LocalContextBlock``, ``FocalEncoderLayer``, ``FocalEncoder``): a shared
3x3 conv projects the SECOND-FPN BEV to the hidden width; each fusion
layer mixes it with the camera BEV (where there is one) and collects one
BEV map per Hard-Instance-Probing stage; ``extra_output`` adds the
decoder's value map.

Layer variants:
  ``bevfusionmb2`` - MobileNetV2 inverted residuals (``P_IML``,
                     ``P_out_proj``, ``P_integration``; LiDAR-only configs)
  ``bevfusion``    - ``P_IML`` a 9 x 9 local-window attention block
                     (``LocalContextBlock``), ``P_out_proj`` and
                     ``P_integration`` 1x1 ConvBN (the LC configs)

Camera: ``cam_proj="lss"`` lifts the FPN level-0 features with
``LiftSplatShoot`` (``cam_lss``) into the camera BEV, which each layer
reads as its image-to-BEV feature and updates with ``iterimg_conv`` (a
torchvision BasicBlock). ``freeze_camlss`` runs the LSS without autograd
(the detector keeps it in eval mode). ``cam_proj="i2p"`` is ROADMAP.md
Queue 1 item 8b and raises.

Camera-only (``input_pts=False``): with no fusion layer the camera BEV
feeds the head directly, as the reference's ``focal_encoder.py:196-209``
and the JAX module's docstring say. The JAX module takes that path only
when the decoder has no heatmap stage; with ``DeformFormer3D_C_R50``'s one
stage it feeds the head a zero canvas and ignores the images (ROADMAP.md
Queue 3). With fusion layers the zero canvas (``bev_shape``) is the LiDAR
map they start from, as in JAX.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from ..configs import LSSConfig
from ..ops.local_attn import local_attention
from .layers import BasicBlock2d, ConvBN, InvertedResidual, conv2d_nhwc
from .lss import LiftSplatShoot

I2P = ("cam_proj 'i2p' (I2P, FocalFormer3D_LC_Proj) is not ported yet "
       "(ROADMAP.md, Queue 1 item 8b)")


class LocalContextBlock(nn.Module):
    """LocalContextAttentionBlock: two-layer 1x1 ConvBNReLU query and key
    projections, a one-layer value projection, then k x k window
    attention."""

    def __init__(self, c: int, kernel_size: int = 9):
        super().__init__()
        self.kernel_size = kernel_size
        self.query_project = nn.ModuleList(ConvBN(c, c, 1) for _ in range(2))
        self.key_project = nn.ModuleList(ConvBN(c, c, 1) for _ in range(2))
        self.value_project = ConvBN(c, c, 1)

    def forward(self, query_map, key_map, dtype=None):
        q, k = query_map, key_map
        for mq, mk in zip(self.query_project, self.key_project):
            q, k = mq(q, dtype), mk(k, dtype)
        v = self.value_project(key_map, dtype)
        return local_attention(q, k, v, self.kernel_size)


class FocalEncoderLayer(nn.Module):
    def __init__(self, hidden: int, iterbev: str = "bevfusionmb2",
                 with_img: bool = False):
        super().__init__()
        if iterbev == "bevfusionmb2":
            self.P_IML = InvertedResidual(hidden, hidden, 2)
            self.P_out_proj = InvertedResidual(2 * hidden, hidden, 1)
            self.P_integration = InvertedResidual(2 * hidden, hidden, 1)
        elif iterbev == "bevfusion":
            self.P_IML = LocalContextBlock(hidden, 9)
            self.P_out_proj = ConvBN(2 * hidden, hidden, 1, act=False)
            self.P_integration = ConvBN(2 * hidden, hidden, 1, act=False)
        else:
            raise NotImplementedError(f"iterbev {iterbev!r} is not ported")
        self.iterbev = iterbev
        self.iterimg_conv = (nn.Sequential(BasicBlock2d(hidden))
                             if with_img else None)

    def forward(self, img_feat: Optional[torch.Tensor],
                lidar_feat: torch.Tensor, dtype=None, last: bool = False
                ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
        """(camera BEV or None, LiDAR BEV) -> (updated camera BEV or None,
        new LiDAR BEV). ``last``: the layer's camera update feeds nothing
        after it, so it runs only in training (its batch norm statistics
        move there, as in JAX)."""
        i2p_feat = lidar_feat if img_feat is None else img_feat
        if self.iterbev == "bevfusionmb2":
            p2p = self.P_IML(lidar_feat, dtype)
        else:
            p2p = self.P_IML(lidar_feat, lidar_feat, dtype)
        aug = self.P_out_proj(torch.cat([i2p_feat, p2p], dim=-1), dtype)
        new_lidar = self.P_integration(torch.cat([aug, lidar_feat], dim=-1),
                                       dtype)
        new_img = None
        if img_feat is not None and (self.training or not last):
            new_img = self.iterimg_conv[0](img_feat, dtype)
        return new_img, new_lidar


class FocalEncoder(nn.Module):
    def __init__(self, pts_in: int, hidden: int = 128, num_layers: int = 1,
                 iterbev: str = "bevfusionmb2", extra_feat: bool = True,
                 input_img: bool = False, input_pts: bool = True,
                 cam_proj: str = "", lss: Optional[LSSConfig] = None,
                 bev_shape: Tuple[int, int] = (180, 180),
                 freeze_camlss: bool = False):
        super().__init__()
        if input_img and cam_proj == "i2p":
            raise NotImplementedError(I2P)
        if input_img and cam_proj != "lss":
            raise ValueError(f"cam_proj {cam_proj!r}")
        if not (input_img or input_pts):
            raise ValueError("a model needs the points or the images")
        self.input_pts = input_pts
        self.hidden = hidden
        self.bev_shape = tuple(bev_shape)
        self.freeze_camlss = freeze_camlss
        self.shared_conv_pts = (nn.Conv2d(pts_in, hidden, 3, padding=1)
                                if input_pts else None)
        self.cam_lss = LiftSplatShoot(lss) if input_img else None
        self.fusion_blocks = nn.ModuleList(
            FocalEncoderLayer(hidden, iterbev, input_img)
            for _ in range(num_layers))
        self.extra_output = (ConvBN(hidden, hidden, 3, act=False)
                             if extra_feat else None)

    def forward(self, pts_feats: Optional[torch.Tensor],
                dtype: Optional[torch.dtype] = None,
                img_data: Optional[Dict[str, torch.Tensor]] = None,
                mark: Optional[Callable[[str], None]] = None
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """pts_feats (B, H, W, C) SECOND-FPN BEV (None without points),
        ``img_data`` the camera arrays (None without images: ``img_feats``,
        ``cam2lidar_rot``, ``cam2lidar_trans``, optional ``img_aug`` and
        ``bev_aug``) -> (pts_feat_conv, stage feats [+ extra]). The LSS
        runs without autograd under ``freeze_camlss``."""
        img_feat = None
        if self.cam_lss is not None and img_data is not None:
            frozen = (torch.no_grad() if self.freeze_camlss
                      else contextlib.nullcontext())
            with frozen:
                img_feat, _depth = self.cam_lss(
                    img_data["img_feats"], img_data["cam2lidar_rot"],
                    img_data["cam2lidar_trans"], img_data.get("img_aug"),
                    img_data.get("bev_aug"), mark)
        if self.input_pts:
            x = conv2d_nhwc(pts_feats, self.shared_conv_pts.weight,
                            self.shared_conv_pts.bias, 1, 1, dtype=dtype)
        elif not len(self.fusion_blocks):
            x = img_feat  # camera-only: the camera BEV feeds the head
        else:
            x = img_feat.new_zeros((img_feat.shape[0],) + self.bev_shape
                                   + (self.hidden,))
        pts_feat_conv = x
        stage_feats = []
        n = len(self.fusion_blocks)
        for i, layer in enumerate(self.fusion_blocks):
            img_feat, x = layer(img_feat, x, dtype, last=i == n - 1)
            stage_feats.append(x)
        if not stage_feats:
            stage_feats = [x]
        if self.extra_output is not None:
            stage_feats.append(self.extra_output(stage_feats[-1], dtype))
        return pts_feat_conv, stage_feats

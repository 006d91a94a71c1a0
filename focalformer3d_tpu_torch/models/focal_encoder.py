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
(the detector keeps it in eval mode). ``cam_proj="i2p"``
(FocalFormer3D_LC_Proj): ``shared_conv_img``, a 3x3 conv, projects every
camera's FPN level 0 from 256 channels to the hidden width, and the first
fusion layer's ``I2P_block`` (every layer's without ``iter_bev_cam``)
projects it onto the LiDAR BEV (``models/i2p.py``); its output is the
camera BEV that layer reads, and later layers read and update it with
``iterimg_conv`` as they do the LSS BEV.

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
from ..utils.profiler import span
from .i2p import I2P
from .layers import BasicBlock2d, ConvBN, InvertedResidual, conv2d_nhwc
from .lss import LiftSplatShoot


def _without_cudnn():
    """ATen's own convolution for ``shared_conv_img``: on its float32 input
    (six 112 x 200 x 256 maps, TF32 off) cuDNN picks an algorithm that
    took 236-332 ms and 17.2 GiB of workspace a sample on an NVIDIA H100
    80GB HBM3 in every layout tried (NHWC view, contiguous NCHW, a
    channels_last weight); ATen's took 3.1 ms and 0.45 GiB, within 2.2e-6
    of it (PERF.md, open question 1). The other cuDNN flags stay as the
    caller set them."""
    b = torch.backends.cudnn
    return b.flags(enabled=False, benchmark=b.benchmark,
                   deterministic=b.deterministic, allow_tf32=b.allow_tf32)


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
                 with_img: bool = False, i2p: Optional[dict] = None):
        super().__init__()
        # ``I2P(hidden, **i2p)`` where the layer projects the cameras itself
        self.I2P_block = I2P(hidden, **i2p) if i2p is not None else None
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
                lidar_feat: torch.Tensor, dtype=None, last: bool = False,
                img_data: Optional[Dict[str, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None,
                mark: Optional[Callable[[str], None]] = None
                ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
        """(camera BEV or None, LiDAR BEV) -> (updated camera BEV or None,
        new LiDAR BEV). ``last``: the layer's camera update feeds nothing
        after it, so it runs only in training (its batch norm statistics
        move there, as in JAX). With an ``I2P_block`` the camera input is
        the cameras' projected features (B, Ncam, fH, fW, C), which it
        turns into the camera BEV with ``img_data``'s ``lidar2img``,
        ``img_aug`` and ``bev_aug`` (its dropout drawn from ``generator``)
        in the span "I2P", which calls ``mark("I2P")``."""
        if self.I2P_block is not None:
            with span("I2P", mark):
                img_feat = self.I2P_block(
                    lidar_feat, img_feat, img_data["lidar2img"],
                    img_data.get("img_aug"), img_data.get("bev_aug"),
                    generator)
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
                 freeze_camlss: bool = False, iter_bev_cam: bool = True,
                 max_points_height: int = 10):
        super().__init__()
        if input_img and cam_proj not in ("lss", "i2p"):
            raise ValueError(f"cam_proj {cam_proj!r}")
        if not (input_img or input_pts):
            raise ValueError("a model needs the points or the images")
        self.input_pts = input_pts
        self.hidden = hidden
        self.bev_shape = tuple(bev_shape)
        self.freeze_camlss = freeze_camlss
        self.shared_conv_pts = (nn.Conv2d(pts_in, hidden, 3, padding=1)
                                if input_pts else None)
        project = input_img and cam_proj == "i2p"
        self.cam_lss = (LiftSplatShoot(lss) if input_img and not project
                        else None)
        self.shared_conv_img = (nn.Conv2d(lss.input_channels, hidden, 3,
                                          padding=1) if project else None)
        i2p = (dict(max_points_height=max_points_height,
                    pc_range=lss.pc_range, input_shape=lss.img_scale)
               if project else None)
        self.fusion_blocks = nn.ModuleList(
            FocalEncoderLayer(hidden, iterbev, input_img,
                              i2p if not iter_bev_cam or i == 0 else None)
            for i in range(num_layers))
        self.extra_output = (ConvBN(hidden, hidden, 3, act=False)
                             if extra_feat else None)

    def forward(self, pts_feats: Optional[torch.Tensor],
                dtype: Optional[torch.dtype] = None,
                img_data: Optional[Dict[str, torch.Tensor]] = None,
                mark: Optional[Callable[[str], None]] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """pts_feats (B, H, W, C) SECOND-FPN BEV (None without points),
        ``img_data`` the camera arrays (None without images: ``img_feats``,
        ``cam2lidar_rot`` and ``cam2lidar_trans`` for the LSS,
        ``lidar2img`` for I2P, optional ``img_aug`` and ``bev_aug``) ->
        (pts_feat_conv, stage feats [+ extra]). The LSS runs without
        autograd under ``freeze_camlss``; I2P's dropout draws from
        ``generator``. With I2P, ``shared_conv_img`` runs in the span
        "image proj", which calls ``mark("image proj")``."""
        img_feat = None
        if self.shared_conv_img is not None and img_data is not None:
            f = img_data["img_feats"]  # (B, Ncam, fH, fW, 256), float32
            with span("image proj", mark), _without_cudnn():
                img_feat = conv2d_nhwc(
                    f.flatten(0, 1), self.shared_conv_img.weight,
                    self.shared_conv_img.bias, 1, 1).unflatten(
                        0, f.shape[:2])
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
            img_feat, x = layer(img_feat, x, dtype, i == n - 1, img_data,
                                generator, mark)
            stage_feats.append(x)
        if not stage_feats:
            stage_feats = [x]
        if self.extra_output is not None:
            stage_feats.append(self.extra_output(stage_feats[-1], dtype))
        return pts_feat_conv, stage_feats

"""FocalFormer3D detector, LiDAR only.

Port of ``focalformer3d_tpu/models/detector.py`` (``preprocess_points``,
``FocalFormer3D``, ``get_bboxes``): voxelization with the mean VFE ->
SparseEncoder -> SECOND -> SECONDFPN -> FocalEncoder -> FocalDecoder ->
boxes. Submodules carry the reference checkpoint's top-level names
(``pts_middle_encoder``, ``pts_backbone``, ``pts_neck``, ``imgpts_neck``,
``pts_bbox_head``). The module's ``training`` flag is the JAX ``train``
argument: in eval the sparse encoder's dense boundary is
``sparse_dense_from_eval`` and batch norm uses its running statistics; in
training the boundary is ``sparse_dense_from``, batch norm uses batch
statistics and updates the running ones, and the head adds its denoising
GT groups and dropouts (``training/train_step.py`` drives it).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from ..configs import DetectorConfig
from ..ops import voxelize as vox
from . import focal_decoder as fd
from .focal_encoder import FocalEncoder
from .second import SECOND, SECONDFPN
from .sparse_encoder import SparseEncoder


def preprocess_points(cfg: DetectorConfig, points: torch.Tensor,
                      mask: torch.Tensor, train: bool = False
                      ) -> Dict[str, torch.Tensor]:
    """Batched hard voxelization + mean VFE. points (B, N, D), mask (B, N).

    Inference uses the test-time voxel cap when the config sets one;
    ``train=True`` keeps the training cap ``max_voxels``."""
    if cfg.vfe_type != "HardSimpleVFE":
        raise NotImplementedError(f"vfe {cfg.vfe_type!r} is not ported")
    vcfg = cfg.voxel
    if not train and vcfg.max_voxels_test:
        vcfg = dataclasses.replace(vcfg, max_voxels=vcfg.max_voxels_test)
    outs = [vox.hard_voxelize_simple(vcfg, points[b], mask[b])
            for b in range(points.shape[0])]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def _sparse_out_z(cfg: DetectorConfig) -> int:
    """z planes left after the strided chain and the conv_out collapse."""
    z = cfg.sparse_shape[0]
    for s in range(len(cfg.encoder_channels) - 1):
        z = (z + 2 * cfg.down_paddings[s][0] - 3) // 2 + 1
    return (z - 3) // 2 + 1


class FocalFormer3D(nn.Module):
    def __init__(self, cfg: DetectorConfig):
        super().__init__()
        if cfg.input_img or not cfg.input_pts:
            raise NotImplementedError("the camera branch is not ported")
        self.cfg = cfg
        self.pts_middle_encoder = SparseEncoder(
            in_channels=cfg.point_dim,
            sparse_shape=cfg.sparse_shape,
            output_channels=cfg.sparse_out_channels,
            encoder_channels=cfg.encoder_channels,
            down_paddings=cfg.down_paddings,
            capacities=cfg.capacities,
            out_capacity=cfg.out_capacity,
            engine=cfg.sparse_engine,
            dense_from=cfg.sparse_dense_from_eval,
            train_dense_from=cfg.sparse_dense_from,
        )
        self.pts_backbone = SECOND(
            cfg.sparse_out_channels * _sparse_out_z(cfg),
            cfg.second_channels, cfg.second_layers,
        )
        self.pts_neck = SECONDFPN(cfg.second_channels, cfg.fpn_channels)
        self.imgpts_neck = FocalEncoder(
            sum(cfg.fpn_channels), cfg.hidden, cfg.neck_layers, cfg.iterbev,
            cfg.extra_feat,
        )
        self.pts_bbox_head = fd.FocalDecoder(cfg.decoder)

    def forward(self, voxel_data: Dict[str, torch.Tensor],
                gt_boxes: Optional[torch.Tensor] = None,
                gt_labels: Optional[torch.Tensor] = None,
                gt_valid: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """voxel_data from ``preprocess_points``; in training the padded GT
        (boxes (B, G, 9), labels, validity) for the head's denoising groups
        and the generator of its dropouts and noise. Returns the head's
        dict."""
        dt = self.cfg.tdtype
        bev = self.pts_middle_encoder(voxel_data["features"],
                                      voxel_data["coords"],
                                      voxel_data["voxel_mask"])
        fpn = self.pts_neck(self.pts_backbone(bev, dt), dt)
        pts_feat_conv, stage_feats = self.imgpts_neck(fpn, dt)
        return self.pts_bbox_head(pts_feat_conv, stage_feats, gt_boxes,
                                  gt_labels, gt_valid, generator)

    def get_bboxes(self, out: Dict[str, torch.Tensor], max_out: int = 200):
        return get_bboxes(self.cfg, out, max_out)


def get_bboxes(cfg: DetectorConfig, out: Dict[str, torch.Tensor],
               max_out: int = 200) -> Dict[str, torch.Tensor]:
    return fd.get_bboxes(cfg.decoder, out, max_out)

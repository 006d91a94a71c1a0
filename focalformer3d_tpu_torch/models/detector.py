"""FocalFormer3D detector: LiDAR, camera and LiDAR + camera.

Port of ``focalformer3d_tpu/models/detector.py`` (``preprocess_points``,
``FocalFormer3D``, ``get_bboxes``): [image branch: ResNet + FPN, level 0
-> the LSS camera BEV in the neck] + [point branch: voxelization with the
mean VFE (hard or dynamic, both parameter-free), or hard voxelization and
the ``HardVFE`` PointNet (the Waymo configs) -> SparseEncoder -> SECOND ->
SECONDFPN] -> FocalEncoder fusion neck -> FocalDecoder -> boxes.
Submodules carry the reference checkpoint's top-level names
(``pts_voxel_encoder``, ``pts_middle_encoder``, ``pts_backbone``,
``pts_neck``, ``img_backbone``, ``img_neck``, ``imgpts_neck``,
``pts_bbox_head``). The module's
``training`` flag is the JAX ``train`` argument: in eval the sparse
encoder's dense boundary is ``sparse_dense_from_eval`` and batch norm uses
its running statistics; in training the boundary is ``sparse_dense_from``,
batch norm uses batch statistics and updates the running ones, and the
head adds its denoising GT groups and dropouts (``training/train_step.py``
drives it). The image branch and the LSS compute in float32 whatever
``compute_dtype`` says, as the JAX modules do (they take no dtype).

Camera inputs (``img_data``): ``imgs`` (B, Ncam, H, W, 3), ``lidar2img``
(B, Ncam, 4, 4) and, optionally, the recorded augmentations ``img_aug``
(B, Ncam, 4, 4) and ``bev_aug`` (B, 4, 4); cam2lidar is
``torch.linalg.inv(lidar2img)``. The neck gets FPN level 0 of every camera
with these arrays (``image_features``): the LSS reads cam2lidar, I2P
(``cam_proj="i2p"``, FocalFormer3D_LC_Proj) ``lidar2img``. With
``input_pts=False`` (the camera-only ``DeformFormer3D_C_R50``) there is no
voxelization and no point branch, and the camera BEV feeds the head
(``models/focal_encoder.py``).

Branch freezing, as the JAX detector does it (``detector.py:174-273``):
a frozen branch stays in eval mode when the model trains, so its batch
norm uses and keeps its running statistics, and it runs without autograd,
so its backward launches no kernel (JAX cuts the gradient at its output).
``freeze_pts`` covers ``pts_middle_encoder``, ``pts_backbone`` and
``pts_neck`` (the encoder then takes the eval dense boundary), and the
parameters of ``pts_voxel_encoder``, whose batch norm follows the model's
mode as JAX's VFE follows its ``train`` argument;
``freeze_img`` the image backbone and FPN; ``freeze_camlss`` the LSS
(``imgpts_neck.cam_lss``). Which parameters a flag freezes is decided
here, by ``trainable_mask``: the model marks them ``requires_grad=False``
when it is built, as the reference does, and the optimizer
(``training/optim``) takes only the parameters that require a gradient.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Iterable, List, Optional

import torch
from torch import nn

from ..configs import DetectorConfig
from ..ops import voxelize as vox
from ..utils.profiler import span
from . import focal_decoder as fd
from .focal_encoder import FocalEncoder
from .resnet import FPN, ResNet
from .second import SECOND, SECONDFPN
from .sparse_encoder import SparseEncoder
from .vfe import HardVFE


def preprocess_points(cfg: DetectorConfig, points: torch.Tensor,
                      mask: torch.Tensor, train: bool = False
                      ) -> Dict[str, torch.Tensor]:
    """Batched voxelization (+ mean VFE). points (B, N, D), mask (B, N).

    ``HardSimpleVFE``: hard voxelization, the mean of each voxel's first
    ``max_num_points`` points; ``DynamicSimpleVFE``: dynamic voxelization,
    the mean of all its points. Either returns features, coords and
    voxel_mask. ``HardVFE``: hard voxelization alone (``hard_voxelize``:
    voxels, num_points, coords, voxel_mask), for the model's
    ``pts_voxel_encoder``. Inference uses the test-time voxel cap when the
    config sets one; ``train=True`` keeps the training cap
    ``max_voxels``."""
    voxelize = {"HardSimpleVFE": vox.hard_voxelize_simple,
                "DynamicSimpleVFE": vox.dynamic_voxelize,
                "HardVFE": vox.hard_voxelize}.get(cfg.vfe_type)
    if voxelize is None:
        raise NotImplementedError(f"vfe {cfg.vfe_type!r} is not ported")
    vcfg = cfg.voxel
    if not train and vcfg.max_voxels_test:
        vcfg = dataclasses.replace(vcfg, max_voxels=vcfg.max_voxels_test)
    with span("voxelize"):
        outs = [voxelize(vcfg, points[b], mask[b])
                for b in range(points.shape[0])]
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def _frozen_prefixes(cfg: DetectorConfig) -> List[str]:
    """Module prefixes frozen by the reference's staged finetune flags
    (focalformer3d.py:80-131): ``freeze_pts`` covers the point branch and
    ``imgpts_neck.shared_conv_pts``; ``freeze_img`` the image backbone and
    neck; ``freeze_camlss`` the LSS module."""
    prefixes = []
    if cfg.freeze_img:
        prefixes += ["img_backbone", "img_neck"]
    if cfg.freeze_camlss:
        prefixes += ["imgpts_neck.cam_lss"]
    if cfg.freeze_pts:
        prefixes += ["vfe", "pts_voxel_encoder", "pts_middle_encoder",
                     "pts_backbone", "pts_neck",
                     "imgpts_neck.shared_conv_pts"]
    return prefixes


def trainable_mask(cfg: DetectorConfig, names: Iterable[str]
                   ) -> Dict[str, bool]:
    """True per trainable parameter name (reference state-dict key), False
    per one the config's freeze flags freeze."""
    prefixes = _frozen_prefixes(cfg)
    return {n: not any(n.startswith(p) or f".{p}" in n for p in prefixes)
            for n in names}


def _sparse_out_z(cfg: DetectorConfig) -> int:
    """z planes left after the strided chain and the conv_out collapse."""
    z = cfg.sparse_shape[0]
    for s in range(len(cfg.encoder_channels) - 1):
        z = (z + 2 * cfg.down_paddings[s][0] - 3) // 2 + 1
    return (z - 3) // 2 + 1


class FocalFormer3D(nn.Module):
    def __init__(self, cfg: DetectorConfig):
        super().__init__()
        self.cfg = cfg
        if cfg.input_pts:
            if cfg.vfe_type == "HardVFE":
                self.pts_voxel_encoder = HardVFE(
                    cfg.point_dim, cfg.vfe_channels,
                    voxel_size=cfg.voxel.voxel_size,
                    point_cloud_range=cfg.voxel.point_cloud_range)
            self.pts_middle_encoder = SparseEncoder(
                in_channels=cfg.voxel_feature_dim,
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
        if cfg.input_img:
            self.img_backbone = ResNet(cfg.img_backbone_depth)
            self.img_neck = FPN(self.img_backbone.out_channels, 256,
                                cfg.img_fpn_outs)
        self.imgpts_neck = FocalEncoder(
            sum(cfg.fpn_channels), cfg.hidden, cfg.neck_layers, cfg.iterbev,
            cfg.extra_feat, cfg.input_img, cfg.input_pts,
            cfg.cam_proj if cfg.input_img else "", cfg.lss, cfg.bev_shape,
            cfg.freeze_camlss, cfg.iter_bev_cam, cfg.max_points_height,
        )
        self.pts_bbox_head = fd.FocalDecoder(cfg.decoder)
        keep = trainable_mask(cfg, [n for n, _ in self.named_parameters()])
        for n, p in self.named_parameters():
            p.requires_grad_(keep[n])

    def frozen_branches(self) -> List[nn.Module]:
        """The submodules that the config's freeze flags keep in eval mode
        and out of autograd."""
        cfg, out = self.cfg, []
        if cfg.input_img and cfg.freeze_img:
            out += [self.img_backbone, self.img_neck]
        if cfg.input_img and cfg.freeze_camlss:
            out += [self.imgpts_neck.cam_lss]
        if cfg.input_pts and cfg.freeze_pts:
            out += [self.pts_middle_encoder, self.pts_backbone, self.pts_neck]
        return out

    def train(self, mode: bool = True):
        super().train(mode)
        for m in self.frozen_branches():
            m.eval()
        return self

    def image_features(self, img_data: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
        """ResNet + FPN level 0 of every camera, float32, and the camera
        geometry: the neck's camera arrays."""
        imgs = img_data["imgs"]
        B, N = imgs.shape[:2]
        frozen = (torch.no_grad() if self.cfg.freeze_img
                  else contextlib.nullcontext())
        with frozen:
            feats = self.img_backbone(imgs.flatten(0, 1).float())
            lvl0 = self.img_neck(feats, num_levels=1)[0]
        lidar2img = img_data["lidar2img"].float()
        inv = torch.linalg.inv(lidar2img)
        return {"img_feats": lvl0.unflatten(0, (B, N)),
                "lidar2img": lidar2img,
                "cam2lidar_rot": inv[..., :3, :3],
                "cam2lidar_trans": inv[..., :3, 3],
                "img_aug": img_data.get("img_aug"),
                "bev_aug": img_data.get("bev_aug")}

    def forward(self, voxel_data: Optional[Dict[str, torch.Tensor]],
                gt_boxes: Optional[torch.Tensor] = None,
                gt_labels: Optional[torch.Tensor] = None,
                gt_valid: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                mark: Optional[Callable[[str], None]] = None,
                img_data: Optional[Dict[str, torch.Tensor]] = None
                ) -> Dict[str, torch.Tensor]:
        """voxel_data from ``preprocess_points`` (None without the point
        branch); ``img_data`` the camera inputs (None without the image
        branch); in training the padded GT (boxes (B, G, 9), labels,
        validity) for the head's denoising groups and the generator of its
        dropouts and noise. ``mark(stage)``, if given, is called as each
        stage ends: "image backbone + FPN", "HardVFE" (the Waymo configs'
        PointNet), the encoder's (see
        ``SparseEncoder.forward``), "SECOND + neck", the LSS's ("LSS lift",
        "LSS splat", "BevEncode"; or, with ``cam_proj="i2p"``, "image
        proj" after ``shared_conv_img`` and "I2P" after the first fusion
        layer's projection, ``shared_conv_pts`` included),
        "FocalEncoder" (the fusion layers) and "decoder". The generator
        also draws I2P's dropout. Each stage runs in a ``utils/profiler``
        span of its name, which calls ``mark``; the decoder's holds the
        spans of its heatmap stages and rounds. Returns the head's dict."""
        cfg = self.cfg
        dt = cfg.tdtype
        neck_img = None
        if cfg.input_img and img_data is not None:
            with span("image backbone + FPN", mark):
                neck_img = self.image_features(img_data)
        fpn = None
        if cfg.input_pts:
            frozen = (torch.no_grad() if cfg.freeze_pts
                      else contextlib.nullcontext())
            with frozen:
                feats = voxel_data.get("features")
                if cfg.vfe_type == "HardVFE":
                    with span("HardVFE", mark):
                        feats = self.pts_voxel_encoder(
                            voxel_data["voxels"], voxel_data["num_points"],
                            voxel_data["coords"])
                bev = self.pts_middle_encoder(feats,
                                              voxel_data["coords"],
                                              voxel_data["voxel_mask"], mark)
                with span("SECOND + neck", mark):
                    fpn = self.pts_neck(self.pts_backbone(bev, dt), dt)
        with span("FocalEncoder", mark):
            pts_feat_conv, stage_feats = self.imgpts_neck(
                fpn, dt, neck_img, mark, generator)
        with span("decoder", mark):
            return self.pts_bbox_head(pts_feat_conv, stage_feats, gt_boxes,
                                      gt_labels, gt_valid, generator)

    def get_bboxes(self, out: Dict[str, torch.Tensor], max_out: int = 200):
        return get_bboxes(self.cfg, out, max_out)


def get_bboxes(cfg: DetectorConfig, out: Dict[str, torch.Tensor],
               max_out: int = 200) -> Dict[str, torch.Tensor]:
    return fd.get_bboxes(cfg.decoder, out, max_out)

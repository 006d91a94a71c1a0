"""Model configurations, mirrored field for field from the JAX package.

Counterparts of ``focalformer3d_tpu.ops.voxelize.VoxelConfig``,
``models.detector.DetectorConfig`` / ``with_compute_dtype``,
``models.focal_decoder.FocalDecoderConfig``, ``models.lss.LSSConfig``,
``core.box_coder.BBoxCoderConfig`` and ``configs.focalformer3d_l
.TrainRecipe``. Field names, defaults and the 13 named configs of the
JAX registry (the nuScenes LiDAR and camera configs and the five Waymo
configs: model, loss, training recipe, class names, dataset and, where a
config has them, the image size, the TTA passes and the Waymo
``load_interval``) are identical, so
``focalformer3d_tpu.utils.ref_keys.reference_state_shapes(cfg)`` accepts a
config of either package. Only the dtype properties differ: they return
torch dtypes here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch


def _torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


@dataclasses.dataclass(frozen=True)
class VoxelConfig:
    point_cloud_range: Sequence[float]  # (x0, y0, z0, x1, y1, z1)
    voxel_size: Sequence[float]  # (vx, vy, vz)
    max_num_points: int = 10  # per-voxel cap (hard mode)
    max_voxels: int = 120000
    max_voxels_test: Optional[int] = None  # None = same as max_voxels

    @property
    def grid_size(self):
        """(nx, ny, nz) — number of voxels along each axis."""
        pcr = self.point_cloud_range
        vs = self.voxel_size
        return (
            int(round((pcr[3] - pcr[0]) / vs[0])),
            int(round((pcr[4] - pcr[1]) / vs[1])),
            int(round((pcr[5] - pcr[2]) / vs[2])),
        )


@dataclasses.dataclass(frozen=True)
class BBoxCoderConfig:
    pc_range: Sequence[float]  # (x_min, y_min) of the point cloud range
    voxel_size: Sequence[float]  # (vx, vy)
    out_size_factor: int
    post_center_range: Optional[Sequence[float]] = None
    score_threshold: Optional[float] = None
    code_size: int = 10

    @property
    def grid_step(self):
        return (
            self.out_size_factor * self.voxel_size[0],
            self.out_size_factor * self.voxel_size[1],
        )


@dataclasses.dataclass(frozen=True)
class LSSConfig:
    """Camera lift-splat settings (``models/lss.py`` re-exports it): the
    network input size, the depth bins, the BEV voxel grid and the
    channels of the lifted points and of the encoded BEV."""

    img_scale: Tuple[int, int] = (448, 800)
    camera_depth_range: Tuple[float, float, float] = (4.0, 45.0, 1.0)
    pc_range: Tuple[float, ...] = (-54.0, -54.0, -5.0, 54.0, 54.0, 3.0)
    downsample: int = 4
    grid: float = 0.6
    input_channels: int = 256
    cam_channels: int = 64
    out_channels: int = 128

    @property
    def feat_hw(self) -> Tuple[int, int]:
        return (self.img_scale[0] // self.downsample,
                self.img_scale[1] // self.downsample)

    @property
    def depth_bins(self) -> int:
        lo, hi, step = self.camera_depth_range
        return int(math.ceil((hi - lo) / step))

    @property
    def nx(self) -> Tuple[int, int, int]:
        return (
            int((self.pc_range[3] - self.pc_range[0]) / self.grid),
            int((self.pc_range[4] - self.pc_range[1]) / self.grid),
            int((self.pc_range[5] - self.pc_range[2]) / self.grid),
        )


@dataclasses.dataclass(frozen=True)
class FocalDecoderConfig:
    num_classes: int = 10
    hidden: int = 128
    hidden_roi: int = 512
    num_proposals: int = 300
    num_decoder_layers: int = 2  # decoder rounds (outer)
    inner_layers: int = 3  # deformable layers per round
    num_heads: int = 8
    nms_kernel_size: int = 3
    mask_heatmap_mode: str = "poscls"  # 'poscls' | 'pos' | 'boxcls'
    heatmap_box: bool = False  # dense per-class box heads (boxcls mode)
    multistage_heatmap: int = 1
    reuse_first_heatmap: bool = True
    extra_feat: bool = True
    multiscale: bool = True
    bevpos: bool = True
    roi_feats: int = 7
    roi_dropout: float = 0.1
    roi_based_reg: bool = True
    roi_expand_ratio: float = 1.2
    classaware_reg: bool = False
    add_gt_groups: int = 3
    add_gt_pos_thresh: float = 5.0
    add_gt_pos_boxnoise_thresh: float = 0.75
    gt_center_limit: float = 5.0
    max_gts: int = 200
    kernel1_classes: Tuple[int, ...] = (8, 9)
    code_size: int = 10
    pc_range: Tuple[float, ...] = (-54.0, -54.0, -5.0, 54.0, 54.0, 3.0)
    voxel_size: Tuple[float, ...] = (0.075, 0.075, 0.2)
    out_size_factor: int = 8
    post_center_range: Tuple[float, ...] = (
        -61.2, -61.2, -10.0, 61.2, 61.2, 10.0
    )
    score_threshold: float = 0.0
    dtype: str = "float32"  # head compute dtype; params stay float32

    @property
    def tdtype(self) -> torch.dtype:
        return _torch_dtype(self.dtype)

    @property
    def total_stages(self) -> int:
        return self.multistage_heatmap + int(self.reuse_first_heatmap)

    @property
    def with_vel(self) -> bool:
        return self.code_size == 10

    @property
    def coder(self) -> BBoxCoderConfig:
        return BBoxCoderConfig(
            pc_range=self.pc_range[:2],
            voxel_size=self.voxel_size[:2],
            out_size_factor=self.out_size_factor,
            post_center_range=self.post_center_range,
            score_threshold=self.score_threshold,
            code_size=self.code_size,
        )


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    voxel: VoxelConfig = dataclasses.field(
        default_factory=lambda: VoxelConfig(
            point_cloud_range=(-54.0, -54.0, -5.0, 54.0, 54.0, 3.0),
            voxel_size=(0.075, 0.075, 0.2),
            max_num_points=10,
            max_voxels=120000,
        )
    )
    vfe_type: str = "HardSimpleVFE"
    vfe_channels: Tuple[int, ...] = (64,)
    sparse_shape: Tuple[int, int, int] = (41, 1440, 1440)
    sparse_out_channels: int = 128
    encoder_channels: Tuple[Tuple[int, ...], ...] = (
        (16, 16, 32), (32, 32, 64), (64, 64, 128), (128, 128)
    )
    down_paddings: Tuple[Tuple[int, int, int], ...] = (
        (1, 1, 1), (1, 1, 1), (0, 1, 1)
    )
    capacities: Tuple[int, ...] = (160000, 245760, 188416, 77824)
    out_capacity: int = 53248
    # 'auto' runs the CUDA kernel engine for tensors on a card and the
    # plain engine on the CPU; 'cuda', 'cuda_mxu', 'cuda_zrun' and 'plain'
    # pick one explicitly (models/sparse_encoder.py)
    sparse_engine: str = "auto"
    sparse_exact_fallback: bool = True  # no counterpart: rulebooks are exact
    sparse_dense_from: int = 3
    sparse_dense_from_eval: int = 2
    second_channels: Tuple[int, ...] = (128, 256)
    second_layers: Tuple[int, ...] = (5, 5)
    fpn_channels: Tuple[int, ...] = (256, 256)
    neck_layers: int = 1
    hidden: int = 128
    iterbev: str = "bevfusionmb2"
    extra_feat: bool = True
    input_img: bool = False
    input_pts: bool = True
    img_backbone_depth: int = 50
    img_fpn_outs: int = 5
    use_grid_mask: bool = False
    cam_proj: str = "lss"
    iter_bev_cam: bool = True
    max_points_height: int = 10
    lss: LSSConfig = dataclasses.field(default_factory=LSSConfig)
    bev_shape: Tuple[int, int] = (180, 180)
    freeze_img: bool = False
    freeze_camlss: bool = False
    freeze_pts: bool = False
    compute_dtype: str = "float32"  # dense BEV path; params stay float32
    decoder: FocalDecoderConfig = dataclasses.field(
        default_factory=FocalDecoderConfig
    )

    @property
    def point_dim(self) -> int:
        return 5

    @property
    def voxel_feature_dim(self) -> int:
        """Channels of the voxel features the sparse encoder reads: the
        HardVFE's last width, else the point's (the mean VFEs)."""
        return (self.vfe_channels[-1] if self.vfe_type == "HardVFE"
                else self.point_dim)

    @property
    def tdtype(self) -> torch.dtype:
        return _torch_dtype(self.compute_dtype)


def with_compute_dtype(cfg: DetectorConfig, dtype: str) -> DetectorConfig:
    """Set the compute dtype consistently on the detector and its decoder."""
    return dataclasses.replace(
        cfg, compute_dtype=dtype,
        decoder=dataclasses.replace(cfg.decoder, dtype=dtype),
    )


@dataclasses.dataclass(frozen=True)
class TrainRecipe:
    """The reference training recipe (FocalFormer3D_L.py: AdamW 1e-4, wd
    0.01, clip 0.1, one-cycle LR and momentum, 6 epochs, Fading after
    epoch 1, 2 samples per card)."""

    base_lr: float = 1e-4
    weight_decay: float = 0.01
    grad_clip: float = 0.1
    total_epochs: int = 6
    fade_epoch: int = 1
    samples_per_device: int = 2
    lr_target_ratio: tuple = (10.0, 1e-4)
    momentum_target_ratio: tuple = (0.8947368421052632, 1.0)
    step_ratio_up: float = 0.4


_NUSC_CLASSES = (
    "car", "truck", "construction_vehicle", "bus", "trailer", "barrier",
    "motorcycle", "bicycle", "pedestrian", "traffic_cone",
)
_NUSC_PC_RANGE = (-54.0, -54.0, -5.0, 54.0, 54.0, 3.0)
_NUSC_VOXEL = (0.075, 0.075, 0.2)


def _focalformer3d_l():
    model = DetectorConfig(
        voxel=VoxelConfig(
            point_cloud_range=_NUSC_PC_RANGE,
            voxel_size=_NUSC_VOXEL,
            max_num_points=10,
            max_voxels=120000,
            max_voxels_test=160000,
        ),
        vfe_type="HardSimpleVFE",
        sparse_shape=(41, 1440, 1440),
        sparse_out_channels=128,
        encoder_channels=((16, 16, 32), (32, 32, 64), (64, 64, 128),
                          (128, 128)),
        down_paddings=((1, 1, 1), (1, 1, 1), (0, 1, 1)),
        capacities=(160000, 245760, 188416, 77824),
        out_capacity=53248,
        second_channels=(128, 256),
        second_layers=(5, 5),
        fpn_channels=(256, 256),
        neck_layers=1,
        hidden=128,
        iterbev="bevfusionmb2",
        extra_feat=True,
        input_img=False,
        decoder=FocalDecoderConfig(
            num_classes=len(_NUSC_CLASSES),
            hidden=128,
            hidden_roi=512,
            num_proposals=300,
            num_decoder_layers=2,
            inner_layers=3,
            num_heads=8,
            nms_kernel_size=3,
            multistage_heatmap=1,
            reuse_first_heatmap=True,
            extra_feat=True,
            multiscale=True,
            bevpos=True,
            roi_feats=7,
            roi_dropout=0.1,
            roi_based_reg=True,
            roi_expand_ratio=1.2,
            add_gt_groups=3,
            add_gt_pos_thresh=5.0,
            add_gt_pos_boxnoise_thresh=0.75,
            gt_center_limit=5.0,
            max_gts=200,
            kernel1_classes=(8, 9),
            code_size=10,
            pc_range=_NUSC_PC_RANGE,
            voxel_size=_NUSC_VOXEL,
            out_size_factor=8,
            post_center_range=(-61.2, -61.2, -10.0, 61.2, 61.2, 10.0),
            score_threshold=0.0,
        ),
    )
    from .training.losses import LossConfig  # it imports this module

    loss = LossConfig(
        code_weights=(1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.2, 0.2),
        loss_cls_weight=1.0,
        loss_bbox_weight=0.25,
        loss_heatmap_weight=1.0,
        gaussian_overlap=0.1,
        min_radius=2,
    )
    return {"model": model, "loss": loss, "train": TrainRecipe(),
            "class_names": _NUSC_CLASSES, "dataset": "nuscenes"}


def _tiny_l():
    classes = ("car", "truck", "pedestrian", "traffic_cone")
    pc_range = (-8.0, -8.0, -3.0, 8.0, 8.0, 3.0)
    model = DetectorConfig(
        voxel=VoxelConfig(
            point_cloud_range=pc_range,
            voxel_size=(0.25, 0.25, 0.24),
            max_num_points=5,
            max_voxels=512,
        ),
        sparse_shape=(25, 64, 64),
        sparse_out_channels=32,
        encoder_channels=((8, 8, 16), (16, 16, 24), (24, 24, 32), (32, 32)),
        down_paddings=((1, 1, 1), (1, 1, 1), (0, 1, 1)),
        capacities=(512, 384, 256, 192),
        out_capacity=192,
        second_channels=(32, 48),
        second_layers=(2, 2),
        fpn_channels=(48, 48),
        hidden=32,
        decoder=FocalDecoderConfig(
            num_classes=len(classes),
            hidden=32,
            hidden_roi=64,
            num_proposals=16,
            num_decoder_layers=2,
            inner_layers=1,
            num_heads=4,
            multistage_heatmap=1,
            reuse_first_heatmap=True,
            multiscale=True,
            roi_feats=3,
            add_gt_groups=2,
            max_gts=24,
            kernel1_classes=(2, 3),
            pc_range=pc_range,
            voxel_size=(0.25, 0.25, 0.75),
            out_size_factor=8,
            post_center_range=(-10, -10, -5, 10, 10, 5),
        ),
    )
    from .training.losses import LossConfig  # it imports this module

    loss = LossConfig(code_weights=(1.0,) * 8 + (0.2, 0.2))
    return {"model": model, "loss": loss,
            "train": TrainRecipe(total_epochs=2, fade_epoch=1,
                                 samples_per_device=2),
            "class_names": classes, "dataset": "nuscenes"}


def deform_deltas(cfg: dict) -> dict:
    """The single-stage head of DeformFormer3D on a config (JAX
    ``configs/deformformer3d_l.py``, ``variants._deform_deltas``): no extra
    value map, 200 proposals, one decoder round, one heatmap stage without
    reuse, no RoI features and no RoI-based regression."""
    model = cfg["model"]
    return {**cfg, "model": dataclasses.replace(
        model, extra_feat=False, decoder=dataclasses.replace(
            model.decoder, num_proposals=200, num_decoder_layers=1,
            multistage_heatmap=1, reuse_first_heatmap=False,
            extra_feat=False, roi_feats=0, roi_based_reg=False))}


def _deformformer3d_l():
    """DeformFormer3D_L: FocalFormer3D_L with the single-stage head,
    trained 20 epochs with the fade at epoch 15."""
    cfg = deform_deltas(_focalformer3d_l())
    cfg["train"] = dataclasses.replace(cfg["train"], total_epochs=20,
                                       fade_epoch=15)
    return cfg


def _deformformer3d_l_dynamic():
    """DeformFormer3D_L_dynamic: DeformFormer3D_L on dynamic voxelization
    (``DynamicSimpleVFE``: each voxel the mean of all its points)."""
    cfg = _deformformer3d_l()
    cfg["model"] = dataclasses.replace(cfg["model"],
                                       vfe_type="DynamicSimpleVFE")
    return cfg


IMG_SCALE = (448, 800)  # (H, W) network input of the camera configs


def _nusc_lss():
    return LSSConfig(img_scale=IMG_SCALE, camera_depth_range=(4.0, 45.0, 1.0),
                     pc_range=_NUSC_PC_RANGE, downsample=4, grid=0.6,
                     input_channels=256, cam_channels=64, out_channels=128)


def _focalformer3d_lc():
    """FocalFormer3D_LC (JAX ``configs/focalformer3d_lc.py``): the LiDAR
    model's point branch, a ResNet-50 + FPN image branch at 448 x 800, the
    LSS camera BEV, two ``bevfusion`` fusion layers, two heatmap stages
    without reuse, and the image, LSS and point branches frozen (the staged
    finetune from DeformFormer3D_C_R50 and FocalFormer3D_L)."""
    cfg = _focalformer3d_l()
    model = cfg["model"]
    cfg["model"] = dataclasses.replace(
        model, neck_layers=2, iterbev="bevfusion", input_img=True,
        input_pts=True, img_backbone_depth=50, use_grid_mask=True,
        cam_proj="lss", iter_bev_cam=True, max_points_height=10,
        lss=_nusc_lss(), freeze_img=True, freeze_camlss=True,
        freeze_pts=True, decoder=dataclasses.replace(
            model.decoder, multistage_heatmap=2, reuse_first_heatmap=False))
    cfg["img_scale"] = IMG_SCALE
    return cfg


def _focalformer3d_lc_proj():
    """FocalFormer3D_LC_Proj (JAX ``configs/variants.py``
    ``focalformer3d_lc_proj``): FocalFormer3D_LC with the camera fused by
    I2P projection (``models/i2p.py``: grid-sampled multi-view features and
    a per-cell attention, in the first fusion layer) instead of the LSS."""
    cfg = _focalformer3d_lc()
    cfg["model"] = dataclasses.replace(
        cfg["model"], cam_proj="i2p", iter_bev_cam=True,
        max_points_height=10, freeze_camlss=False)
    return cfg


def _focalformer3d_lc_tta():
    """FocalFormer3D_LC_TTA (JAX ``configs/variants.py``
    ``focalformer3d_lc_tta``): the LC model with the eval-time double flip
    at three point-cloud scales, 12 passes a sample (the test CLI's
    ``--tta`` reads ``tta``)."""
    cfg = _focalformer3d_lc()
    cfg["tta"] = {
        "pts_scale_ratio": (1.0, 1.06, 0.96),
        "flip_horizontal": True,
        "flip_vertical": True,
    }
    return cfg


def _deformformer3d_c_r50():
    """DeformFormer3D_C_R50 (JAX ``configs/deformformer3d_c_r50.py``):
    camera only (no point branch), ResNet-50 + FPN at 448 x 800, the LSS
    camera BEV into the head with no fusion layer, one heatmap stage, 200
    proposals, one decoder round, no denoising groups and no RoI features;
    20 epochs, the fade at epoch 15."""
    cfg = _focalformer3d_l()
    model = cfg["model"]
    cfg["model"] = DetectorConfig(
        voxel=VoxelConfig(point_cloud_range=_NUSC_PC_RANGE,
                          voxel_size=_NUSC_VOXEL, max_num_points=10,
                          max_voxels=120000),
        neck_layers=0, hidden=128, iterbev="bevfusion", extra_feat=False,
        input_img=True, input_pts=False, img_backbone_depth=50,
        use_grid_mask=True, cam_proj="lss", iter_bev_cam=True,
        max_points_height=10, lss=_nusc_lss(),
        decoder=FocalDecoderConfig(
            num_classes=len(_NUSC_CLASSES), hidden=128, num_proposals=200,
            num_decoder_layers=1, inner_layers=3, num_heads=8,
            nms_kernel_size=3, multistage_heatmap=1,
            reuse_first_heatmap=False, extra_feat=False, multiscale=True,
            bevpos=True, roi_feats=0, roi_based_reg=False, add_gt_groups=0,
            max_gts=200, kernel1_classes=(8, 9), code_size=10,
            pc_range=_NUSC_PC_RANGE, voxel_size=_NUSC_VOXEL,
            out_size_factor=8,
            post_center_range=model.decoder.post_center_range,
            score_threshold=0.0))
    cfg["train"] = dataclasses.replace(cfg["train"], total_epochs=20,
                                       fade_epoch=15)
    cfg["img_scale"] = IMG_SCALE
    return cfg


_WAYMO_CLASSES = ("Car", "Pedestrian", "Cyclist")
_WAYMO_PC_RANGE = (-76.8, -76.8, -2.0, 76.8, 76.8, 4.0)
_WAYMO_VOXEL = (0.1, 0.1, 0.15)


def _focalformer3d_waymo_l():
    """FocalFormer3D_Waymo_L (JAX ``configs/focalformer3d_waymo_l.py``):
    3 classes, 0.1 m voxels over +-76.8 m (a 41 x 1536 x 1536 grid), the
    ``HardVFE`` PointNet (5 -> 64) over 5 point slots of up to 150 000
    voxels, two ``bevfusionmb2`` fusion layers, three heatmap stages (two
    plus the reused first), boxes without velocity (code size 8), the box
    loss at weight 2; 12 epochs, the fade at epoch 11."""
    model = DetectorConfig(
        voxel=VoxelConfig(
            point_cloud_range=_WAYMO_PC_RANGE,
            voxel_size=_WAYMO_VOXEL,
            max_num_points=5,
            max_voxels=150000,
        ),
        vfe_type="HardVFE",
        vfe_channels=(64,),
        sparse_shape=(41, 1536, 1536),
        sparse_out_channels=128,
        encoder_channels=((16, 16, 32), (32, 32, 64), (64, 64, 128),
                          (128, 128)),
        down_paddings=((1, 1, 1), (1, 1, 1), (0, 1, 1)),
        capacities=(150000, 245760, 188416, 77824),
        out_capacity=57344,
        second_channels=(128, 256),
        second_layers=(5, 5),
        fpn_channels=(256, 256),
        neck_layers=2,
        hidden=128,
        iterbev="bevfusionmb2",
        extra_feat=True,
        input_img=False,
        decoder=FocalDecoderConfig(
            num_classes=len(_WAYMO_CLASSES),
            hidden=128,
            hidden_roi=512,
            num_proposals=200,
            num_decoder_layers=2,
            inner_layers=3,
            num_heads=8,
            nms_kernel_size=3,
            multistage_heatmap=2,
            reuse_first_heatmap=True,
            extra_feat=True,
            multiscale=True,
            bevpos=True,
            roi_feats=7,
            roi_dropout=0.1,
            roi_based_reg=True,
            roi_expand_ratio=1.2,
            add_gt_groups=3,
            add_gt_pos_thresh=5.0,
            add_gt_pos_boxnoise_thresh=0.75,
            gt_center_limit=5.0,
            max_gts=220,
            kernel1_classes=(1, 2),
            code_size=8,
            pc_range=_WAYMO_PC_RANGE,
            voxel_size=_WAYMO_VOXEL,
            out_size_factor=8,
            post_center_range=(-80.0, -80.0, -10.0, 80.0, 80.0, 10.0),
            score_threshold=0.0,
        ),
    )
    from .training.losses import LossConfig  # it imports this module

    loss = LossConfig(
        code_weights=(1.0,) * 8,
        loss_cls_weight=1.0,
        loss_bbox_weight=2.0,
        loss_heatmap_weight=1.0,
        gaussian_overlap=0.1,
        min_radius=2,
    )
    return {"model": model, "loss": loss,
            "train": TrainRecipe(total_epochs=12, fade_epoch=11),
            "class_names": _WAYMO_CLASSES, "dataset": "waymo"}


def _tiny_waymo_l():
    """Tiny_Waymo_L (JAX ``configs/tiny_waymo_l.py``): the Waymo path
    (HardVFE, 3 classes, code size 8, the Waymo data layer and evaluator)
    at toy widths, for smokes and the CPU tests."""
    pc_range = (-8.0, -8.0, -3.0, 8.0, 8.0, 3.0)
    model = DetectorConfig(
        voxel=VoxelConfig(
            point_cloud_range=pc_range,
            voxel_size=(0.25, 0.25, 0.24),
            max_num_points=5,
            max_voxels=512,
        ),
        vfe_type="HardVFE",
        vfe_channels=(16,),
        sparse_shape=(25, 64, 64),
        sparse_out_channels=32,
        encoder_channels=((8, 8, 16), (16, 16, 24), (24, 24, 32), (32, 32)),
        down_paddings=((1, 1, 1), (1, 1, 1), (0, 1, 1)),
        capacities=(512, 384, 256, 192),
        out_capacity=192,
        second_channels=(32, 48),
        second_layers=(2, 2),
        fpn_channels=(48, 48),
        hidden=32,
        decoder=FocalDecoderConfig(
            num_classes=len(_WAYMO_CLASSES),
            hidden=32,
            hidden_roi=64,
            num_proposals=16,
            num_decoder_layers=2,
            inner_layers=1,
            num_heads=4,
            multistage_heatmap=1,
            reuse_first_heatmap=True,
            multiscale=True,
            roi_feats=3,
            add_gt_groups=2,
            max_gts=24,
            kernel1_classes=(1, 2),
            code_size=8,
            pc_range=pc_range,
            voxel_size=(0.25, 0.25, 0.75),
            out_size_factor=8,
            post_center_range=(-10, -10, -5, 10, 10, 5),
        ),
    )
    from .training.losses import LossConfig  # it imports this module

    return {"model": model, "loss": LossConfig(code_weights=(1.0,) * 8),
            "train": TrainRecipe(total_epochs=2, fade_epoch=1,
                                 samples_per_device=2),
            "class_names": _WAYMO_CLASSES, "dataset": "waymo"}


def _focalformer3d_waymo15_l():
    """FocalFormer3D_Waymo15_L (JAX ``configs/variants.py``
    ``focalformer3d_waymo15_l``): FocalFormer3D_Waymo_L on every fifth
    training frame (``load_interval`` 5), with class-aware regression
    heads."""
    cfg = _focalformer3d_waymo_l()
    model = cfg["model"]
    cfg["model"] = dataclasses.replace(model, decoder=dataclasses.replace(
        model.decoder, num_proposals=200, classaware_reg=True))
    cfg["load_interval"] = 5
    return cfg


def _deformformer3d_waymo_l():
    """DeformFormer3D_Waymo_L: the single-stage head on the Waymo base."""
    return deform_deltas(_focalformer3d_waymo_l())


def _deformformer3d_waymo15_l():
    """DeformFormer3D_Waymo15_L: DeformFormer3D_Waymo_L on every fifth
    training frame."""
    cfg = deform_deltas(_focalformer3d_waymo_l())
    cfg["load_interval"] = 5
    return cfg


_REGISTRY = {"FocalFormer3D_L": _focalformer3d_l, "Tiny_L": _tiny_l,
             "DeformFormer3D_L": _deformformer3d_l,
             "DeformFormer3D_L_dynamic": _deformformer3d_l_dynamic,
             "FocalFormer3D_LC": _focalformer3d_lc,
             "FocalFormer3D_LC_Proj": _focalformer3d_lc_proj,
             "FocalFormer3D_LC_TTA": _focalformer3d_lc_tta,
             "DeformFormer3D_C_R50": _deformformer3d_c_r50,
             "FocalFormer3D_Waymo_L": _focalformer3d_waymo_l,
             "Tiny_Waymo_L": _tiny_waymo_l,
             "FocalFormer3D_Waymo15_L": _focalformer3d_waymo15_l,
             "DeformFormer3D_Waymo_L": _deformformer3d_waymo_l,
             "DeformFormer3D_Waymo15_L": _deformformer3d_waymo15_l}


def get_config(name: str):
    """Named config: ``{"model": DetectorConfig, "loss": LossConfig,
    "train": TrainRecipe, "class_names": ..., "dataset": "nuscenes" or
    "waymo"}`` (and ``"img_scale"`` for a camera config, ``"tta"`` for
    FocalFormer3D_LC_TTA, ``"load_interval"`` for the 1/5-split Waymo
    configs), as the JAX ``configs.get_config`` returns it."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown config {name!r}; available: "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def available() -> list:
    """The names ``get_config`` resolves."""
    return sorted(_REGISTRY)

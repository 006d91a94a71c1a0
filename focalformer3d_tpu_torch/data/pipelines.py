"""Train and test pipeline factories matching the reference configs.

The port's copy of ``focalformer3d_tpu/data/pipelines.py``: the stacks of
FocalFormer3D_L.py:64-134 (LiDAR) and FocalFormer3D_LC.py:30-100 (LiDAR +
camera). Point and image loading are ``NuScenesDataset``'s own; the
pipeline covers augmentation, filtering and the images' normalisation.
"""
from __future__ import annotations

from typing import Optional, Sequence

from . import transforms as T
from .nuscenes import DBSampler, ObjectSample

# mmdet img_norm_cfg for the nuImages-pretrained R50 (BGR, to_rgb=False)
IMG_NORM_MEAN = (103.530, 116.280, 123.675)
IMG_NORM_STD = (57.375, 57.120, 58.395)


def train_pipeline(
    point_cloud_range: Sequence[float],
    class_names: Sequence[str],
    db_sampler: Optional[DBSampler] = None,
    with_images: bool = False,
    img_scale=(448, 800),  # (H, W)
    image_aug: bool = True,
):
    t = []
    if db_sampler is not None:
        t.append(ObjectSample(db_sampler))
    t += [
        T.GlobalRotScaleTrans(
            rot_range=(-0.3925 * 2, 0.3925 * 2),
            scale_ratio_range=(0.9, 1.1),
            translation_std=(0.5, 0.5, 0.5),
        ),
        T.RandomFlip3D(0.5, 0.5),
        T.PointsRangeFilter(point_cloud_range),
        T.ObjectRangeFilter(point_cloud_range),
        T.ObjectNameFilter(class_names),
        T.PointShuffle(),
    ]
    if with_images:
        if image_aug:
            t.append(
                T.ImageAug3D(
                    final_dim=img_scale, resize_lim=(0.4, 0.6),
                    bot_pct_lim=(0.0, 0.0), rot_lim=(-5.4, 5.4),
                    rand_flip=True, is_train=True,
                )
            )
        else:
            t.append(
                T.ScaleImageMultiViewImage(
                    scales=(img_scale[1], img_scale[0])
                )
            )
        t += [
            T.NormalizeMultiviewImage(IMG_NORM_MEAN, IMG_NORM_STD),
            T.PadMultiViewImage(32),
        ]
    return t


def test_pipeline(
    point_cloud_range: Sequence[float],
    with_images: bool = False,
    img_scale=(448, 800),
):
    t = [T.PointsRangeFilter(point_cloud_range)]
    if with_images:
        t += [
            T.ScaleImageMultiViewImage(scales=(img_scale[1], img_scale[0])),
            T.NormalizeMultiviewImage(IMG_NORM_MEAN, IMG_NORM_STD),
            T.PadMultiViewImage(32),
        ]
    return t

"""Train and test pipeline factories matching the reference's LiDAR
configs.

The port's copy of ``focalformer3d_tpu/data/pipelines.py`` without the
camera stages: the LiDAR stacks of FocalFormer3D_L.py:64-134. Point
loading is ``NuScenesDataset``'s own; the pipeline covers augmentation and
filtering. ``with_images=True`` raises: the image stages come with the
camera data layer (ROADMAP.md, Queue 1 item 8c).
"""
from __future__ import annotations

from typing import Optional, Sequence

from . import transforms as T
from .nuscenes import CAMERA_BRANCH, DBSampler, ObjectSample


def train_pipeline(
    point_cloud_range: Sequence[float],
    class_names: Sequence[str],
    db_sampler: Optional[DBSampler] = None,
    with_images: bool = False,
    img_scale=(448, 800),  # (H, W)
    image_aug: bool = True,
):
    if with_images:
        raise NotImplementedError(CAMERA_BRANCH)
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
    return t


def test_pipeline(
    point_cloud_range: Sequence[float],
    with_images: bool = False,
    img_scale=(448, 800),
):
    if with_images:
        raise NotImplementedError(CAMERA_BRANCH)
    return [T.PointsRangeFilter(point_cloud_range)]

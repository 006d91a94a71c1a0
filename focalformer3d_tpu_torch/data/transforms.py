"""Host-side (NumPy) LiDAR pipeline transforms.

The port's copy of the point-cloud transforms of
``focalformer3d_tpu/data/transforms.py``: the mmdet3d pipeline stages that
the reference's LiDAR configs compose (FocalFormer3D_L.py:64-99). They draw
the same numbers from the same ``numpy.random.RandomState`` calls as the
originals, so both packages give equal arrays for one seed
(``tests/test_torch_data.py``). The multi-view image transforms
(``ImageAug3D``, ``NormalizeMultiviewImage``, ``PadMultiViewImage``,
``ScaleImageMultiViewImage``) come with the camera branch.

Every geometric augmentation records itself into ``bev_aug`` (4x4, lidar
frame) instead of scattering flags and angles through meta dicts; the model
reads only that matrix.

A *sample* is a plain dict with (a subset of) points (N, 5) float32,
gt_boxes (G, 9), gt_names (G,) object array, bev_aug (4, 4).
"""
from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _rot_z(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)


def _ensure_aug(sample: dict) -> None:
    if "bev_aug" not in sample:
        sample["bev_aug"] = np.eye(4, dtype=np.float32)


def _apply_pts(sample: dict, R: np.ndarray, t: np.ndarray) -> None:
    """Apply x' = R x + t to points/boxes and fold into bev_aug."""
    _ensure_aug(sample)
    pts = sample["points"]
    pts[:, :3] = pts[:, :3] @ R.T + t
    M = np.eye(4, dtype=np.float32)
    M[:3, :3] = R
    M[:3, 3] = t
    sample["bev_aug"] = M @ sample["bev_aug"]


# ---------------------------------------------------------------------------
# point-cloud transforms
# ---------------------------------------------------------------------------

class GlobalRotScaleTrans:
    """Rotate (z) -> scale -> translate; boxes follow LiDAR-box semantics
    (mmdet3d order 'R','S','T'). Velocities scale and rotate in-plane."""

    def __init__(self, rot_range=(-0.785, 0.785), scale_ratio_range=(0.9, 1.1),
                 translation_std=(0.5, 0.5, 0.5)):
        self.rot_range = rot_range
        self.scale_ratio_range = scale_ratio_range
        self.translation_std = np.asarray(translation_std, np.float32)

    def __call__(self, sample: dict, rng: np.random.RandomState) -> dict:
        angle = rng.uniform(*self.rot_range)
        scale = rng.uniform(*self.scale_ratio_range)
        trans = (rng.randn(3) * self.translation_std).astype(np.float32)

        R = _rot_z(angle) * scale
        _apply_pts(sample, R, trans)

        boxes = sample.get("gt_boxes")
        if boxes is not None and len(boxes):
            Rz = _rot_z(angle)
            boxes[:, :3] = boxes[:, :3] @ Rz.T * scale + trans
            boxes[:, 3:6] *= scale
            boxes[:, 6] += angle
            if boxes.shape[1] >= 9:
                v = boxes[:, 7:9]
                boxes[:, 7:9] = v @ Rz[:2, :2].T * scale
        return sample


class RandomFlip3D:
    """BEV horizontal flip (y -> -y) and/or vertical flip (x -> -x), each
    with its own probability (mmdet3d LiDAR-box semantics)."""

    def __init__(self, flip_ratio_bev_horizontal=0.5,
                 flip_ratio_bev_vertical=0.5):
        self.ph = flip_ratio_bev_horizontal
        self.pv = flip_ratio_bev_vertical

    def __call__(self, sample: dict, rng: np.random.RandomState) -> dict:
        boxes = sample.get("gt_boxes")
        if rng.rand() < self.ph:  # horizontal: y -> -y
            F = np.diag(np.array([1.0, -1.0, 1.0], np.float32))
            _apply_pts(sample, F, np.zeros(3, np.float32))
            if boxes is not None and len(boxes):
                boxes[:, 1] = -boxes[:, 1]
                boxes[:, 6] = -boxes[:, 6]
                if boxes.shape[1] >= 9:
                    boxes[:, 8] = -boxes[:, 8]
        if rng.rand() < self.pv:  # vertical: x -> -x
            F = np.diag(np.array([-1.0, 1.0, 1.0], np.float32))
            _apply_pts(sample, F, np.zeros(3, np.float32))
            if boxes is not None and len(boxes):
                boxes[:, 0] = -boxes[:, 0]
                boxes[:, 6] = -boxes[:, 6] + np.pi
                if boxes.shape[1] >= 9:
                    boxes[:, 7] = -boxes[:, 7]
        return sample


class PointsRangeFilter:
    def __init__(self, point_cloud_range):
        self.pcr = np.asarray(point_cloud_range, np.float32)

    def __call__(self, sample: dict, rng=None) -> dict:
        p = sample["points"]
        keep = np.all(
            (p[:, :3] >= self.pcr[:3]) & (p[:, :3] <= self.pcr[3:]), axis=1
        )
        sample["points"] = p[keep]
        return sample


class ObjectRangeFilter:
    """Keep boxes whose BEV center is in range; limit yaw to [-pi, pi)
    via the mmdet3d limit_yaw(offset=0.5, period=2pi) convention."""

    def __init__(self, point_cloud_range):
        self.bev = np.asarray(point_cloud_range, np.float32)[[0, 1, 3, 4]]

    def __call__(self, sample: dict, rng=None) -> dict:
        b = sample.get("gt_boxes")
        if b is None or not len(b):
            return sample
        keep = (
            (b[:, 0] > self.bev[0]) & (b[:, 0] < self.bev[2])
            & (b[:, 1] > self.bev[1]) & (b[:, 1] < self.bev[3])
        )
        sample["gt_boxes"] = b[keep]
        sample["gt_names"] = sample["gt_names"][keep]
        yaw = sample["gt_boxes"][:, 6]
        sample["gt_boxes"][:, 6] = (yaw + np.pi) % (2 * np.pi) - np.pi
        return sample


class ObjectNameFilter:
    def __init__(self, classes):
        self.classes = list(classes)

    def __call__(self, sample: dict, rng=None) -> dict:
        names = sample.get("gt_names")
        if names is None or not len(names):
            return sample
        keep = np.array([n in self.classes for n in names], bool)
        sample["gt_boxes"] = sample["gt_boxes"][keep]
        sample["gt_names"] = names[keep]
        return sample


class PointShuffle:
    def __call__(self, sample: dict, rng: np.random.RandomState) -> dict:
        perm = rng.permutation(len(sample["points"]))
        sample["points"] = sample["points"][perm]
        return sample


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, sample: dict, rng: np.random.RandomState) -> dict:
        for t in self.transforms:
            sample = t(sample, rng)
        return sample

"""Waymo dataset: the reader of mmdet3d's KITTI-format infos.

The port's copy of ``focalformer3d_tpu/data/waymo.py`` (numpy only, as
``data/nuscenes.py``), held to it bit for bit by
``tests/test_torch_waymo.py``. mmdet3d's ``WaymoDataset`` as the reference
configures it (FocalFormer3D_Waymo_L.py: load_dim 6, use_dim 5, the
classes Car / Pedestrian / Cyclist, a +-76.8 m range, code size 8 with no
velocity). mmdet3d keeps Waymo in the KITTI layout: each info holds the
camera-frame annotations (``annos``: location, dimensions (l, h, w),
rotation_y) and the rect / Tr_velo_to_cam calibration; the boxes move to
the LiDAR frame here (``box_camera_to_lidar``):

  xyz_lidar = inv(rect @ Tr_velo_to_cam) @ [x, y, z, 1]_cam   (bottom centre)
  dims_lidar (dx, dy, dz) = (l, w, h)
  yaw_lidar = -rotation_y - pi/2

``get_sample`` drops ``DontCare`` rows, pads the boxes to 9 values with
zero velocity, and marks the LEVEL_2-only boxes (``gt_l2_only``: an
annotated difficulty of 2 or more, or at most 5 LiDAR points in the box).
``load_interval`` keeps every n-th info (the 1/5-split configs).
"""
from __future__ import annotations

import pickle
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from . import transforms as T

CLASS_NAMES = ("Car", "Pedestrian", "Cyclist")


def box_camera_to_lidar(boxes_cam: np.ndarray, rect: np.ndarray,
                        trv2c: np.ndarray) -> np.ndarray:
    """(N, 7) [x,y,z,l,h,w,ry] camera -> (N, 7) lidar [x,y,z,dx,dy,dz,yaw]."""
    if len(boxes_cam) == 0:
        return np.zeros((0, 7), np.float32)
    cam2lidar = np.linalg.inv(rect @ trv2c)
    xyz = np.concatenate(
        [boxes_cam[:, :3], np.ones((len(boxes_cam), 1))], -1
    )
    xyz_l = (xyz @ cam2lidar.T)[:, :3]
    l, h, w = boxes_cam[:, 3], boxes_cam[:, 4], boxes_cam[:, 5]
    yaw = -boxes_cam[:, 6] - np.pi / 2
    return np.stack(
        [xyz_l[:, 0], xyz_l[:, 1], xyz_l[:, 2], l, w, h, yaw], -1
    ).astype(np.float32)


class WaymoDataset:
    """Reads mmdet3d waymo_infos_*.pkl (list of KITTI-style dicts)."""

    def __init__(
        self,
        ann_file: str,
        data_root: str = "",
        classes: Sequence[str] = CLASS_NAMES,
        pipeline: Optional[Sequence] = None,
        load_dim: int = 6,
        use_dim: int = 5,
        load_interval: int = 1,
        test_mode: bool = False,
    ):
        with open(ann_file, "rb") as f:
            infos = pickle.load(f)
        self.infos = infos[::load_interval]
        self.data_root = Path(data_root)
        self.classes = list(classes)
        self.pipeline = T.Compose(pipeline) if pipeline else None
        self.load_dim = load_dim
        self.use_dim = use_dim
        self.test_mode = test_mode

    def __len__(self):
        return len(self.infos)

    def _load_points(self, info) -> np.ndarray:
        rel = info["point_cloud"]["velodyne_path"]
        path = self.data_root / rel
        pts = np.fromfile(str(path), np.float32).reshape(-1, self.load_dim)
        return pts[:, : self.use_dim]

    def get_sample(self, idx: int,
                   rng: Optional[np.random.RandomState] = None) -> dict:
        info = self.infos[idx]
        rng = rng or np.random.RandomState()
        sample = {
            "points": self._load_points(info),
            "token": str(info["image"]["image_idx"]),
            "bev_aug": np.eye(4, dtype=np.float32),
        }
        annos = info.get("annos")
        if annos is not None:
            rect = np.asarray(info["calib"]["R0_rect"], np.float64)
            trv2c = np.asarray(info["calib"]["Tr_velo_to_cam"], np.float64)
            names = np.asarray(annos["name"], object)
            keep = np.array([n != "DontCare" for n in names], bool)
            loc = np.asarray(annos["location"], np.float64)[keep]
            dims = np.asarray(annos["dimensions"], np.float64)[keep]  # l,h,w
            rots = np.asarray(annos["rotation_y"], np.float64)[keep]
            cam = np.concatenate(
                [loc, dims, rots[:, None]], -1
            ) if len(loc) else np.zeros((0, 7))
            boxes = box_camera_to_lidar(cam, rect, trv2c)
            # pad to 9 dims (zero velocity) for a uniform batch layout;
            # Waymo heads use code_size 8 and ignore the tail.
            boxes9 = np.concatenate(
                [boxes, np.zeros((len(boxes), 2), np.float32)], -1
            )
            sample["gt_boxes"] = boxes9
            sample["gt_names"] = names[keep]
            # Waymo difficulty: LEVEL_2 if annotated difficulty >= 2 or
            # at most 5 lidar points in box (official definition:
            # waymo-open-dataset compute_detection_metrics assigns L2 to
            # boxes with num_lidar_points <= 5)
            diff = np.asarray(
                annos.get("difficulty", np.zeros(len(names))), np.int32
            )[keep]
            npts = np.asarray(
                annos.get("num_points_in_gt", np.full(len(names), 999)),
                np.int32,
            )[keep]
            sample["gt_l2_only"] = (diff >= 2) | (npts <= 5)
        if self.pipeline is not None:
            sample = self.pipeline(sample, rng)
        return sample

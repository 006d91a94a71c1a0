"""Dataset directories written from the port's synthetic scenes.

``write_nuscenes`` writes a nuScenes-format directory (the infos of
mmdet3d v0.17, optionally with six JPEG cameras a sample) and
``write_waymo`` a Waymo directory in mmdet3d's KITTI layout. No dataset
ships with the repo: the CLIs, their CPU tests and the card tests
(``tests/test_torch_cuda.py``) read what these write. One seed writes the
same bytes on every machine.

    python -c "from focalformer3d_tpu_torch.data import synthetic_dirs as c
    c.write_nuscenes('/tmp/nusc', seed=0, samples=4, points=1500, sweeps=2,
        pc_range=(-8, -8, -3, 8, 8, 3), classes=('car', 'truck'), boxes=4)"
"""
from __future__ import annotations

import math
import pathlib
import pickle

import numpy as np

from . import image_io, synthetic
from .nuscenes import CAM_ORDER, lidar2img_matrices


def _quat_z(yaw):
    """(w, x, y, z) of a rotation by ``yaw`` about z."""
    return [math.cos(yaw / 2), 0.0, 0.0, math.sin(yaw / 2)]


def write_nuscenes(root, *, seed, samples, points, sweeps, pc_range,
                   classes, boxes=12, cameras=False, img_hw=(900, 1600)):
    """Write a nuScenes-format directory (mmdet3d v0.17 infos) from the
    port's synthetic scenes: per sample a radial key frame of ``points``
    points (``data/synthetic.make_scene``) and ``sweeps`` sweeps, each
    about 97% of the key frame's points, jittered and seen from a sensor
    that moved (a small yaw and a shift, given as ``sensor2lidar_*``).
    The infos carry ``gt_boxes`` (bottom-centred, 7 values),
    ``gt_names``, ``gt_velocity``, ``num_lidar_pts`` (key-frame points in
    the box), ``valid_flag``, ``timestamp`` (us), ``sweeps`` and the
    ``lidar2ego_*`` / ``ego2global_*`` calibration of a submission; one
    pickle is written as both ``nuscenes_infos_train.pkl`` and
    ``nuscenes_infos_val.pkl``. With ``cameras`` each sample also gets six
    cameras (``img_hw``, nuScenes' 900 x 1600 by default): a rig that sees
    the scene (``synthetic.ring_camera_infos``, its own random stream, so
    the points are those of ``cameras=False``), the key frame's splats over
    a textured background (``synthetic.camera_frames``) written as
    baseline 4:2:0 JPEGs of quality 90 by the port's writer, and ``cams``
    entries as ``tools/create_data.py`` writes them (``data_path``,
    ``sensor2lidar_rotation`` / ``_translation``, ``cam_intrinsic``).
    Returns the train infos' path."""
    root = pathlib.Path(root)
    (root / "samples").mkdir(parents=True, exist_ok=True)
    (root / "sweeps").mkdir(exist_ok=True)
    rng = np.random.RandomState(seed)
    cam_rng = np.random.RandomState(seed + 7919)
    infos = []
    for i in range(samples):
        pts, gt, labels = synthetic.make_scene(
            rng, n_points=points, n_boxes=boxes, num_classes=len(classes),
            pc_range=pc_range, mode="radial")
        ts = 1_600_000_000_000_000 + i * 500_000
        lidar_path = root / "samples" / f"lidar_{i:04d}.bin"
        pts.tofile(lidar_path)
        sweep_infos = []
        for j in range(sweeps):
            yaw = rng.uniform(-0.02, 0.02)
            c, s = math.cos(yaw), math.sin(yaw)
            rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
            shift = rng.uniform(-0.25, 0.25, 3) * (j + 1)
            sp = pts[rng.uniform(size=len(pts)) < 0.97].copy()
            sp[:, :3] += rng.normal(0.0, 0.02, (len(sp), 3))
            # lidar = rot @ sensor + shift  =>  sensor = rot^T (lidar - shift)
            sp[:, :3] = (sp[:, :3] - shift) @ rot
            path = root / "sweeps" / f"lidar_{i:04d}_{j}.bin"
            sp.astype(np.float32).tofile(path)
            sweep_infos.append({
                "data_path": str(path), "sensor2lidar_rotation": rot,
                "sensor2lidar_translation": shift,
                "timestamp": ts - (j + 1) * 50_000})
        # key-frame points inside each bottom-centred box
        d = pts[:, None, :2] - gt[None, :, :2]
        cy, sy = np.cos(gt[:, 6]), np.sin(gt[:, 6])
        lx = d[..., 0] * cy + d[..., 1] * sy
        ly = -d[..., 0] * sy + d[..., 1] * cy
        dz = pts[:, None, 2] - gt[None, :, 2]
        inside = ((np.abs(lx) <= gt[:, 3] / 2) & (np.abs(ly) <= gt[:, 4] / 2)
                  & (dz >= 0) & (dz <= gt[:, 5]))
        n_in = inside.sum(0).astype(np.int64)
        infos.append({
            "token": f"sample_{i:04d}", "lidar_path": str(lidar_path),
            "timestamp": ts, "sweeps": sweep_infos,
            "gt_boxes": gt[:, :7].copy(),
            "gt_names": np.array([classes[k] for k in labels], object),
            "gt_velocity": gt[:, 7:9].astype(np.float64),
            "num_lidar_pts": n_in, "valid_flag": n_in > 0,
            "lidar2ego_rotation": _quat_z(0.01),
            "lidar2ego_translation": [0.94, 0.0, 1.84],
            "ego2global_rotation": _quat_z(0.3 + 0.05 * i),
            "ego2global_translation": [600.0 + 2.0 * i, 1600.0, 0.0]})
        if cameras:
            rig = synthetic.ring_camera_infos(cam_rng, len(CAM_ORDER), img_hw)
            infos[-1]["cams"] = dict(zip(CAM_ORDER, rig))
            frames = synthetic.camera_frames(
                cam_rng, pts, lidar2img_matrices(infos[-1]), img_hw)
            for name, cam in infos[-1]["cams"].items():
                cam["data_path"] = str(root / "samples" / f"{name}_{i:04d}.jpg")
            image_io.parallel_map(
                lambda a: image_io.imwrite(a[0], a[1], quality=90),
                [(c["data_path"], f) for c, f in
                 zip(infos[-1]["cams"].values(), frames)])
    ann = root / "nuscenes_infos_train.pkl"
    for name in ("nuscenes_infos_train.pkl", "nuscenes_infos_val.pkl"):
        with open(root / name, "wb") as f:
            pickle.dump({"infos": infos, "metadata": {"version": "synthetic"}},
                        f)
    return str(ann)


def _rot(axis, angle):
    """4 x 4 rotation by ``angle`` about axis 0 (x), 1 (y) or 2 (z)."""
    c, s = math.cos(angle), math.sin(angle)
    i, j = [(1, 2), (2, 0), (0, 1)][axis]
    m = np.eye(4)
    m[i, i], m[i, j], m[j, i], m[j, j] = c, -s, s, c
    return m


def write_waymo(root, *, seed, frames, points, pc_range, classes, boxes=12):
    """Write a Waymo directory in mmdet3d's KITTI layout (what
    ``data/waymo.py`` reads) from the port's synthetic scenes: per frame a
    radial scan of ``points`` points (``data/synthetic.make_scene``) as a
    float32 ``.bin`` of 6 columns (the 5 of the scan and one more, as
    Waymo's load_dim 6), and an info with the KITTI calibration (a
    non-identity ``R0_rect`` and ``Tr_velo_to_cam``: the LiDAR-to-camera
    axis swap after a small rotation and shift) and ``annos`` in the camera
    frame (location of the bottom centre, dimensions (l, h, w),
    rotation_y), one ``DontCare`` row, ``difficulty`` (0, 1 or 2) and
    ``num_points_in_gt`` (the scan's points in the box), so that some boxes
    are LEVEL_2 only. One pickle is written as both
    ``waymo_infos_train.pkl`` and ``waymo_infos_val.pkl``. Returns the
    train infos' path."""
    root = pathlib.Path(root)
    (root / "training" / "velodyne").mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    axes = np.array([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0],
                     [0, 0, 0, 1.0]])  # x_cam = -y, y_cam = -z, z_cam = x
    infos = []
    for i in range(frames):
        pts, gt, labels = synthetic.make_scene(
            rng, n_points=points, n_boxes=boxes, num_classes=len(classes),
            pc_range=pc_range, mode="radial")
        extra = rng.uniform(0.0, 1.0, (len(pts), 1)).astype(np.float32)
        rel = f"training/velodyne/{i:06d}.bin"
        np.concatenate([pts, extra], 1).astype(np.float32).tofile(root / rel)
        rect = _rot(0, rng.uniform(-0.02, 0.02))
        trv2c = axes @ _rot(2, rng.uniform(-0.05, 0.05))
        trv2c[:3, 3] = rng.uniform(-0.3, 0.3, 3)
        lidar2cam = rect @ trv2c
        loc = (np.concatenate([gt[:, :3], np.ones((len(gt), 1))], 1)
               @ lidar2cam.T)[:, :3]
        dims = gt[:, [3, 5, 4]].astype(np.float64)  # (l, h, w)
        rot_y = -gt[:, 6].astype(np.float64) - np.pi / 2
        # the scan's points in each bottom-centred box
        d = pts[:, None, :2] - gt[None, :, :2]
        cy, sy = np.cos(gt[:, 6]), np.sin(gt[:, 6])
        lx = d[..., 0] * cy + d[..., 1] * sy
        ly = -d[..., 0] * sy + d[..., 1] * cy
        dz = pts[:, None, 2] - gt[None, :, 2]
        n_in = ((np.abs(lx) <= gt[:, 3] / 2) & (np.abs(ly) <= gt[:, 4] / 2)
                & (dz >= 0) & (dz <= gt[:, 5])).sum(0)
        infos.append({
            "image": {"image_idx": i},
            "point_cloud": {"num_features": 6, "velodyne_path": rel},
            "calib": {"R0_rect": rect, "Tr_velo_to_cam": trv2c},
            "annos": {
                "name": np.array([classes[k] for k in labels] + ["DontCare"],
                                 object),
                "location": np.concatenate([loc, [[0.0, 1.0, 30.0]]]),
                "dimensions": np.concatenate([dims, [[1.0, 1.0, 1.0]]]),
                "rotation_y": np.concatenate([rot_y, [0.0]]),
                "difficulty": np.concatenate(
                    [rng.choice([0, 0, 1, 2], len(gt)), [0]]).astype(np.int32),
                "num_points_in_gt": np.concatenate([n_in, [0]]).astype(
                    np.int32),
            },
        })
    for name in ("waymo_infos_train.pkl", "waymo_infos_val.pkl"):
        with open(root / name, "wb") as f:
            pickle.dump(infos, f)
    return str(root / "waymo_infos_train.pkl")

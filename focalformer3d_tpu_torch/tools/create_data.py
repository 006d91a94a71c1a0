"""Offline data preparation: nuScenes info pickles + GT-paste database.

Port of ``tools/create_data.py`` (the counterpart of the reference's
tools/create_data.py + tools/data_converter/{nuscenes_converter,
create_gt_database}.py). It writes what the runtime reads, in mmdet3d
v0.17's formats:

  nuscenes_infos_{train,val}.pkl   per-sample info dicts
  nuscenes_dbinfos_train.pkl       GT database index
  nuscenes_gt_database/*.bin       per-instance point patches

Info generation needs the official nuscenes-devkit and the raw dataset
(imported when called; it raises without them). The GT database is built
from existing info pkls alone, with the port's own point loading:

    python -m focalformer3d_tpu_torch.tools.create_data gt-db \\
        --ann-file data/nuscenes/nuscenes_infos_train.pkl \\
        --data-root data/nuscenes
"""
from __future__ import annotations

import argparse
import pickle
from pathlib import Path
from typing import List, Optional

import numpy as np

NAME_MAPPING = {
    "movable_object.barrier": "barrier",
    "vehicle.bicycle": "bicycle",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.car": "car",
    "vehicle.construction": "construction_vehicle",
    "vehicle.motorcycle": "motorcycle",
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "human.pedestrian.police_officer": "pedestrian",
    "movable_object.trafficcone": "traffic_cone",
    "vehicle.trailer": "trailer",
    "vehicle.truck": "truck",
}

CAMS = (
    "CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_FRONT_LEFT",
    "CAM_BACK", "CAM_BACK_LEFT", "CAM_BACK_RIGHT",
)


def _quat_rot(q):
    from ..core.results import quat_to_mat

    return quat_to_mat(q)


def create_nuscenes_infos(data_root: str, version: str = "v1.0-trainval",
                          max_sweeps: int = 10, out_dir: str | None = None):
    """Build mmdet3d-format info pkls with the nuscenes-devkit."""
    try:
        from nuscenes.nuscenes import NuScenes
        from nuscenes.utils import splits
    except ImportError as e:
        raise SystemExit(
            "nuscenes-devkit is required for info generation and is not "
            "installed. Infos produced by mmdet3d are byte-compatible and "
            "can be used directly."
        ) from e

    nusc = NuScenes(version=version, dataroot=data_root, verbose=True)
    if version == "v1.0-trainval":
        train_scenes = set(splits.train)
        val_scenes = set(splits.val)
    elif version == "v1.0-mini":
        train_scenes = set(splits.mini_train)
        val_scenes = set(splits.mini_val)
    else:
        raise SystemExit(f"unsupported version {version}")

    def sensor_to_lidar(sd_token, lidar_cs, lidar_pose):
        sd = nusc.get("sample_data", sd_token)
        cs = nusc.get("calibrated_sensor", sd["calibrated_sensor_token"])
        pose = nusc.get("ego_pose", sd["ego_pose_token"])
        R_s2g = _quat_rot(pose["rotation"]) @ _quat_rot(cs["rotation"])
        t_s2g = (
            _quat_rot(pose["rotation"]) @ np.asarray(cs["translation"])
            + np.asarray(pose["translation"])
        )
        R_l2g = _quat_rot(lidar_pose["rotation"]) @ _quat_rot(
            lidar_cs["rotation"]
        )
        t_l2g = (
            _quat_rot(lidar_pose["rotation"])
            @ np.asarray(lidar_cs["translation"])
            + np.asarray(lidar_pose["translation"])
        )
        R = R_l2g.T @ R_s2g
        t = R_l2g.T @ (t_s2g - t_l2g)
        return sd, cs, R, t

    train_infos, val_infos = [], []
    for sample in nusc.sample:
        scene = nusc.get("scene", sample["scene_token"])["name"]
        lidar_token = sample["data"]["LIDAR_TOP"]
        sd = nusc.get("sample_data", lidar_token)
        lidar_cs = nusc.get(
            "calibrated_sensor", sd["calibrated_sensor_token"]
        )
        lidar_pose = nusc.get("ego_pose", sd["ego_pose_token"])
        info = {
            "token": sample["token"],
            "lidar_path": str(Path(data_root) / sd["filename"]),
            "timestamp": sample["timestamp"],
            "lidar2ego_rotation": lidar_cs["rotation"],
            "lidar2ego_translation": lidar_cs["translation"],
            "ego2global_rotation": lidar_pose["rotation"],
            "ego2global_translation": lidar_pose["translation"],
            "sweeps": [],
            "cams": {},
        }
        # sweeps: walk prev pointers
        prev = sd["prev"]
        while prev and len(info["sweeps"]) < max_sweeps:
            psd, _, R, t = sensor_to_lidar(prev, lidar_cs, lidar_pose)
            info["sweeps"].append({
                "data_path": str(Path(data_root) / psd["filename"]),
                "sensor2lidar_rotation": R,
                "sensor2lidar_translation": t,
                "timestamp": psd["timestamp"],
            })
            prev = psd["prev"]
        for cam in CAMS:
            csd, ccs, R, t = sensor_to_lidar(
                sample["data"][cam], lidar_cs, lidar_pose
            )
            info["cams"][cam] = {
                "data_path": str(Path(data_root) / csd["filename"]),
                "sensor2lidar_rotation": R,
                "sensor2lidar_translation": t,
                "cam_intrinsic": np.asarray(ccs["camera_intrinsic"]),
            }
        # annotations in lidar frame
        boxes, names, vels, npts, valid = [], [], [], [], []
        for ann_token in sample["anns"]:
            ann = nusc.get("sample_annotation", ann_token)
            raw = ann["category_name"]
            if raw not in NAME_MAPPING:
                continue
            box = nusc.get_box(ann_token)
            gvel = nusc.box_velocity(ann_token)[:2]
            R_l2g = _quat_rot(lidar_pose["rotation"]) @ _quat_rot(
                lidar_cs["rotation"]
            )
            t_l2g = (
                _quat_rot(lidar_pose["rotation"])
                @ np.asarray(lidar_cs["translation"])
                + np.asarray(lidar_pose["translation"])
            )
            c = R_l2g.T @ (box.center - t_l2g)
            Rb = R_l2g.T @ box.rotation_matrix
            yaw = np.arctan2(Rb[1, 0], Rb[0, 0])
            w, l, h = box.wlh
            boxes.append([c[0], c[1], c[2] - h / 2, l, w, h, yaw])
            names.append(NAME_MAPPING[raw])
            vels.append(R_l2g.T[:2, :2] @ np.nan_to_num(gvel))
            npts.append(ann["num_lidar_pts"])
            valid.append(
                ann["num_lidar_pts"] + ann["num_radar_pts"] > 0
            )
        info["gt_boxes"] = np.asarray(boxes, np.float32).reshape(-1, 7)
        info["gt_names"] = np.asarray(names, object)
        info["gt_velocity"] = np.asarray(vels, np.float32).reshape(-1, 2)
        info["num_lidar_pts"] = np.asarray(npts, np.int64)
        info["valid_flag"] = np.asarray(valid, bool)
        (train_infos if scene in train_scenes else val_infos).append(info)

    out = Path(out_dir or data_root)
    meta = {"version": version}
    for split, infos in (("train", train_infos), ("val", val_infos)):
        p = out / f"nuscenes_infos_{split}.pkl"
        with open(p, "wb") as f:
            pickle.dump({"infos": infos, "metadata": meta}, f)
        print(f"wrote {p} ({len(infos)} samples)")


def create_gt_database(ann_file: str, data_root: str, out_dir: str | None,
                       sweeps_num: int = 0):
    """Build the GT-paste database from an existing info pkl
    (create_gt_database.py semantics: per-instance box-local point patches
    from key-frame points)."""
    from ..data import nuscenes as nusc

    ds = nusc.NuScenesDataset(
        ann_file, data_root=data_root, pipeline=None, sweeps_num=sweeps_num
    )
    out = Path(out_dir or data_root)
    db_dir = out / "nuscenes_gt_database"
    db_dir.mkdir(parents=True, exist_ok=True)
    dbinfos: dict = {}
    for i in range(len(ds)):
        s = ds.get_sample(i)
        pts = s["points"]
        boxes = s.get("gt_boxes", np.zeros((0, 9)))
        names = s.get("gt_names", [])
        if not len(boxes):
            continue
        inside = nusc.points_in_rbbox(pts[:, :3], boxes)
        for gi in range(len(boxes)):
            patch = pts[inside[:, gi]].copy()
            patch[:, :3] -= boxes[gi, :3]
            name = str(names[gi])
            fn = f"{i}_{name}_{gi}.bin"
            patch.astype(np.float32).tofile(db_dir / fn)
            dbinfos.setdefault(name, []).append({
                "name": name,
                "path": f"nuscenes_gt_database/{fn}",
                "image_idx": i,
                "gt_idx": gi,
                "box3d_lidar": boxes[gi, :7].astype(np.float32),
                "num_points_in_gt": int(len(patch)),
                "difficulty": 0,
            })
        if (i + 1) % 500 == 0:
            print(f"{i + 1}/{len(ds)}")
    p = out / "nuscenes_dbinfos_train.pkl"
    with open(p, "wb") as f:
        pickle.dump(dbinfos, f)
    counts = {k: len(v) for k, v in dbinfos.items()}
    print(f"wrote {p}: {counts}")


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)
    pi = sub.add_parser("infos")
    pi.add_argument("--data-root", required=True)
    pi.add_argument("--version", default="v1.0-trainval")
    pi.add_argument("--max-sweeps", type=int, default=10)
    pi.add_argument("--out-dir", default=None)
    pg = sub.add_parser("gt-db")
    pg.add_argument("--ann-file", required=True)
    pg.add_argument("--data-root", required=True)
    pg.add_argument("--out-dir", default=None)
    a = p.parse_args(argv)
    if a.cmd == "infos":
        create_nuscenes_infos(a.data_root, a.version, a.max_sweeps,
                              a.out_dir)
    else:
        create_gt_database(a.ann_file, a.data_root, a.out_dir)


if __name__ == "__main__":
    main()

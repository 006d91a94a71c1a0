"""Result formatting: lidar-frame predictions -> nuScenes submission JSON.

The port's copy of ``focalformer3d_tpu/core/results.py``, the counterpart
of mmdet3d ``NuScenesDataset.format_results`` / ``output_to_nusc_box`` /
``lidar_nusc_box_to_global`` as the reference's test script calls them
(tools/test.py:242-254). It uses the info-pkl calibration (lidar2ego /
ego2global quaternions) and plain NumPy quaternion math: no pyquaternion or
devkit.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Sequence

import numpy as np

from ..data.nuscenes import DEFAULT_ATTRIBUTES


def quat_to_mat(q: Sequence[float]) -> np.ndarray:
    """(w, x, y, z) -> 3x3 rotation matrix."""
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float64)


def yaw_to_quat(yaw: float) -> list:
    return [float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))]


def mat_to_yaw(R: np.ndarray) -> float:
    return float(np.arctan2(R[1, 0], R[0, 0]))


def boxes_lidar_to_global(info: dict, boxes: np.ndarray):
    """(N, 9) lidar-frame boxes -> (centers, dims, yaws, velocities) in the
    global frame. Gravity-center convention for submission (nuScenes boxes
    are center-based; our lidar boxes are bottom-centered)."""
    l2e_r = quat_to_mat(info["lidar2ego_rotation"])
    l2e_t = np.asarray(info["lidar2ego_translation"], np.float64)
    e2g_r = quat_to_mat(info["ego2global_rotation"])
    e2g_t = np.asarray(info["ego2global_translation"], np.float64)
    R = e2g_r @ l2e_r
    t = e2g_r @ l2e_t + e2g_t

    centers = boxes[:, :3].astype(np.float64).copy()
    centers[:, 2] += boxes[:, 5] / 2.0  # bottom -> gravity center
    centers = centers @ R.T + t
    yaws = boxes[:, 6] + mat_to_yaw(R)
    vel = np.zeros((len(boxes), 3))
    if boxes.shape[1] >= 9:
        vel[:, :2] = boxes[:, 7:9]
        vel = vel @ R.T
    return centers, boxes[:, 3:6], yaws, vel[:, :2]


def velocity_attribute(name: str, speed: float) -> str:
    """devkit-style attribute heuristic: moving vehicles/cycles/pedestrians
    get the moving attribute (mmdet3d NuScenesDataset._format_bbox)."""
    if speed > 0.2:
        if name in (
            "car", "construction_vehicle", "bus", "truck", "trailer"
        ):
            return "vehicle.moving"
        if name in ("bicycle", "motorcycle"):
            return "cycle.with_rider"
        if name == "pedestrian":
            return "pedestrian.moving"
    return DEFAULT_ATTRIBUTES.get(name, "")


def format_nuscenes_submission(
    predictions: Dict[str, dict],  # token -> {boxes, scores, labels}
    infos_by_token: Dict[str, dict],
    class_names: Sequence[str],
    out_path: str | None = None,
    max_boxes: int = 500,
) -> dict:
    results = {}
    for token, pr in predictions.items():
        info = infos_by_token[token]
        boxes = np.asarray(pr["boxes"])
        scores = np.asarray(pr["scores"])
        labels = np.asarray(pr["labels"])
        order = np.argsort(-scores)[:max_boxes]
        centers, dims, yaws, vel = boxes_lidar_to_global(info, boxes[order])
        anns = []
        for i, oi in enumerate(order):
            name = class_names[int(labels[oi])]
            # nuScenes submission size is (w, l, h) = (dy, dx, dz)
            anns.append({
                "sample_token": token,
                "translation": centers[i].tolist(),
                "size": [float(dims[i][1]), float(dims[i][0]),
                         float(dims[i][2])],
                "rotation": yaw_to_quat(float(yaws[i])),
                "velocity": vel[i].tolist(),
                "detection_name": name,
                "detection_score": float(scores[oi]),
                "attribute_name": velocity_attribute(
                    name, float(np.linalg.norm(vel[i]))
                ),
            })
        results[token] = anns
    submission = {
        "meta": {
            "use_camera": False, "use_lidar": True, "use_radar": False,
            "use_map": False, "use_external": False,
        },
        "results": results,
    }
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(submission, f)
    return submission


def tracking_from_detections(submission: dict, out_path: str | None = None):
    """Greedy velocity-based tracker over detection results, producing the
    nuScenes tracking-format output (the reference reports AMOTA from an
    external tracker on its detections; this provides the format plumbing).
    """
    results = {}
    next_id = [0]
    prev: Dict[str, list] = {}

    def new_id():
        next_id[0] += 1
        return f"t{next_id[0]}"

    for token, anns in submission["results"].items():
        out = []
        for a in anns:
            # nearest previous track of same class within 2 m (after const-
            # velocity extrapolation is omitted: frames ~0.5 s apart)
            best, best_d = None, 2.0
            for tr in prev.get(a["detection_name"], []):
                d = np.linalg.norm(
                    np.asarray(a["translation"][:2])
                    - np.asarray(tr["translation"][:2])
                )
                if d < best_d:
                    best, best_d = tr, d
            tid = best["tracking_id"] if best else new_id()
            out.append({
                **{k: a[k] for k in (
                    "sample_token", "translation", "size", "rotation",
                    "velocity",
                )},
                "tracking_id": tid,
                "tracking_name": a["detection_name"],
                "tracking_score": a["detection_score"],
            })
        prev = {}
        for o in out:
            prev.setdefault(o["tracking_name"], []).append(o)
        results[token] = out
    track_sub = {"meta": submission["meta"], "results": results}
    if out_path:
        with open(out_path, "w") as f:
            json.dump(track_sub, f)
    return track_sub

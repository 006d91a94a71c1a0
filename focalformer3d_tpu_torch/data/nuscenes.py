"""nuScenes dataset: mmdet3d-format info-pkl reader, multi-sweep point
loading, CBGS class-balanced resampling, GT-paste (ObjectSample), and
fixed-shape batch collation.

The port's copy of ``focalformer3d_tpu/data/nuscenes.py``, the
counterpart of the reference's data stack (mmdet3d ``NuScenesDataset``
+ ``LoadPointsFromFile`` / ``LoadPointsFromMultiSweeps`` + ``CBGSDataset``
+ ``ObjectSample``, configured at FocalFormer3D_L.py:28-149). The info and
dbinfo pickle formats stay byte-compatible with mmdet3d v0.17, so existing
preprocessed nuScenes directories work unchanged. It draws the same numbers
from the same ``numpy.random.RandomState`` calls as the original, so both
packages give equal samples and batches for one seed
(``tests/test_torch_data.py``).

Everything here is host-side NumPy; ``collate`` gives a dict of
fixed-shape arrays for the device (padded points + masks, padded GTs,
``bev_aug``, and with ``with_images`` the images, ``lidar2img`` and
``img_aug``). Points load through the native loader (``data/native``),
which raises if it cannot be built; ``use_native=False`` takes the numpy
path. Camera images decode through ``data/image_io`` (the port's baseline
JPEG decoder, bit for bit with Pillow's libjpeg-turbo, where the JAX copy
calls ``Image.open``), a sample's six side by side; it raises on a file it
cannot read and has no fallback either.
"""
from __future__ import annotations

import pickle
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from . import image_io
from . import transforms as T

CLASS_NAMES = (
    "car", "truck", "construction_vehicle", "bus", "trailer", "barrier",
    "motorcycle", "bicycle", "pedestrian", "traffic_cone",
)

# nuScenes attribute defaults per class for submission formatting
# (mmdet3d NuScenesDataset.DefaultAttribute).
DEFAULT_ATTRIBUTES = {
    "car": "vehicle.parked",
    "pedestrian": "pedestrian.moving",
    "trailer": "vehicle.parked",
    "truck": "vehicle.parked",
    "bus": "vehicle.moving",
    "motorcycle": "cycle.without_rider",
    "construction_vehicle": "vehicle.parked",
    "bicycle": "cycle.without_rider",
    "barrier": "",
    "traffic_cone": "",
}

CAM_ORDER = (
    "CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_FRONT_LEFT",
    "CAM_BACK", "CAM_BACK_LEFT", "CAM_BACK_RIGHT",
)


# ---------------------------------------------------------------------------
# point loading
# ---------------------------------------------------------------------------

def load_points(path: str, load_dim: int = 5) -> np.ndarray:
    pts = np.fromfile(path, dtype=np.float32).reshape(-1, load_dim)
    return pts


def _remove_close(points: np.ndarray, radius: float = 1.0) -> np.ndarray:
    keep = ~(
        (np.abs(points[:, 0]) < radius) & (np.abs(points[:, 1]) < radius)
    )
    return points[keep]


def load_points_multisweep(
    info: dict,
    sweeps_num: int = 10,
    load_dim: int = 5,
    rng: Optional[np.random.RandomState] = None,
    test_mode: bool = False,
    remove_close: bool = True,
    use_native: bool = True,
) -> np.ndarray:
    """Key-frame points + up to sweeps_num accumulated sweeps, each mapped
    into the key lidar frame; dim 4 carries the time lag in seconds
    (mmdet3d LoadPointsFromMultiSweeps semantics).

    With ``use_native`` the file reads + rigid transforms + close filter run
    in the multithreaded C++ loader (data/native), which raises if it
    cannot be built; without, in NumPy."""
    ts = info["timestamp"] / 1e6
    sweeps = info.get("sweeps", [])
    if len(sweeps) <= sweeps_num:
        choices = np.arange(len(sweeps))
    elif test_mode or rng is None:
        choices = np.arange(sweeps_num)
    else:
        choices = rng.choice(len(sweeps), sweeps_num, replace=False)

    if use_native:
        n = 1 + len(choices)
        paths = [info["lidar_path"]] + [
            sweeps[i]["data_path"] for i in choices
        ]
        rot = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
        tr = np.zeros((n, 3), np.float32)
        tl = np.zeros((n,), np.float32)
        use_rt = np.zeros((n,), np.uint8)
        rc = np.zeros((n,), np.uint8)
        for j, i in enumerate(choices):
            sw = sweeps[i]
            rot[j + 1] = np.asarray(sw["sensor2lidar_rotation"], np.float32)
            tr[j + 1] = np.asarray(sw["sensor2lidar_translation"],
                                   np.float32)
            tl[j + 1] = ts - sw["timestamp"] / 1e6
            use_rt[j + 1] = 1
            rc[j + 1] = 1 if remove_close else 0
        from . import native

        return native.load_sweeps_native(
            paths, rot, tr, tl, use_rt, use_rt, rc, load_dim=load_dim,
        )

    pts = load_points(info["lidar_path"], load_dim)
    pts[:, 4] = 0.0
    out = [pts]
    for i in choices:
        sw = sweeps[i]
        p = load_points(sw["data_path"], load_dim)
        if remove_close:
            p = _remove_close(p)
        R = np.asarray(sw["sensor2lidar_rotation"], np.float32)
        t = np.asarray(sw["sensor2lidar_translation"], np.float32)
        p[:, :3] = p[:, :3] @ R.T + t
        p[:, 4] = ts - sw["timestamp"] / 1e6
        out.append(p)
    return np.concatenate(out, 0)


def lidar2img_matrices(info: dict,
                       cam_order: Sequence[str] = CAM_ORDER) -> np.ndarray:
    """(Ncam, 4, 4) lidar -> image-pixel projective matrices."""
    mats = []
    for name in cam_order:
        cam = info["cams"][name]
        R = np.asarray(cam["sensor2lidar_rotation"], np.float64)
        t = np.asarray(cam["sensor2lidar_translation"], np.float64)
        l2c = np.eye(4)
        l2c[:3, :3] = R.T
        l2c[:3, 3] = -R.T @ t
        K = np.eye(4)
        K[:3, :3] = np.asarray(cam["cam_intrinsic"], np.float64)
        mats.append((K @ l2c).astype(np.float32))
    return np.stack(mats)


# ---------------------------------------------------------------------------
# GT-paste sampling (ObjectSample + db_sampler)
# ---------------------------------------------------------------------------

def _rect_corners_bev(boxes: np.ndarray) -> np.ndarray:
    """(N, 7+) boxes -> (N, 4, 2) BEV corners."""
    cx, cy, dx, dy, yaw = (
        boxes[:, 0], boxes[:, 1], boxes[:, 3], boxes[:, 4], boxes[:, 6]
    )
    base = np.array(
        [[0.5, 0.5], [0.5, -0.5], [-0.5, -0.5], [-0.5, 0.5]], np.float32
    )
    corners = base[None] * np.stack([dx, dy], -1)[:, None]
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.stack(
        [np.stack([c, -s], -1), np.stack([s, c], -1)], -2
    )  # (N, 2, 2)
    corners = np.einsum("nij,nkj->nki", rot, corners)
    return corners + np.stack([cx, cy], -1)[:, None]


def _rects_collide(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Separating-axis test between two corner sets (N,4,2) x (M,4,2) ->
    (N, M) bool collision matrix. Exact for convex rectangles."""
    N, M = len(a), len(b)
    if N == 0 or M == 0:
        return np.zeros((N, M), bool)

    def axes(c):  # (K, 4, 2) edge normals (unnormalized)
        e = np.roll(c, -1, axis=1) - c
        return np.stack([-e[..., 1], e[..., 0]], -1)

    ax = np.concatenate([axes(a)[:, None].repeat(M, 1),
                         np.broadcast_to(axes(b)[None], (N, M, 4, 2))], 2)
    # project both rects on each of the 8 axes
    pa = np.einsum("nmkd,npd->nmkp", ax, a)  # (N,M,8,4)
    pb = np.einsum("nmkd,mpd->nmkp", ax, b)
    sep = (pa.max(-1) < pb.min(-1)) | (pb.max(-1) < pa.min(-1))
    return ~sep.any(-1)


class DBSampler:
    """Class-grouped GT-database sampler (mmdet3d DataBaseSampler).

    dbinfos pickle: {class_name: [{'name','path','box3d_lidar',
    'num_points_in_gt','difficulty',...}, ...]}.
    """

    def __init__(self, info_path: str, data_root: str, classes,
                 sample_groups: Dict[str, int],
                 min_points: Dict[str, int],
                 filter_difficulty=(-1,), load_dim: int = 5):
        with open(info_path, "rb") as f:
            dbinfos = pickle.load(f)
        self.data_root = Path(data_root)
        self.classes = list(classes)
        self.groups = dict(sample_groups)
        self.load_dim = load_dim
        self.infos = {}
        for name, lst in dbinfos.items():
            if name not in self.classes:
                continue
            lst = [
                d for d in lst
                if d.get("difficulty", 0) not in filter_difficulty
                and d.get("num_points_in_gt", 1) >= min_points.get(name, 0)
            ]
            self.infos[name] = lst

    def sample(self, gt_boxes: np.ndarray, gt_names: np.ndarray,
               rng: np.random.RandomState):
        """Returns (boxes (S,9), names (S,), points (P,load_dim))."""
        sampled_boxes, sampled_names, sampled_pts = [], [], []
        avoid = gt_boxes.copy() if len(gt_boxes) else np.zeros((0, 9),
                                                               np.float32)
        for name, target in self.groups.items():
            pool = self.infos.get(name, [])
            if not pool:
                continue
            have = int((gt_names == name).sum()) if len(gt_names) else 0
            need = max(0, target - have)
            if need == 0:
                continue
            picks = rng.choice(len(pool), min(need, len(pool)),
                               replace=False)
            for pi in picks:
                d = pool[int(pi)]
                box = np.asarray(d["box3d_lidar"], np.float32)
                if box.shape[0] < 9:
                    box = np.concatenate(
                        [box, np.zeros(9 - box.shape[0], np.float32)]
                    )
                cand = box[None]
                if len(avoid):
                    col = _rects_collide(
                        _rect_corners_bev(cand), _rect_corners_bev(avoid)
                    )
                    if col.any():
                        continue
                path = self.data_root / d["path"]
                try:
                    pts = np.fromfile(
                        str(path), dtype=np.float32
                    ).reshape(-1, self.load_dim)
                except (FileNotFoundError, ValueError):
                    continue
                pts = pts.copy()
                pts[:, :3] += box[:3]
                if self.load_dim > 4:
                    pts[:, 4] = 0.0
                sampled_boxes.append(box)
                sampled_names.append(d["name"])
                sampled_pts.append(pts)
                avoid = np.concatenate([avoid, cand], 0)
        if not sampled_boxes:
            return (np.zeros((0, 9), np.float32), np.array([], object),
                    np.zeros((0, self.load_dim), np.float32))
        return (
            np.stack(sampled_boxes),
            np.array(sampled_names, object),
            np.concatenate(sampled_pts, 0),
        )


class ObjectSample:
    """Paste sampled GT instances into the scene; removes raw points inside
    the pasted boxes first (mmdet3d ObjectSample)."""

    def __init__(self, sampler: DBSampler):
        self.sampler = sampler

    def __call__(self, sample: dict, rng: np.random.RandomState) -> dict:
        boxes, names, pts = self.sampler.sample(
            sample.get("gt_boxes", np.zeros((0, 9), np.float32)),
            sample.get("gt_names", np.array([], object)), rng,
        )
        if not len(boxes):
            return sample
        raw = sample["points"]
        inside = points_in_rbbox(raw[:, :3], boxes)
        raw = raw[~inside.any(-1)]
        sample["points"] = np.concatenate([pts, raw], 0)
        sample["gt_boxes"] = np.concatenate(
            [sample["gt_boxes"], boxes], 0
        ) if len(sample.get("gt_boxes", [])) else boxes
        sample["gt_names"] = np.concatenate(
            [sample["gt_names"], names], 0
        ) if len(sample.get("gt_names", [])) else names
        return sample


def points_in_rbbox(points: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """(P, 3) x (N, 7+) -> (P, N) bool. Boxes are bottom-centered (LiDAR)."""
    if len(boxes) == 0 or len(points) == 0:
        return np.zeros((len(points), len(boxes)), bool)
    d = points[:, None, :2] - boxes[None, :, :2]
    c, s = np.cos(-boxes[:, 6]), np.sin(-boxes[:, 6])
    lx = d[..., 0] * c - d[..., 1] * s
    ly = d[..., 0] * s + d[..., 1] * c
    in_xy = (np.abs(lx) <= boxes[:, 3] / 2) & (np.abs(ly) <= boxes[:, 4] / 2)
    z = points[:, None, 2]
    in_z = (z >= boxes[:, 2]) & (z <= boxes[:, 2] + boxes[:, 5])
    return in_xy & in_z


# ---------------------------------------------------------------------------
# dataset
# ---------------------------------------------------------------------------

class NuScenesDataset:
    """Reads mmdet3d nuscenes_infos_*.pkl; produces per-sample dicts."""

    def __init__(
        self,
        ann_file: str,
        data_root: str = "",
        classes: Sequence[str] = CLASS_NAMES,
        pipeline: Optional[Sequence] = None,
        sweeps_num: int = 10,
        load_dim: int = 5,
        with_images: bool = False,
        test_mode: bool = False,
        load_interval: int = 1,
        use_valid_flag: bool = True,
    ):
        with open(ann_file, "rb") as f:
            data = pickle.load(f)
        infos = sorted(data["infos"], key=lambda e: e["timestamp"])
        self.infos = infos[::load_interval]
        self.metadata = data.get("metadata", {})
        self.data_root = data_root
        self.classes = list(classes)
        self.pipeline = T.Compose(pipeline) if pipeline else None
        self.sweeps_num = sweeps_num
        self.load_dim = load_dim
        self.with_images = with_images
        self.test_mode = test_mode
        self.use_valid_flag = use_valid_flag

    def __len__(self):
        return len(self.infos)

    def cat_sample_indices(self) -> Dict[str, List[int]]:
        """class name -> indices of samples containing it (for CBGS)."""
        out = {c: [] for c in self.classes}
        for i, info in enumerate(self.infos):
            names = set(np.asarray(info["gt_names"]).tolist())
            for c in names & set(self.classes):
                out[c].append(i)
        return out

    def cbgs_indices(self, rng: np.random.RandomState) -> np.ndarray:
        """Class-balanced duplicated index list (mmdet3d CBGSDataset)."""
        cat2idx = self.cat_sample_indices()
        total = sum(len(v) for v in cat2idx.values())
        duplicated = []
        frac = 1.0 / len(self.classes)
        for c in self.classes:
            idxs = cat2idx[c]
            if not idxs:
                continue
            ratio = frac / (len(idxs) / total)
            take = max(1, int(len(idxs) * ratio))
            reps = rng.choice(idxs, take, replace=True)
            duplicated.extend(reps.tolist())
        return np.asarray(duplicated, np.int64)

    def get_sample(self, idx: int,
                   rng: Optional[np.random.RandomState] = None) -> dict:
        info = self.infos[idx]
        rng = rng or np.random.RandomState()
        points = load_points_multisweep(
            info, self.sweeps_num, self.load_dim, rng, self.test_mode
        )
        sample = {
            "points": points,
            "token": info["token"],
            "bev_aug": np.eye(4, dtype=np.float32),
        }
        if not self.test_mode or "gt_boxes" in info:
            mask = (
                np.asarray(info["valid_flag"], bool)
                if self.use_valid_flag and "valid_flag" in info
                else np.asarray(info.get("num_lidar_pts", []), np.int64) > 0
            )
            gt_boxes = np.asarray(info["gt_boxes"], np.float32)
            gt_names = np.asarray(info["gt_names"], object)
            vel = np.asarray(
                info.get("gt_velocity", np.zeros((len(gt_boxes), 2))),
                np.float32,
            )
            vel = np.nan_to_num(vel)
            if len(mask) == len(gt_boxes):
                gt_boxes, gt_names, vel = (
                    gt_boxes[mask], gt_names[mask], vel[mask]
                )
            sample["gt_boxes"] = np.concatenate([gt_boxes, vel], -1)
            sample["gt_names"] = gt_names
        if self.with_images:
            # the JAX copy: np.asarray(Image.open(p), dtype=np.float32),
            # then RGB -> BGR; here the six cameras side by side
            sample["imgs"] = image_io.parallel_map(
                lambda p: image_io.imread(p).astype(np.float32)[..., ::-1],
                [info["cams"][name]["data_path"] for name in CAM_ORDER])
            sample["lidar2img"] = lidar2img_matrices(info)
            sample["img_aug"] = np.broadcast_to(
                np.eye(4, dtype=np.float32), sample["lidar2img"].shape
            ).copy()
        if self.pipeline is not None:
            sample = self.pipeline(sample, rng)
        return sample

    def labels_from_names(self, names: np.ndarray) -> np.ndarray:
        return np.asarray(
            [self.classes.index(n) for n in names], np.int32
        )


def collate(
    samples: List[dict],
    classes: Sequence[str] = CLASS_NAMES,
    max_points: int = 300000,
    max_gts: int = 200,
    point_dim: int = 5,
) -> Dict[str, np.ndarray]:
    """Pad a list of pipeline outputs to fixed-shape device arrays."""
    B = len(samples)
    out = {
        "points": np.zeros((B, max_points, point_dim), np.float32),
        "points_mask": np.zeros((B, max_points), bool),
        "gt_boxes": np.zeros((B, max_gts, 9), np.float32),
        "gt_labels": np.zeros((B, max_gts), np.int32),
        "gt_valid": np.zeros((B, max_gts), bool),
        "bev_aug": np.stack([s["bev_aug"] for s in samples]),
    }
    cls_list = list(classes)
    for i, s in enumerate(samples):
        p = s["points"][:max_points]
        out["points"][i, : len(p)] = p[:, :point_dim]
        out["points_mask"][i, : len(p)] = True
        boxes = s.get("gt_boxes")
        if boxes is not None and len(boxes):
            names = s["gt_names"]
            keep = [j for j, n in enumerate(names) if n in cls_list]
            boxes = boxes[keep][:max_gts]
            labels = np.asarray(
                [cls_list.index(names[j]) for j in keep], np.int32
            )[:max_gts]
            out["gt_boxes"][i, : len(boxes)] = boxes
            out["gt_labels"][i, : len(boxes)] = labels
            out["gt_valid"][i, : len(boxes)] = True
    if "imgs" in samples[0]:
        imgs = np.stack([np.stack(s["imgs"]) for s in samples])
        out["imgs"] = imgs.astype(np.float32)
        out["lidar2img"] = np.stack([s["lidar2img"] for s in samples])
        out["img_aug"] = np.stack([s["img_aug"] for s in samples])
    out["tokens"] = [s.get("token", "") for s in samples]
    return out

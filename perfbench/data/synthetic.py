"""Synthetic LiDAR scenes and camera images, the benchmark's traffic.

Started as a frozen copy of the port's ``data/synthetic.py``
(``make_scene``, ``make_cameras``, ``render_images``, ``make_batch``), so
a change to the port's generator cannot change what the benchmark sends.
A scene is boxes with surface points over a background; what the
background looks like is a sensor rig (``scans/<name>.json``, named by a
configuration's ``"scan"``), data that this one generator reads:

- ``sensors``: spinning LiDARs, each with its mount height, beam
  elevations, range (metres, or ``"corner"``: the point-cloud range's
  corner), position on the vehicle and share of the background. Its
  returns fall on the ground, at the ring radii where its beams below
  ``GROUND_BEAM_DEG`` meet it (a beam that would meet it nearer than
  ``MIN_RING_M`` hits the vehicle and returns nothing), and on clutter:
  vertical surfaces at radii log-uniform from ``CLUTTER_MIN_M`` out to its
  range, so density falls with range;
- ``sweeps`` aggregated with up to ``ego_motion_m`` of ego motion between
  them (the first sweep at the origin);
- ``ground_z_m`` and ``clutter_z_m``: their z bands (``GROUND_SHARE`` of
  each sensor's returns fall on the ground, the rest on clutter);
- ``plane_z_m`` in place of sensors: a flat ground over the whole range;
- ``objects``: the boxes' bands (bottom, size, velocity), how far their
  centres keep from the range's border, and the point budget (``share`` of
  the scan, split ``equal`` or by ``inverse_square`` range);
- ``beyond_range``: ``clip`` the background onto the range's border, or
  ``keep`` it for the voxelizer to drop, as it drops a real scan's.

A z band's end is metres in the vehicle frame, or ``["floor", dz]`` /
``["top", dz]``: dz from the point-cloud range's bottom or top. The draws
are made in one fixed order, so a rig gives the same scan from the same
seed (``radial.json`` and ``uniform.json`` the scans of the generator they
replaced, bit for bit).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

GROUND_BEAM_DEG = -1.0  # beams below this elevation hit the ground
MIN_RING_M = 0.5  # a ground ring nearer than this lies under the vehicle
GROUND_SHARE = 0.75  # of each sensor's returns; the rest hit clutter
RING_JITTER = (0.98, 1.02)  # a ground return's radius over its ring's
CLUTTER_MIN_M = 3.0  # the nearest clutter
CLUTTER_SURFACES = 200  # clutter points cluster on this many surfaces
SURFACE_OFFSET_M = 1.5  # a surface's offset, each axis, at most
BUDGET_FLOOR_M = 5.0  # an inverse-square point budget's nearest range
MIN_BOX_POINTS = 8  # an inverse-square budget's least points a box


def _z(end, pc_range) -> float:
    """A z band's end (see the module)."""
    if isinstance(end, (int, float)):
        return end
    anchor, dz = end
    if anchor not in ("floor", "top"):
        raise ValueError(f"a z band's end is metres, ['floor', dz] or "
                         f"['top', dz]; got {end!r}")
    return (pc_range[2] if anchor == "floor" else pc_range[5]) + dz


def _band(band, pc_range):
    return _z(band[0], pc_range), _z(band[1], pc_range)


def _reach(sensor: dict, pc_range):
    """A sensor's range in metres: ``"corner"`` is the point-cloud range's
    corner."""
    r = sensor["range_m"]
    if r == "corner":
        return float(pc_range[3]) * np.sqrt(2.0)
    return np.float64(r)


def _counts(n: int, shares: Sequence[float]):
    """``n`` split by ``shares``; the last takes what is left."""
    counts = [int(n * s) for s in shares[:-1]]
    return counts + [n - sum(counts)]


def _sensor_background(rng, n_bg, pc_range, rig: dict):
    """Ground rings and clutter of each of the rig's sensors, (n_bg, 3)."""
    n_sweeps, motion = rig["sweeps"], rig["ego_motion_m"]
    ego = rng.uniform(-motion, motion, (n_sweeps, 2)).astype(np.float32)
    ego[0] = 0.0
    sensors = rig["sensors"]
    parts = []
    for s, n_s in zip(sensors, _counts(n_bg, [s["share"] for s in sensors])):
        px, py = s["position_m"]
        rmax = _reach(s, pc_range)
        elev = np.deg2rad(np.linspace(*s["elevation_deg"], s["beams"]))
        down = elev[elev < np.deg2rad(GROUND_BEAM_DEG)]
        ring_r = s["height_m"] / np.tan(-down)
        ring_r = np.minimum(ring_r[ring_r >= MIN_RING_M], rmax)

        n_ground = int(n_s * GROUND_SHARE)
        n_clutter = n_s - n_ground

        sweep = rng.randint(0, n_sweeps, n_ground)
        ring = ring_r[rng.randint(0, len(ring_r), n_ground)].astype(
            np.float32)
        ring *= rng.uniform(*RING_JITTER, n_ground).astype(np.float32)
        theta = rng.uniform(-np.pi, np.pi, n_ground).astype(np.float32)
        gx = ring * np.cos(theta) + ego[sweep, 0] + px
        gy = ring * np.sin(theta) + ego[sweep, 1] + py
        gz = rng.uniform(*_band(rig["ground_z_m"], pc_range),
                         n_ground).astype(np.float32)
        parts.append(np.stack([gx, gy, gz], -1))

        # vertical structure clustered into surfaces, so columns stack in z
        u = rng.uniform(0, 1, n_clutter).astype(np.float32)
        rc = CLUTTER_MIN_M * (rmax / CLUTTER_MIN_M) ** u
        tc = rng.uniform(-np.pi, np.pi, n_clutter).astype(np.float32)
        surf = rng.randint(0, CLUTTER_SURFACES, n_clutter)
        soff = rng.uniform(-SURFACE_OFFSET_M, SURFACE_OFFSET_M,
                           (CLUTTER_SURFACES, 2)).astype(np.float32)
        cx = rc * np.cos(tc) + soff[surf, 0] + px
        cy = rc * np.sin(tc) + soff[surf, 1] + py
        cz = rng.uniform(*_band(rig["clutter_z_m"], pc_range),
                         n_clutter).astype(np.float32)
        parts.append(np.stack([cx, cy, cz], -1))
    return np.concatenate(parts, 0).astype(np.float32)


def _plane_background(rng, n_bg, pc_range, rig: dict):
    """A flat ground over the whole range, (n_bg, 3)."""
    x0, y0, _, x1, y1, _ = pc_range
    return np.stack([
        rng.uniform(x0, x1, n_bg),
        rng.uniform(y0, y1, n_bg),
        rng.uniform(*_band(rig["plane_z_m"], pc_range), n_bg),
    ], -1).astype(np.float32)


def make_scene(rng: np.random.RandomState, n_points: int, n_boxes: int,
               num_classes: int, pc_range, point_dim: int, rig: dict):
    """Returns (points (N, D), gt_boxes (G, 9), gt_labels (G,)) of one scan
    of ``rig`` (see the module)."""
    x0, y0, z0, x1, y1, z1 = pc_range
    obj = rig["objects"]
    margin = obj["centre_margin"] * (x1 - x0)
    v = obj["velocity_m_s"]
    boxes = np.zeros((n_boxes, 9), np.float32)
    boxes[:, 0] = rng.uniform(x0 + margin, x1 - margin, n_boxes)
    boxes[:, 1] = rng.uniform(y0 + margin, y1 - margin, n_boxes)
    boxes[:, 2] = rng.uniform(*_band(obj["bottom_z_m"], pc_range), n_boxes)
    boxes[:, 3] = rng.uniform(*obj["length_m"], n_boxes)
    boxes[:, 4] = rng.uniform(*obj["width_m"], n_boxes)
    boxes[:, 5] = rng.uniform(*obj["height_m"], n_boxes)
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, n_boxes)
    boxes[:, 7:9] = rng.uniform(-v, v, (n_boxes, 2))
    labels = rng.randint(0, num_classes, n_boxes).astype(np.int32)

    n_obj = int(n_points * obj["share"])
    if obj["budget"] == "inverse_square":
        # per-box point budget ~1/r^2, as a real scanner sees
        rr = np.hypot(boxes[:, 0], boxes[:, 1])
        wts = 1.0 / np.maximum(rr, BUDGET_FLOOR_M) ** 2
        pers = np.maximum((n_obj * wts / wts.sum()).astype(int),
                          MIN_BOX_POINTS)
    elif obj["budget"] == "equal":
        pers = np.full(n_boxes, n_obj // n_boxes)
    else:
        raise ValueError(f"object budget {obj['budget']!r}: "
                         f"'inverse_square' or 'equal'")
    obj_pts = []
    for b in range(n_boxes):
        per = int(pers[b])
        local = rng.uniform(-0.5, 0.5, (per, 3)).astype(np.float32)
        local *= boxes[b, 3:6]
        c, s = np.cos(boxes[b, 6]), np.sin(boxes[b, 6])
        obj_pts.append(np.stack([
            c * local[:, 0] - s * local[:, 1] + boxes[b, 0],
            s * local[:, 0] + c * local[:, 1] + boxes[b, 1],
            local[:, 2] + boxes[b, 2] + boxes[b, 5] / 2,
        ], -1))
    obj_pts = np.concatenate(obj_pts, 0)

    n_bg = n_points - len(obj_pts)
    if "sensors" in rig:
        bg = _sensor_background(rng, n_bg, pc_range, rig)
    else:
        bg = _plane_background(rng, n_bg, pc_range, rig)
    if rig["beyond_range"] == "clip":
        np.clip(bg[:, 0], x0, x1 - 1e-3, out=bg[:, 0])
        np.clip(bg[:, 1], y0, y1 - 1e-3, out=bg[:, 1])
    elif rig["beyond_range"] != "keep":
        raise ValueError(f"beyond_range {rig['beyond_range']!r}: 'clip' or "
                         f"'keep'")

    xyz = np.concatenate([obj_pts, bg], 0)
    extra = rng.uniform(0, 1, (n_points, point_dim - 3)).astype(np.float32)
    pts = np.concatenate([xyz, extra], -1)
    rng.shuffle(pts)
    return pts, boxes, labels


def make_cameras(rng: np.random.RandomState, n_cams: int = 6,
                 img_hw=(448, 800)) -> np.ndarray:
    """Synthetic surround-view rig: a ring of cameras 1 m out from the
    sensor at 1.8 m height, yawed evenly (jittered by up to 0.05 rad), one
    pinhole intrinsic. Returns lidar2img (Ncam, 4, 4)."""
    H, W = img_hw
    fx = fy = 0.6 * W
    K = np.array([
        [fx, 0, W / 2, 0],
        [0, fy, H / 2, 0],
        [0, 0, 1, 0],
        [0, 0, 0, 1],
    ], np.float32)
    mats = []
    for i in range(n_cams):
        yaw = 2 * np.pi * i / n_cams + rng.uniform(-0.05, 0.05)
        c, s = np.cos(yaw), np.sin(yaw)
        # lidar -> camera; the camera frame is (right, down, forward)
        R_l2c = np.array([
            [-s, c, 0],
            [0, 0, -1],
            [c, s, 0],
        ], np.float32)
        t = -R_l2c @ np.array([1.0 * c, 1.0 * s, 1.8], np.float32)
        ext = np.eye(4, dtype=np.float32)
        ext[:3, :3] = R_l2c
        ext[:3, 3] = t
        mats.append(K @ ext)
    return np.stack(mats)


def render_images(points: np.ndarray, lidar2img: np.ndarray,
                  img_hw=(448, 800)) -> np.ndarray:
    """Splat the scene's points into each camera, intensity 1 / depth
    summed per pixel and clipped to [0, 1]: (Ncam, H, W, 3) float32."""
    H, W = img_hw
    n_cams = lidar2img.shape[0]
    imgs = np.zeros((n_cams, H, W, 3), np.float32)
    ph = np.concatenate(
        [points[:, :3], np.ones((len(points), 1), np.float32)], -1)
    for c in range(n_cams):
        proj = ph @ lidar2img[c].T
        z = proj[:, 2]
        keep = z > 0.5
        u = (proj[keep, 0] / z[keep]).astype(np.int32)
        v = (proj[keep, 1] / z[keep]).astype(np.int32)
        inb = (u >= 0) & (u < W) & (v >= 0) & (v < H)
        u, v = u[inb], v[inb]
        w = 1.0 / np.clip(z[keep][inb], 1.0, None)
        for ch in range(3):
            np.add.at(imgs[c, :, :, ch], (v, u), w)
    return np.clip(imgs, 0, 1)


def make_batch(rng: np.random.RandomState, rig: dict, batch_size: int = 2,
               n_points: int = 30000, n_boxes: int = 12, max_gts: int = 32,
               num_classes: int = 10,
               pc_range=(-54.0, -54.0, -5.0, 54.0, 54.0, 3.0),
               point_dim: int = 5, with_images: bool = False,
               n_cams: int = 6, img_hw=(448, 800)):
    """Batch of scenes of ``rig`` (see the module): points (B, N, D),
    points_mask (B, N), and padded ground truth gt_boxes (B, G, 9),
    gt_labels, gt_valid; ``with_images`` adds each scene's camera rig and
    rendered images: imgs (B, Ncam, H, W, 3), lidar2img (B, Ncam, 4, 4) and
    identity img_aug (B, Ncam, 4, 4) and bev_aug (B, 4, 4)."""
    pts, masks, gts, gls, gvs = [], [], [], [], []
    imgs, l2is = [], []
    for _ in range(batch_size):
        p, b, l = make_scene(rng, n_points, n_boxes, num_classes, pc_range,
                             point_dim, rig)
        pts.append(p)
        masks.append(np.ones(n_points, bool))
        gb = np.zeros((max_gts, 9), np.float32)
        gb[:len(b)] = b
        gl = np.zeros((max_gts,), np.int32)
        gl[:len(l)] = l
        gv = np.zeros((max_gts,), bool)
        gv[:len(b)] = True
        gts.append(gb)
        gls.append(gl)
        gvs.append(gv)
        if with_images:
            l2i = make_cameras(rng, n_cams, img_hw)
            imgs.append(render_images(p, l2i, img_hw))
            l2is.append(l2i)
    out = {
        "points": np.stack(pts),
        "points_mask": np.stack(masks),
        "gt_boxes": np.stack(gts),
        "gt_labels": np.stack(gls),
        "gt_valid": np.stack(gvs),
    }
    if with_images:
        out["imgs"] = np.stack(imgs)
        out["lidar2img"] = np.stack(l2is)
        out["img_aug"] = np.array(np.broadcast_to(
            np.eye(4, dtype=np.float32), (batch_size, n_cams, 4, 4)))
        out["bev_aug"] = np.array(np.broadcast_to(
            np.eye(4, dtype=np.float32), (batch_size, 4, 4)))
    return out

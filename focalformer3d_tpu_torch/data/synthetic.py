"""Synthetic LiDAR scenes: ground clutter plus boxes with surface points.

Port of ``focalformer3d_tpu/data/synthetic.py`` (``make_scene``,
``make_cameras``, ``render_images``, ``make_batch``). It is numpy code
kept in the port so that the port runs where the JAX package is absent; it
draws the same numbers from the same ``numpy.random.RandomState`` calls,
so both packages give equal arrays for one seed
(``tests/test_torch_voxelize.py``; the camera batch in
``tests/test_torch_camera_model.py``).
"""
from __future__ import annotations

import numpy as np


def _radial_background(rng, n_bg, pc_range, n_sweeps: int = 10):
    """Spinning-LiDAR ground/clutter returns (n_bg, 3) xyz.

    nuScenes capture geometry (HDL-32E, 32 beams from -30.7 to +10.7 deg,
    sensor at ~1.84 m, 10 aggregated sweeps with ego motion): downward beams
    hit the ground at discrete ring radii, and a clutter fraction hits
    vertical surfaces at range-weighted radii, so point density falls ~1/r.
    """
    x0, y0, z0, x1, y1, z1 = pc_range
    h = 1.84
    rmax = float(x1) * np.sqrt(2.0)
    elev = np.deg2rad(np.linspace(-30.67, 10.67, 32))
    down = elev[elev < np.deg2rad(-1.0)]
    ring_r = np.clip(h / np.tan(-down), 0.5, rmax)

    n_ground = int(n_bg * 0.75)
    n_clutter = n_bg - n_ground

    ego = rng.uniform(-2.0, 2.0, (n_sweeps, 2)).astype(np.float32)
    ego[0] = 0.0
    sweep = rng.randint(0, n_sweeps, n_ground)
    ring = ring_r[rng.randint(0, len(ring_r), n_ground)].astype(np.float32)
    ring *= rng.uniform(0.98, 1.02, n_ground).astype(np.float32)
    theta = rng.uniform(-np.pi, np.pi, n_ground).astype(np.float32)
    gx = ring * np.cos(theta) + ego[sweep, 0]
    gy = ring * np.sin(theta) + ego[sweep, 1]
    gz = rng.uniform(-2.1, -1.9, n_ground).astype(np.float32)
    ground = np.stack([gx, gy, gz], -1)

    # vertical structure clustered into ~200 surfaces, so columns stack in z
    u = rng.uniform(0, 1, n_clutter).astype(np.float32)
    rc = 3.0 * (rmax / 3.0) ** u
    tc = rng.uniform(-np.pi, np.pi, n_clutter).astype(np.float32)
    surf = rng.randint(0, 200, n_clutter)
    soff = rng.uniform(-1.5, 1.5, (200, 2)).astype(np.float32)
    cx = rc * np.cos(tc) + soff[surf, 0]
    cy = rc * np.sin(tc) + soff[surf, 1]
    cz = rng.uniform(z0 + 2.8, z1, n_clutter).astype(np.float32)
    clutter = np.stack([cx, cy, cz], -1)

    bg = np.concatenate([ground, clutter], 0).astype(np.float32)
    np.clip(bg[:, 0], x0, x1 - 1e-3, out=bg[:, 0])
    np.clip(bg[:, 1], y0, y1 - 1e-3, out=bg[:, 1])
    return bg


def make_scene(rng: np.random.RandomState, n_points: int = 30000,
               n_boxes: int = 12, num_classes: int = 10,
               pc_range=(-54.0, -54.0, -5.0, 54.0, 54.0, 3.0),
               point_dim: int = 5, mode: str = "uniform"):
    """Returns (points (N, D), gt_boxes (G, 9), gt_labels (G,)).

    mode='uniform': ground-plane clutter over the full range. mode='radial':
    LiDAR beam-model background with ring structure and 1/r density, the
    scan ``bench.py`` times.
    """
    x0, y0, z0, x1, y1, z1 = pc_range
    margin = 0.1 * (x1 - x0)
    boxes = np.zeros((n_boxes, 9), np.float32)
    boxes[:, 0] = rng.uniform(x0 + margin, x1 - margin, n_boxes)
    boxes[:, 1] = rng.uniform(y0 + margin, y1 - margin, n_boxes)
    boxes[:, 2] = rng.uniform(-2.0, -1.0, n_boxes)
    boxes[:, 3] = rng.uniform(1.5, 5.0, n_boxes)
    boxes[:, 4] = rng.uniform(1.0, 2.5, n_boxes)
    boxes[:, 5] = rng.uniform(1.0, 2.5, n_boxes)
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, n_boxes)
    boxes[:, 7:9] = rng.uniform(-2, 2, (n_boxes, 2))
    labels = rng.randint(0, num_classes, n_boxes).astype(np.int32)

    n_obj = n_points // 2 if mode == "uniform" else n_points // 5
    if mode == "radial":
        # per-box point budget ~1/r^2, as a real scanner sees
        rr = np.hypot(boxes[:, 0], boxes[:, 1])
        wts = 1.0 / np.maximum(rr, 5.0) ** 2
        pers = np.maximum((n_obj * wts / wts.sum()).astype(int), 8)
    else:
        pers = np.full(n_boxes, n_obj // n_boxes)
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
    if mode == "radial":
        bg = _radial_background(rng, n_bg, pc_range)
    else:
        bg = np.stack([
            rng.uniform(x0, x1, n_bg),
            rng.uniform(y0, y1, n_bg),
            rng.uniform(-2.2, -1.8, n_bg),
        ], -1).astype(np.float32)

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


def make_batch(rng: np.random.RandomState, batch_size: int = 2,
               n_points: int = 30000, n_boxes: int = 12, max_gts: int = 32,
               num_classes: int = 10,
               pc_range=(-54.0, -54.0, -5.0, 54.0, 54.0, 3.0),
               point_dim: int = 5, with_images: bool = False,
               n_cams: int = 6, img_hw=(448, 800), mode: str = "uniform"):
    """Batch of scenes: points (B, N, D), points_mask (B, N), and padded
    ground truth gt_boxes (B, G, 9), gt_labels, gt_valid; ``with_images``
    adds each scene's camera rig and rendered images: imgs (B, Ncam, H, W,
    3), lidar2img (B, Ncam, 4, 4) and identity img_aug (B, Ncam, 4, 4) and
    bev_aug (B, 4, 4)."""
    pts, masks, gts, gls, gvs = [], [], [], [], []
    imgs, l2is = [], []
    for _ in range(batch_size):
        p, b, l = make_scene(rng, n_points, n_boxes, num_classes, pc_range,
                             point_dim, mode)
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

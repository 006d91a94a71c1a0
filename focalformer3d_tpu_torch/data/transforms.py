"""Host-side (NumPy) pipeline transforms: LiDAR and multi-view images.

The port's copy of ``focalformer3d_tpu/data/transforms.py``: the mmdet3d
pipeline stages that the reference's configs compose
(FocalFormer3D_L.py:64-99, FocalFormer3D_LC.py:30-100). They draw
the same numbers from the same ``numpy.random.RandomState`` calls as the
originals, so both packages give equal arrays for one seed
(``tests/test_torch_data.py``). The multi-view image transforms
(``ImageAug3D``, ``NormalizeMultiviewImage``, ``PadMultiViewImage``,
``ScaleImageMultiViewImage``, transform_3d.py of the reference) resample
with ``data/image_io`` where the JAX copies call Pillow, bit for bit, and
transform a sample's cameras side by side on threads
(``tests/test_torch_camera_data.py``).

Every geometric augmentation records itself into ``bev_aug`` (4x4, lidar
frame) instead of scattering flags and angles through meta dicts; the model
reads only that matrix.

A *sample* is a plain dict with (a subset of) points (N, 5) float32,
gt_boxes (G, 9), gt_names (G,) object array, bev_aug (4, 4), and for the
camera configs imgs (a list of (H, W, 3) BGR float32 arrays), lidar2img
and img_aug (Ncam, 4, 4).
"""
from __future__ import annotations

import numpy as np

from . import image_io


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


# ---------------------------------------------------------------------------
# multi-view image transforms
# ---------------------------------------------------------------------------

class ImageAug3D:
    """BEVFusion-style per-camera resize/crop/flip/rotate, recording the
    pixel-space affine into img_aug (transform_3d.py:20-123).

    final_dim is (H, W). resize factors are relative to the original image.
    """

    def __init__(self, final_dim=(448, 800), resize_lim=(0.4, 0.6),
                 bot_pct_lim=(0.0, 0.0), rot_lim=(-5.4, 5.4), rand_flip=True,
                 is_train=True):
        self.final_dim = final_dim
        self.resize_lim = resize_lim
        self.bot_pct_lim = bot_pct_lim
        self.rot_lim = rot_lim
        self.rand_flip = rand_flip
        self.is_train = is_train

    def _sample_params(self, H, W, rng):
        fH, fW = self.final_dim
        if self.is_train:
            resize = rng.uniform(*self.resize_lim)
            resized = (int(W * resize), int(H * resize))
            newW, newH = resized
            crop_h = (
                int((1 - rng.uniform(*self.bot_pct_lim)) * newH) - fH
            )
            crop_w = int(rng.uniform(0, max(0, newW - fW)))
            crop = (crop_w, crop_h, crop_w + fW, crop_h + fH)
            flip = self.rand_flip and rng.rand() < 0.5
            rotate = rng.uniform(*self.rot_lim)
        else:
            resize = np.mean(self.resize_lim)
            resized = (int(W * resize), int(H * resize))
            newW, newH = resized
            crop_h = int((1 - np.mean(self.bot_pct_lim)) * newH) - fH
            crop_w = int(max(0, newW - fW) / 2)
            crop = (crop_w, crop_h, crop_w + fW, crop_h + fH)
            flip = False
            rotate = 0.0
        return resize, resized, crop, flip, rotate

    def _transform_img(self, img, resize_wh, crop, flip, rotate):
        # the JAX copy: Image.fromarray(img.astype(np.uint8)), then
        # resize, crop, FLIP_LEFT_RIGHT, rotate
        out = image_io.resize(img.astype(np.uint8), resize_wh)
        out = image_io.crop(out, crop)
        if flip:
            out = image_io.flip_lr(out)
        out = image_io.rotate(out, rotate)
        return out.astype(np.float32)

    @staticmethod
    def _aug_matrix(resize, crop, flip, rotate, final_dim):
        """Pixel map: p_final = A @ p_orig (homogeneous (u, v, 1))."""
        fH, fW = final_dim
        A = np.eye(3, dtype=np.float32)
        A[:2] *= resize
        A[0, 2] -= crop[0]
        A[1, 2] -= crop[1]
        if flip:
            F = np.array([[-1, 0, fW], [0, 1, 0], [0, 0, 1]], np.float32)
            A = F @ A
        th = -rotate / 180.0 * np.pi  # PIL rotates CCW in image coords
        c, s = np.cos(th), np.sin(th)
        # rotate about the image center
        cx, cy = fW / 2.0, fH / 2.0
        R = np.array(
            [[c, -s, cx - c * cx + s * cy], [s, c, cy - s * cx - c * cy],
             [0, 0, 1]], np.float32
        )
        A = R @ A
        M = np.eye(4, dtype=np.float32)
        M[:2, :2] = A[:2, :2]
        M[:2, 3] = A[:2, 2]
        return M

    def __call__(self, sample: dict, rng: np.random.RandomState) -> dict:
        # the cameras' draws in the JAX copy's order, then their
        # resampling side by side (it draws nothing)
        params = [self._sample_params(*img.shape[:2], rng)
                  for img in sample["imgs"]]
        sample["imgs"] = image_io.parallel_map(
            lambda a: self._transform_img(a[0], *a[1][1:]),
            zip(sample["imgs"], params))
        sample["img_aug"] = np.stack([
            self._aug_matrix(p[0], *p[2:], self.final_dim) for p in params])
        sample["input_shape"] = self.final_dim
        return sample


class NormalizeMultiviewImage:
    def __init__(self, mean, std, to_rgb=False):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.to_rgb = to_rgb

    def _normalize(self, img):
        img = img.astype(np.float32)
        if self.to_rgb:
            img = img[..., ::-1]
        return (img - self.mean) / self.std

    def __call__(self, sample: dict, rng=None) -> dict:
        sample["imgs"] = image_io.parallel_map(self._normalize,
                                               sample["imgs"])
        return sample


class PadMultiViewImage:
    def __init__(self, size_divisor=32):
        self.div = size_divisor

    def __call__(self, sample: dict, rng=None) -> dict:
        out = []
        for img in sample["imgs"]:
            H, W = img.shape[:2]
            ph = (self.div - H % self.div) % self.div
            pw = (self.div - W % self.div) % self.div
            if ph or pw:
                img = np.pad(img, ((0, ph), (0, pw), (0, 0)))
            out.append(img)
        sample["imgs"] = out
        H, W = out[0].shape[:2]
        sample["input_shape"] = (H, W)
        return sample


class ScaleImageMultiViewImage:
    """Test-time rescale to `scales` (W, H) patching lidar2img
    (transform_3d.py:213-249)."""

    def __init__(self, scales=(800, 448)):
        self.scales = scales

    def __call__(self, sample: dict, rng=None) -> dict:
        W, H = self.scales
        mats = []
        for img in sample["imgs"]:
            h0, w0 = img.shape[:2]
            M = np.eye(4, dtype=np.float32)
            M[0, 0] = W / w0
            M[1, 1] = H / h0
            mats.append(M)
        # the JAX copy: Image.fromarray(img.astype(np.uint8)).resize((W, H))
        sample["imgs"] = image_io.parallel_map(
            lambda img: image_io.resize(img.astype(np.uint8),
                                        (W, H)).astype(np.float32),
            sample["imgs"])
        sample["img_aug"] = np.stack(mats)
        sample["input_shape"] = (H, W)
        return sample


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, sample: dict, rng: np.random.RandomState) -> dict:
        for t in self.transforms:
            sample = t(sample, rng)
        return sample

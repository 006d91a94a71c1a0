"""Lift-Splat-Shoot camera -> BEV lifting, NHWC.

Port of ``focalformer3d_tpu/models/lss.py`` (``create_frustum``,
``frustum_geometry``, ``CamEncode``, ``splat_to_bev``, ``BevEncode``,
``LiftSplatShoot``; ``LSSConfig`` lives in ``configs.py`` and is
re-exported here). A 1x1 conv predicts per pixel a depth distribution
over D bins and a feature vector; their outer product lifts each pixel to
D frustum points, which are carried image -> camera -> lidar (undoing the
recorded image augmentation and replaying the point-cloud one) and
sum-pooled into a (Z, X, Y) voxel grid with ``index_add_``; an
out-of-range point goes to an overflow cell that is cut off. Z is stacked
into channels channel-major (c * Z + z, the reference's layout) and four
3x3 conv + BN + ReLU layers encode the BEV map.

Submodules carry the reference checkpoint's names (``frustum``,
``camencode.depthnet``, ``bevencode.{3k}`` conv / ``{3k+1}`` BN). The
``frustum`` buffer is kept for the key inventory only: the geometry comes
from the config, so a state dict whose frustum holds other values (zeros
from ``utils/convert.from_jax_variables``) computes the same.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..configs import LSSConfig
from ..ops.scatter import bev_pool
from ..utils.profiler import span
from .layers import apply_bn, conv2d_nhwc

__all__ = ["LSSConfig", "create_frustum", "frustum_geometry", "CamEncode",
           "splat_to_bev", "BevEncode", "LiftSplatShoot"]


def create_frustum(cfg: LSSConfig) -> np.ndarray:
    """(D, fH, fW, 3) of (x_px, y_px, depth) in network-input pixels."""
    ogH, ogW = cfg.img_scale
    fH, fW = cfg.feat_hw
    lo, hi, step = cfg.camera_depth_range
    ds = np.arange(lo, hi, step, dtype=np.float32)
    xs = np.linspace(0, ogW - 1, fW, dtype=np.float32)
    ys = np.linspace(0, ogH - 1, fH, dtype=np.float32)
    d, y, x = np.meshgrid(ds, ys, xs, indexing="ij")
    return np.stack([x, y, d], axis=-1)


def frustum_geometry(cfg: LSSConfig, cam2lidar_rot: torch.Tensor,
                     cam2lidar_trans: torch.Tensor,
                     img_aug: Optional[torch.Tensor] = None,
                     bev_aug: Optional[torch.Tensor] = None,
                     frustum: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Frustum points in (augmented) lidar coords, (N, D, fH, fW, 3).

    cam2lidar_rot (N, 3, 3) and cam2lidar_trans (N, 3) from the inverse of
    lidar2img; img_aug (N, 4, 4) the pixel-space augmentation to undo,
    bev_aug (4, 4) the point-cloud one to replay; ``frustum`` is
    ``create_frustum(cfg)`` on the device, if the caller keeps it."""
    if frustum is None:
        frustum = torch.from_numpy(create_frustum(cfg)).to(
            cam2lidar_rot.device)
    N = cam2lidar_rot.shape[0]
    pts = frustum.expand((N,) + tuple(frustum.shape))
    if img_aug is not None:
        post_rot = img_aug[:, :3, :3]
        post_tran = img_aug[:, :3, 3]
        pts = pts - post_tran[:, None, None, None, :]
        pts = torch.einsum("nij,ndhwj->ndhwi", torch.linalg.inv(post_rot),
                           pts)
    # pixel * depth un-projection: (x * d, y * d, d)
    pts = torch.cat([pts[..., :2] * pts[..., 2:3], pts[..., 2:3]], -1)
    pts = torch.einsum("nij,ndhwj->ndhwi", cam2lidar_rot, pts)
    pts = pts + cam2lidar_trans[:, None, None, None, :]
    if bev_aug is not None:
        pts = torch.einsum("ij,ndhwj->ndhwi", bev_aug[:3, :3], pts)
        pts = pts + bev_aug[:3, 3]
    return pts


class CamEncode(nn.Module):
    """1x1 conv -> (depth softmax) x (features) outer product."""

    def __init__(self, cin: int, depth_bins: int, cam_channels: int):
        super().__init__()
        self.depth_bins = depth_bins
        self.depthnet = nn.Conv2d(cin, depth_bins + cam_channels, 1)

    def forward(self, x: torch.Tensor):
        """x (B, H, W, Cin) -> lifted (B, D, H, W, C), depth (B, D, H, W)."""
        y = conv2d_nhwc(x, self.depthnet.weight, self.depthnet.bias)
        depth = torch.softmax(y[..., :self.depth_bins], dim=-1)
        feat = y[..., self.depth_bins:]
        lifted = depth.permute(0, 3, 1, 2)[..., None] * feat[:, None]
        return lifted, depth.permute(0, 3, 1, 2)


def splat_ranks(cfg: LSSConfig, geom: torch.Tensor) -> torch.Tensor:
    """Flat voxel rank ((iz * X + ix) * Y + iy) of each frustum point, the
    overflow cell Z * X * Y where a point falls outside the grid."""
    nx, ny, nz = cfg.nx
    pc_min = geom.new_tensor(cfg.pc_range[:3])
    idx = torch.floor((geom - pc_min) / cfg.grid).to(torch.int32)
    ix, iy, iz = idx[..., 0], idx[..., 1], idx[..., 2]
    valid = ((ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny) & (iz >= 0)
             & (iz < nz))
    rank = (iz * nx + ix) * ny + iy
    return torch.where(valid, rank, nz * nx * ny)


def splat_to_bev(cfg: LSSConfig, geom: torch.Tensor,
                 feats: torch.Tensor) -> torch.Tensor:
    """Sum-pool one sample's frustum features into the voxel grid.

    geom (N, D, fH, fW, 3) lidar-frame xyz, feats (N, D, fH, fW, C).
    Returns (Y, X, C * Z), Z stacked channel-major (c * Z + z)."""
    nx, ny, nz = cfg.nx
    C = feats.shape[-1]
    pooled = bev_pool(feats.reshape(-1, C), splat_ranks(cfg, geom),
                      nz * nx * ny)
    pooled = pooled.reshape(nz, nx, ny, C).permute(2, 1, 3, 0)  # Y X C Z
    return pooled.reshape(ny, nx, C * nz)


class BevEncode(nn.Sequential):
    """conv3x3 (no bias) + BN + ReLU x 4: C*Z -> C*Z -> 512 -> 512 -> out
    (as an ``nn.Sequential``: the reference's keys ``{3k}``, ``{3k+1}``)."""

    def __init__(self, cin: int, out_channels: int):
        widths = (cin, cin, 512, 512, out_channels)
        layers = []
        for a, b in zip(widths[:-1], widths[1:]):
            layers += [nn.Conv2d(a, b, 3, padding=1, bias=False),
                       nn.BatchNorm2d(b), nn.ReLU()]
        super().__init__(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, Y, X, C) -> (B, Y, X, out_channels)."""
        for k in range(0, len(self), 3):
            x = conv2d_nhwc(x, self[k].weight, None, 1, 1)
            x = F.relu(apply_bn(x, self[k + 1]))
        return x


class LiftSplatShoot(nn.Module):
    def __init__(self, cfg: LSSConfig):
        super().__init__()
        self.cfg = cfg
        self.register_buffer("frustum", torch.zeros(
            (cfg.depth_bins,) + cfg.feat_hw + (3,)))
        self.camencode = CamEncode(cfg.input_channels, cfg.depth_bins,
                                   cfg.cam_channels)
        self.bevencode = BevEncode(cfg.cam_channels * cfg.nx[2],
                                   cfg.out_channels)
        self._frustum: Dict[torch.device, torch.Tensor] = {}

    def geometry(self, cam2lidar_rot, cam2lidar_trans, img_aug=None,
                 bev_aug=None) -> torch.Tensor:
        """``frustum_geometry`` of each sample: (B, Ncam, D, fH, fW, 3)."""
        dev = cam2lidar_rot.device
        if dev not in self._frustum:
            self._frustum[dev] = torch.from_numpy(
                create_frustum(self.cfg)).to(dev)
        return torch.stack([
            frustum_geometry(
                self.cfg, cam2lidar_rot[b], cam2lidar_trans[b],
                None if img_aug is None else img_aug[b],
                None if bev_aug is None else bev_aug[b], self._frustum[dev])
            for b in range(cam2lidar_rot.shape[0])])

    def forward(self, img_feats: torch.Tensor, cam2lidar_rot: torch.Tensor,
                cam2lidar_trans: torch.Tensor,
                img_aug: Optional[torch.Tensor] = None,
                bev_aug: Optional[torch.Tensor] = None,
                mark: Optional[Callable[[str], None]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """img_feats (B, Ncam, fH, fW, Cin) FPN level 0 -> (bev (B, Y, X,
        out_channels), depth (B, Ncam, D, fH, fW)). ``mark(stage)``, if
        given, is called as "LSS lift", "LSS splat" and "BevEncode" end.
        The lift and splat run in float32 whatever the input's dtype; each
        of the three runs in a ``utils/profiler`` span of its name."""
        B, N = img_feats.shape[:2]
        with span("LSS lift", mark):
            lifted, depth = self.camencode(img_feats.float().flatten(0, 1))
            lifted = lifted.unflatten(0, (B, N))
            geom = self.geometry(cam2lidar_rot.float(),
                                 cam2lidar_trans.float(), img_aug, bev_aug)
        with span("LSS splat", mark):
            bev = torch.stack([splat_to_bev(self.cfg, geom[b], lifted[b])
                               for b in range(B)])
        with span("BevEncode", mark):
            bev = self.bevencode(bev)
        return bev, depth.unflatten(0, (B, N))

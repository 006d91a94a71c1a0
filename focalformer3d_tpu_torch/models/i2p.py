"""I2P: image-to-point (BEV) projection fusion, NHWC.

Port of ``focalformer3d_tpu/models/i2p.py`` (``project_points_to_cams``,
``I2P``): a Z x H x W grid of cell centres over the point-cloud range is
projected into every camera (``lidar2img``), the image features are
sampled bilinearly there, the samples are averaged over the cameras that
see the point, and a one-head attention per BEV cell (the LiDAR feature
the query, its Z vertical samples the keys and values) decorates the
LiDAR BEV map with camera evidence.

The sampling is ``F.grid_sample(align_corners=False, padding_mode=
"zeros")``, the function the JAX module's ``grid_sample_norm`` computes
(``ops/bilinear.py`` here) with four gathers and their weights: one kernel
a camera instead of about fifty elementwise passes over (P, C) tensors
(3.2 against 20.6 ms for six cameras at full width on an NVIDIA H100 80GB
HBM3, on a radial 200k-point scan and its six 448 x 800 cameras). Memory:
at full width a sample has Z x H x W = 10 x 180 x 180 = 324 000 grid
points and six cameras; the cameras are sampled one after the other into
one running sum, so a sample holds a few (324 000, C) float32 tensors at a
time, not (6, 324 000, C).

The module computes in float32 whatever the LiDAR map's dtype (the JAX
module's ``nn.Dense`` layers take no dtype, so flax promotes to their
float32 parameters) and returns float32.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import dropout


def project_points_to_cams(pts: torch.Tensor, lidar2img: torch.Tensor,
                           img_aug: Optional[torch.Tensor],
                           bev_aug: Optional[torch.Tensor],
                           input_shape: Tuple[int, int], eps: float = 1e-5):
    """pts (P, 3) xyz in the augmented LiDAR frame; lidar2img (Ncam, 4, 4);
    img_aug (Ncam, 4, 4) or None; bev_aug (4, 4) or None; input_shape the
    network input (H, W). Returns xy (Ncam, P, 2) float32 normalised to
    [-1, 1] and valid (Ncam, P): in front of the camera (z > eps) and
    strictly inside the image.

    The inverse of ``bev_aug`` and the products after it run in float64
    (JAX: float32) and xy is rounded to float32 once: a point a metre in
    front of a camera moves on the image ~100 times as far as it moves in
    space, so float32 roundings that differ between devices (see
    ``bev_grid``) moved the sampled features by up to 3.8e-4 of their
    scale between an NVIDIA H100 80GB HBM3 and the CPU; in float64 both
    give the same float32 xy. The inverse is ``inv_ex``'s: ``inv``
    computes the same matrix but reads its error code back to the host, a
    sync in the middle of a forward on a card."""
    pts = pts.double()
    if bev_aug is not None:  # grid points back to the sensor frame
        inv = torch.linalg.inv_ex(bev_aug.double()).inverse
        pts = pts @ inv[:3, :3].T + inv[:3, 3]
    ph = torch.cat([pts, torch.ones_like(pts[..., :1])], -1)  # (P, 4)
    cam = torch.einsum("nij,pj->npi", lidar2img.double(), ph)  # (N, P, 4)
    z = cam[..., 2]
    in_front = z > eps
    xy = cam[..., :2] / torch.clamp(z, min=eps)[..., None]
    if img_aug is not None:
        ia = img_aug.double()
        xy1 = torch.cat([xy, torch.ones_like(xy[..., :1])], -1)
        xy = (torch.einsum("nij,npj->npi", ia[:, :3, :3], xy1)
              + ia[:, None, :3, 3])[..., :2]
    H, W = input_shape
    xn = xy[..., 0] / W * 2.0 - 1.0
    yn = xy[..., 1] / H * 2.0 - 1.0
    valid = in_front & (xn > -1.0) & (xn < 1.0) & (yn > -1.0) & (yn < 1.0)
    return torch.stack([xn, yn], -1).float(), valid


def bev_grid(shape: Tuple[int, int, int], pc_range: Tuple[float, ...],
             device=None) -> torch.Tensor:
    """(Z * H * W, 3) float64 xyz of the cell centres of a (Z, H, W) grid
    over ``pc_range``, z-major; x runs along W and y along H. Float64,
    where JAX builds it in float32: on a card PyTorch divides by a Python
    number as a product with its reciprocal, so a float32 grid there lies
    an ulp from the CPU's, which ``project_points_to_cams`` magnifies."""
    Z, H, W = shape
    zi, yi, xi = torch.meshgrid(
        *(torch.arange(n, dtype=torch.float64, device=device)
          for n in (Z, H, W)), indexing="ij")
    r = pc_range
    return torch.stack([(xi + 0.5) / W * (r[3] - r[0]) + r[0],
                        (yi + 0.5) / H * (r[4] - r[1]) + r[1],
                        (zi + 0.5) / Z * (r[5] - r[2]) + r[2]],
                       -1).reshape(-1, 3)


def sample_cameras(img_feats: torch.Tensor, xy: torch.Tensor,
                   valid: torch.Tensor):
    """The masked mean over cameras of the features sampled at ``xy``:
    img_feats (Ncam, fH, fW, C), xy (Ncam, P, 2) normalised (x, y),
    valid (Ncam, P) -> ((P, C) mean over the cameras that see each point,
    (P,) seen by any). One camera at a time into a running sum."""
    total = count = None
    for n in range(img_feats.shape[0]):
        m = valid[n].to(img_feats.dtype)[:, None]
        s = F.grid_sample(img_feats[n].permute(2, 0, 1)[None],
                          xy[n][None, None], mode="bilinear",
                          padding_mode="zeros", align_corners=False)
        s = s[0, :, 0].T * m
        total = s if total is None else total + s
        count = m if count is None else count + m
    return total / (count + 1e-10), valid.any(0)


class LearnedAlign(nn.Module):
    """The reference's one-head ``nn.MultiheadAttention`` with separate
    key and value widths: ``{q,k,v}_proj_weight`` (O, I), one fused
    ``in_proj_bias`` (3C) and ``out_proj``, under its state-dict names."""

    def __init__(self, c: int):
        super().__init__()
        self.q_proj_weight = nn.Parameter(torch.zeros(c, c))
        self.k_proj_weight = nn.Parameter(torch.zeros(c, c))
        self.v_proj_weight = nn.Parameter(torch.zeros(c, c))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * c))
        self.out_proj = nn.Linear(c, c)

    def forward(self, query: torch.Tensor, kv: torch.Tensor,
                kv_mask: torch.Tensor) -> torch.Tensor:
        """query (Q, C), kv (Q, Z, C), kv_mask (Q, Z) -> (Q, C): each
        query attends over its Z samples; logits are -1e9 where no camera
        sees the sample, and a query that sees none gets 0."""
        c = query.shape[-1]
        bq, bk, bv = self.in_proj_bias.split(c)
        q = F.linear(query, self.q_proj_weight, bq)
        k = F.linear(kv, self.k_proj_weight, bk)
        v = F.linear(kv, self.v_proj_weight, bv)
        logits = torch.einsum("qc,qzc->qz", q, k) / math.sqrt(c)
        logits = torch.where(kv_mask, logits, -1e9)
        attn = torch.softmax(logits, dim=-1)
        out = self.out_proj(torch.einsum("qz,qzc->qc", attn, v))
        return torch.where(kv_mask.any(-1, keepdim=True), out, 0.0)


class I2P(nn.Module):
    """Decorate a LiDAR BEV map with projected camera features."""

    def __init__(self, pts_channels: int = 128, max_points_height: int = 10,
                 pc_range: Tuple[float, ...] = (-54.0, -54.0, -5.0, 54.0,
                                                54.0, 3.0),
                 input_shape: Tuple[int, int] = (448, 800),
                 dropout: float = 0.1):
        super().__init__()
        self.max_points_height = max_points_height
        self.pc_range = tuple(pc_range)
        self.input_shape = tuple(input_shape)
        self.dropout = dropout
        self.learnedAlign = LearnedAlign(pts_channels)

    def forward(self, lidar_feat: torch.Tensor, img_feats: torch.Tensor,
                lidar2img: torch.Tensor,
                img_aug: Optional[torch.Tensor] = None,
                bev_aug: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """lidar_feat (B, H, W, C); img_feats (B, Ncam, fH, fW, Cimg);
        lidar2img (B, Ncam, 4, 4); img_aug (B, Ncam, 4, 4) and bev_aug (B,
        4, 4) or None (identity). Returns float32 (B, H, W, C); in
        training, dropout drawn from ``generator``."""
        B, H, W, C = lidar_feat.shape
        Z = self.max_points_height
        grid = bev_grid((Z, H, W), self.pc_range, lidar_feat.device)
        outs = []
        for b in range(B):
            xy, valid = project_points_to_cams(
                grid, lidar2img[b], None if img_aug is None else img_aug[b],
                None if bev_aug is None else bev_aug[b], self.input_shape)
            reduced, seen = sample_cameras(img_feats[b].float(), xy, valid)
            kv = reduced.reshape(Z, H * W, -1).transpose(0, 1)  # (HW, Z, Ci)
            kv_mask = seen.reshape(Z, H * W).T
            outs.append(self.learnedAlign(
                lidar_feat[b].float().reshape(H * W, C), kv, kv_mask)
                .reshape(H, W, C))
        out = torch.stack(outs)
        if self.training:
            out = dropout(out, self.dropout, generator)
        return out

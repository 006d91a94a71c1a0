"""Voxel feature encoders over the (V, P, D) point slots of
``ops.voxelize.hard_voxelize``: the mean (``hard_simple_vfe``) and the
PointNet of the Waymo configs (``HardVFE``).

Port of ``focalformer3d_tpu/models/vfe.py``. ``HardVFE`` is mmdet3d's
HardVFE as the reference Waymo config builds it (in_channels 5,
feat_channels [64], no cluster or voxel-centre offsets): per layer a Linear
without bias, batch norm and ReLU over every point slot, then a max over
the slots. Its modules carry the reference checkpoint's names
(``vfe_layers.{i}.linear`` / ``.norm``). ``with_cluster_center`` and
``with_voxel_center`` append each point's offset from its voxel's point
mean and from its voxel's centre (3 channels each, as mmdet3d's HardVFE);
no config sets them and the detector's config has no field for them (as
in JAX), so the detector builds the module without them.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import apply_bn


def hard_simple_vfe(voxels: torch.Tensor,
                    num_points: torch.Tensor) -> torch.Tensor:
    """Mean of the real points per voxel: (..., V, P, D) -> (..., V, D)."""
    P = voxels.shape[-2]
    slot = torch.arange(P, device=voxels.device)
    m = (slot < num_points[..., None]).to(voxels.dtype)
    total = (voxels * m[..., None]).sum(-2)
    return total / num_points[..., None].to(voxels.dtype).clamp(min=1.0)


class _VFELayer(nn.Module):
    """mmdet3d VFELayer: ``linear`` (no bias) and ``norm`` (BatchNorm1d,
    eps 1e-3, momentum 0.01: flax's ``MaskedBatchNorm``)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.linear = nn.Linear(cin, cout, bias=False)
        self.norm = nn.BatchNorm1d(cout, eps=1e-3, momentum=0.01)


class HardVFE(nn.Module):
    """PointNet VFE: voxels (B, V, P, D), num_points (B, V) -> (B, V, C).

    mmdet3d's quirk, kept as JAX keeps it: padded slots are zeroed at the
    input only, so after Linear + BN + ReLU a padded slot carries
    relu(BN(0)) into the max. In training the batch-norm statistics span
    every slot of every non-empty voxel (padded slots included, empty
    voxels not). Non-empty voxels get the max, empty ones zeros. Computes
    in float32 (the JAX module takes no dtype)."""

    def __init__(self, in_channels: int = 5,
                 feat_channels: Sequence[int] = (64,),
                 voxel_size: Sequence[float] = (0.1, 0.1, 0.15),
                 point_cloud_range: Sequence[float] = (
                     -75.2, -75.2, -2.0, 75.2, 75.2, 4.0),
                 with_cluster_center: bool = False,
                 with_voxel_center: bool = False):
        super().__init__()
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.with_cluster_center = with_cluster_center
        self.with_voxel_center = with_voxel_center
        chans = [in_channels + 3 * (with_cluster_center + with_voxel_center),
                 *feat_channels]
        self.vfe_layers = nn.ModuleList(
            _VFELayer(a, b) for a, b in zip(chans[:-1], chans[1:]))

    def forward(self, voxels: torch.Tensor, num_points: torch.Tensor,
                coords: Optional[torch.Tensor] = None) -> torch.Tensor:
        """coords (B, V, 3) as (z, y, x): read with ``with_voxel_center``."""
        P = voxels.shape[-2]
        slot = torch.arange(P, device=voxels.device)
        fmask = (slot < num_points[..., None]).to(torch.float32)[..., None]
        v = voxels.float()
        feats = [v]
        if self.with_cluster_center:
            mean = (v[..., :3] * fmask).sum(-2) / num_points[..., None].to(
                torch.float32).clamp(min=1.0)
            feats.append(v[..., :3] - mean[..., None, :])
        if self.with_voxel_center:
            vs = torch.tensor(self.voxel_size, dtype=torch.float32,
                              device=v.device)
            pcr = torch.tensor(self.point_cloud_range[:3],
                               dtype=torch.float32, device=v.device)
            centers = (coords.flip(-1).to(torch.float32) + 0.5) * vs + pcr
            feats.append(v[..., :3] - centers[..., None, :])
        x = torch.cat(feats, dim=-1) * fmask
        has_pts = num_points > 0
        bn_mask = has_pts[..., None].expand(x.shape[:-1])
        for layer in self.vfe_layers:
            x = F.relu(apply_bn(F.linear(x, layer.linear.weight),
                                layer.norm, bn_mask))
        out = x.amax(-2)
        return torch.where(has_pts[..., None], out, 0.0)

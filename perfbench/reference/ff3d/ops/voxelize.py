"""Hard and dynamic voxelization with the mean VFE, fixed capacity, CSR
output order.

Port of ``focalformer3d_tpu/ops/voxelize.py`` (``point_voxel_coords``,
``_linear_key``, ``hard_voxelize``, ``hard_voxelize_simple``,
``dynamic_voxelize``). Points
are padded to a fixed N with a validity mask; a stable sort on a
CSR-compatible linear key groups the points of each voxel, and the voxels
come out in CSR order (column-major over BEV, z-minor), the order every
rulebook of ``ops/sparse_conv.py`` rests on.

The JAX version takes each voxel's sum as a difference of two prefix sums,
which cancels in float32 at 200k points. Here each voxel is summed directly
with ``index_add_``, so features agree with JAX on the CPU to float32
rounding (about 1e-6 relative at the test sizes), and on a card the atomic
adds may change the last bit from run to run.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..configs import VoxelConfig

INT32_MAX = 2 ** 31 - 1


def point_voxel_coords(cfg: VoxelConfig, points: torch.Tensor,
                       mask: torch.Tensor):
    """Per-point int32 voxel coords (z, y, x) and in-range validity.

    points: (N, >=3); mask: (N,) bool of real (non-pad) points.
    """
    pcr = torch.tensor(cfg.point_cloud_range, dtype=points.dtype,
                       device=points.device)
    vs = torch.tensor(cfg.voxel_size, dtype=points.dtype,
                      device=points.device)
    nx, ny, nz = cfg.grid_size
    cx = torch.floor((points[:, 0] - pcr[0]) / vs[0]).to(torch.int32)
    cy = torch.floor((points[:, 1] - pcr[1]) / vs[1]).to(torch.int32)
    cz = torch.floor((points[:, 2] - pcr[2]) / vs[2]).to(torch.int32)
    valid = (
        mask
        & (cx >= 0) & (cx < nx)
        & (cy >= 0) & (cy < ny)
        & (cz >= 0) & (cz < nz)
    )
    return torch.stack([cz, cy, cx], dim=-1), valid


def _linear_key(coords: torch.Tensor, valid: torch.Tensor, grid_size):
    """CSR-compatible key (y*nx + x)*nz + z; invalid points -> INT32_MAX."""
    nx, ny, nz = grid_size
    key = (coords[:, 1] * nx + coords[:, 2]) * nz + coords[:, 0]
    return torch.where(valid, key, torch.full_like(key, INT32_MAX))


def hard_voxelize(cfg: VoxelConfig, points: torch.Tensor,
                  mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Fixed-capacity hard voxelization of one sample, for ``HardVFE``.

    Each voxel keeps the first ``max_num_points`` points in input order, in
    its point slots; voxels past ``max_voxels`` in CSR order are dropped,
    with their points. The integer outputs equal JAX's bit for bit (the
    same stable sort, run ranks and drops). Returns voxels (V, P, D), zero
    in empty slots; num_points (V,) int32; coords (V, 3) int32 (z, y, x);
    voxel_mask (V,)."""
    V, P = cfg.max_voxels, cfg.max_num_points
    N, D = points.shape
    dev = points.device
    coords, valid = point_voxel_coords(cfg, points, mask)
    key = _linear_key(coords, valid, cfg.grid_size)

    skey, order = torch.sort(key, stable=True)
    svalid = valid[order]
    is_start = torch.ones_like(svalid)
    is_start[1:] = skey[1:] != skey[:-1]
    is_start &= svalid
    voxel_id = torch.cumsum(is_start, 0, dtype=torch.int64) - 1
    pos = torch.arange(N, device=dev)
    run_start = torch.cummax(
        torch.where(is_start, pos, torch.zeros_like(pos)), 0
    ).values
    rank = pos - run_start
    keep = svalid & (voxel_id < V) & (rank < P)

    # dropped points go to the sentinel slot V * P, which is cut off
    flat = torch.where(keep, voxel_id * P + rank,
                       torch.full_like(voxel_id, V * P))
    voxels = torch.zeros((V * P + 1, D), dtype=points.dtype, device=dev)
    voxels[flat] = torch.where(keep[:, None], points[order], 0.0)
    num_points = torch.zeros((V + 1,), dtype=torch.int32, device=dev)
    num_points.index_add_(0, torch.where(keep, voxel_id,
                                         torch.full_like(voxel_id, V)),
                          keep.to(torch.int32))

    vslot = torch.where(is_start & (voxel_id < V), voxel_id,
                        torch.full_like(voxel_id, V))
    out_coords = torch.zeros((V + 1, 3), dtype=torch.int32, device=dev)
    out_coords[vslot] = coords[order]
    voxel_mask = torch.zeros((V + 1,), dtype=torch.bool, device=dev)
    voxel_mask[vslot] = True
    return {
        "voxels": voxels[:V * P].reshape(V, P, D),
        "num_points": num_points[:V],
        "coords": out_coords[:V],
        "voxel_mask": voxel_mask[:V],
    }


def hard_voxelize_simple(cfg: VoxelConfig, points: torch.Tensor,
                         mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Hard voxelization fused with the mean VFE for one sample.

    Only the first ``max_num_points`` points of each voxel, in input order,
    enter its mean; voxels past ``max_voxels`` in CSR order are dropped.
    Returns features (V, D), coords (V, 3) int32 (z, y, x), voxel_mask (V,).
    """
    V, P = cfg.max_voxels, cfg.max_num_points
    N, D = points.shape
    dev = points.device
    coords, valid = point_voxel_coords(cfg, points, mask)
    key = _linear_key(coords, valid, cfg.grid_size)

    skey, order = torch.sort(key, stable=True)
    svalid = valid[order]
    is_start = torch.ones_like(svalid)
    is_start[1:] = skey[1:] != skey[:-1]
    is_start &= svalid
    voxel_id = torch.cumsum(is_start, 0, dtype=torch.int64) - 1
    pos = torch.arange(N, device=dev)
    run_start = torch.cummax(
        torch.where(is_start, pos, torch.zeros_like(pos)), 0
    ).values
    keep = svalid & (voxel_id < V) & (pos - run_start < P)

    slot = torch.where(keep, voxel_id, torch.full_like(voxel_id, V))
    spts = points[order]
    total = torch.zeros((V + 1, D), dtype=points.dtype, device=dev)
    total.index_add_(0, slot, spts * keep[:, None].to(points.dtype))
    count = torch.zeros((V + 1,), dtype=torch.int64, device=dev)
    count.index_add_(0, slot, keep.to(torch.int64))
    total, count = total[:V], count[:V]
    feats = total / count.clamp(min=1)[:, None].to(points.dtype)

    vslot = torch.where(is_start & (voxel_id < V), voxel_id,
                        torch.full_like(voxel_id, V))
    out_coords = torch.zeros((V + 1, 3), dtype=torch.int32, device=dev)
    out_coords[vslot] = coords[order]
    return {
        "features": feats,
        "coords": out_coords[:V],
        "voxel_mask": count > 0,
    }


def dynamic_voxelize(cfg: VoxelConfig, points: torch.Tensor,
                     mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Dynamic voxelization with the mean VFE (``DynamicSimpleVFE``) for
    one sample: every point of a voxel enters its mean (no per-voxel
    cap); voxels past ``max_voxels`` in CSR order are dropped, and so are
    their points (they reach no kept slot). Returns features (V, D),
    coords (V, 3) int32 (z, y, x), voxel_mask (V,), in the CSR order of
    ``hard_voxelize_simple``."""
    V = cfg.max_voxels
    N, D = points.shape
    dev = points.device
    coords, valid = point_voxel_coords(cfg, points, mask)
    key = _linear_key(coords, valid, cfg.grid_size)

    skey, order = torch.sort(key, stable=True)
    svalid = valid[order]
    is_start = torch.ones_like(svalid)
    is_start[1:] = skey[1:] != skey[:-1]
    is_start &= svalid
    voxel_id = torch.cumsum(is_start, 0, dtype=torch.int64) - 1

    # dropped points go to the sentinel row V, which is cut off
    seg = torch.where(svalid & (voxel_id < V), voxel_id,
                      torch.full_like(voxel_id, V))
    total = torch.zeros((V + 1, D), dtype=points.dtype, device=dev)
    total.index_add_(0, seg, points[order])
    count = torch.zeros((V + 1,), dtype=torch.int64, device=dev)
    count.index_add_(0, seg, torch.ones_like(seg))
    feats = total[:V] / count[:V].clamp(min=1)[:, None].to(points.dtype)

    vslot = torch.where(is_start & (voxel_id < V), voxel_id,
                        torch.full_like(voxel_id, V))
    out_coords = torch.zeros((V + 1, 3), dtype=torch.int32, device=dev)
    out_coords[vslot] = coords[order]
    return {"features": feats, "coords": out_coords[:V],
            "voxel_mask": count[:V] > 0}

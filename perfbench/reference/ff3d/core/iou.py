"""Rotated BEV / 3D IoU by convex polygon clipping in fixed buffers.

Port of ``focalformer3d_tpu/core/iou.py``: ``boxes_iou_3d``, which the
Hungarian assigner's IoU cost reads, and ``boxes_iou_bev``, which rotated
NMS and the TTA box vote read. The intersection of two rotated rectangles is
Sutherland-Hodgman clipping of one box's corners against the other's four
edges in an 8-vertex buffer, then the shoelace area; the pairs are clipped
all at once (``boxes_iou_bev``: only the pairs near enough to overlap).
"""
from __future__ import annotations

import torch

from .boxes import bev_corners

_MAX_VERTS = 8
# boxes_iou_bev clips the pairs whose circumscribed circles come this close
# (in the boxes' unit, metres): far beyond float32 rounding at the
# coordinates TTA's class offset reaches (~4 km, 2.4e-4 an ulp)
NEAR_SLACK = 0.1
PAIR_CHUNK = 1 << 20


def _next_index(n: torch.Tensor) -> torch.Tensor:
    """(..., 8) index of each slot's successor in a polygon of n vertices."""
    idx = torch.arange(_MAX_VERTS, device=n.device)
    nn = torch.clamp(n, min=1)[..., None]
    return torch.where(idx + 1 >= nn, 0, idx + 1)


def _clip_halfplane(poly, n, p0, p1):
    """Clip convex polygons poly (..., 8, 2) with n (...,) live vertices by
    the half-plane left of the directed edges p0 -> p1 (..., 2)."""
    ex = (p1[..., 0] - p0[..., 0])[..., None]
    ey = (p1[..., 1] - p0[..., 1])[..., None]

    def side(pt):  # >= 0: inside (left of the edge of a CCW rectangle)
        return ex * (pt[..., 1] - p0[..., None, 1]) \
            - ey * (pt[..., 0] - p0[..., None, 0])

    nxt_idx = _next_index(n)
    nxt = torch.gather(poly, -2, nxt_idx[..., None].expand_as(poly))
    s_cur, s_nxt = side(poly), side(nxt)
    live = torch.arange(_MAX_VERTS, device=n.device) < n[..., None]
    cur_in, nxt_in = s_cur >= 0, s_nxt >= 0
    denom = s_cur - s_nxt
    t = s_cur / torch.where(denom.abs() < 1e-12,
                            torch.full_like(denom, 1e-12), denom)
    inter = poly + t[..., None] * (nxt - poly)
    emit_cur = live & cur_in
    emit_int = live & (cur_in ^ nxt_in)
    # compact the slots [cur_0, int_0, cur_1, int_1, ...] that are emitted
    flags = torch.stack([emit_cur, emit_int], dim=-1).flatten(-2)
    verts = torch.stack([poly, inter], dim=-2).flatten(-3, -2)
    pos = torch.cumsum(flags.to(torch.int64), dim=-1) - 1
    out_idx = torch.where(flags & (pos < _MAX_VERTS), pos, _MAX_VERTS)
    # (slot 8 collects what is dropped)
    new_poly = poly.new_zeros(poly.shape[:-2] + (_MAX_VERTS + 1, 2))
    new_poly.scatter_(-2, out_idx[..., None].expand(*out_idx.shape, 2),
                      verts)
    return new_poly[..., :_MAX_VERTS, :], flags.sum(-1)


def _poly_area(poly, n):
    nxt = torch.gather(poly, -2, _next_index(n)[..., None].expand_as(poly))
    cross = poly[..., 0] * nxt[..., 1] - nxt[..., 0] * poly[..., 1]
    live = torch.arange(_MAX_VERTS, device=n.device) < n[..., None]
    return 0.5 * torch.where(live, cross, 0.0).sum(-1).abs()


def boxes_intersection_bev(boxes1: torch.Tensor,
                           boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise BEV intersection areas: (..., N, >=7) x (..., M, >=7) ->
    (..., N, M)."""
    c1 = bev_corners(boxes1)[..., :, None, :, :]  # (..., N, 1, 4, 2)
    c2 = bev_corners(boxes2)[..., None, :, :, :]  # (..., 1, M, 4, 2)
    shape = torch.broadcast_shapes(c1.shape[:-2], c2.shape[:-2])
    poly = c1.new_zeros(shape + (_MAX_VERTS, 2))
    poly[..., :4, :] = c1
    c2 = c2.expand(shape + (4, 2))
    n = torch.full(shape, 4, dtype=torch.int64, device=boxes1.device)
    for k in range(4):
        poly, n = _clip_halfplane(poly, n, c2[..., k, :],
                                  c2[..., (k + 1) % 4, :])
    return _poly_area(poly, n)


def boxes_iou_bev(boxes1: torch.Tensor, boxes2: torch.Tensor
                  ) -> torch.Tensor:
    """Pairwise rotated BEV IoU, (N, >=7) x (M, >=7) -> (N, M).

    Only the pairs whose circumscribed circles come within ``NEAR_SLACK``
    of each other are clipped, ``PAIR_CHUNK`` pairs at a time (~600 bytes
    of transient memory a pair); every other pair is apart by more than that,
    so its clipped polygon is empty and its IoU 0, as the full computation
    gives it. So is a pair with a point box (zero extents, such as the
    padding of a merge): its corners coincide. Finding the pairs syncs
    with the host once."""
    a1 = boxes1[:, 3] * boxes1[:, 4]
    a2 = boxes2[:, 3] * boxes2[:, 4]
    r1 = 0.5 * torch.hypot(boxes1[:, 3], boxes1[:, 4])
    r2 = 0.5 * torch.hypot(boxes2[:, 3], boxes2[:, 4])
    d2 = ((boxes1[:, None, 0] - boxes2[None, :, 0]) ** 2
          + (boxes1[:, None, 1] - boxes2[None, :, 1]) ** 2)
    near = ((d2 <= (r1[:, None] + r2[None, :] + NEAR_SLACK) ** 2)
            & (r1[:, None] > 0) & (r2[None, :] > 0))
    i, j = near.nonzero(as_tuple=True)
    inter = boxes1.new_zeros(near.shape)
    for s in range(0, i.shape[0], PAIR_CHUNK):
        ii, jj = i[s:s + PAIR_CHUNK], j[s:s + PAIR_CHUNK]
        inter[ii, jj] = boxes_intersection_bev(boxes1[ii, None],
                                               boxes2[jj, None])[:, 0, 0]
    union = a1[:, None] + a2[None, :] - inter
    return inter / torch.clamp(union, min=1e-8)


def boxes_iou_3d(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise 3D IoU in LiDAR coords (z = bottom centre), (..., N, M),
    as mmdet3d ``BboxOverlaps3D(coordinate='lidar')``."""
    inter_bev = boxes_intersection_bev(boxes1, boxes2)
    zb1, zt1 = boxes1[..., 2], boxes1[..., 2] + boxes1[..., 5]
    zb2, zt2 = boxes2[..., 2], boxes2[..., 2] + boxes2[..., 5]
    z_overlap = torch.clamp(
        torch.minimum(zt1[..., :, None], zt2[..., None, :])
        - torch.maximum(zb1[..., :, None], zb2[..., None, :]), min=0.0)
    inter = inter_bev * z_overlap
    v1 = boxes1[..., 3] * boxes1[..., 4] * boxes1[..., 5]
    v2 = boxes2[..., 3] * boxes2[..., 4] * boxes2[..., 5]
    union = torch.clamp(v1[..., :, None] + v2[..., None, :] - inter,
                        min=1e-8)
    return torch.clamp(inter / union, 0.0, 1.0)

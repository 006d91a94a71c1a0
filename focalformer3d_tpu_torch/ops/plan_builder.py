"""The meta-chain index build: packed output sites and rulebooks from meta.

Port of the index functions of ``focalformer3d_tpu/ops/plan_builder.py``
that the ``pallas_mxu`` engine runs between its kernels. A level's voxel set
is known by its column meta alone (``sparse_conv.downsample_meta`` derives
the next level's from it), and its sites by the packed list

    colz (V,) int32 = col * 64 + z in CSR order, -1 past the active count

from which ``decode_rules`` builds the absolute (K, V_out) rulebook: per
(output site, tap) one meta row fetch, a z-bit test and a popcount rank.
``decode_rules`` is the plain version of K2 (``plan_builder_cuda``), which
replaces the TPU kernel ``plan_builder._plan_kernel``. The TPU kernel's
chunk packing, one-hot windows and exact miss lists have no counterpart: a
card fetches meta rows directly.
"""
from __future__ import annotations

import torch

from . import sparse_conv as sc


def colz_from_coords(coords: torch.Tensor, valid: torch.Tensor,
                     w: int) -> torch.Tensor:
    """(V, 3) zyx int32 + valid -> packed col*64+z with -1 invalid."""
    col = coords[..., 1] * w + coords[..., 2]
    return torch.where(valid, col * 64 + coords[..., 0], -1).to(torch.int32)


def coords_from_colz(colz: torch.Tensor, w: int) -> torch.Tensor:
    """Packed sites -> (V, 3) zyx int32; invalid slots read (0, 0, 0), as
    ``sparse_conv.build_downsample`` leaves them."""
    czs = torch.where(colz >= 0, colz, 0)
    col = czs >> 6
    return torch.stack([czs & 63, col // w, col % w], -1).to(torch.int32)


def colz_from_meta(meta: torch.Tensor, capacity: int,
                   d: int = 64) -> torch.Tensor:
    """Expand a CSR column meta into the per-slot packed (col, z) list.

    Slot s < min(total, capacity) lies in the column whose row range holds
    it (a search over the cumulative counts), and its z is the r-th set bit
    of that column's mask, r = s - row_start, found by a binary search on
    prefix ranks; ``d`` bounds the search as in the JAX function (steps of
    2*d or more are skipped). Returns (capacity,) int32, -1 beyond the
    active count."""
    counts = meta[:-1, 3].to(torch.int64)
    n_col = counts.shape[0]
    ends = torch.cumsum(counts, 0)
    total = ends[-1]
    slots = torch.arange(capacity, device=meta.device)
    col = torch.searchsorted(ends, slots, right=True).clamp(max=n_col - 1)
    r = slots - (ends[col] - counts[col])
    u0, u1 = sc._u32(meta[col, 0]), sc._u32(meta[col, 1])
    z = torch.zeros_like(slots)
    for shift in (32, 16, 8, 4, 2, 1):
        if shift >= 2 * d:
            continue
        zc = z + shift
        z = torch.where(sc._rank(u0, u1, zc) <= r, zc, z)
    live = slots < torch.clamp(total, max=capacity)
    return torch.where(live, col * 64 + z, -1).to(torch.int32)


def decode_rules(colz: torch.Tensor, in_capacity: int, meta: torch.Tensor,
                 kernel_size=3, stride=1, padding=0,
                 in_shape=(41, 1440, 1440), out_w=None) -> torch.Tensor:
    """Absolute (K, V_out) int32 rulebook, dz-major taps, from the input
    level's meta and the packed output sites; misses = ``in_capacity``.
    K2's plain version, equal to ``sparse_conv.build_conv_rules``: positions
    past ``in_capacity`` (voxels that a capacity-bound downsample dropped
    from the input level) are clipped to it, i.e. misses, as that function
    clips them. The JAX function leaves them unclipped, and its gathers
    read them as zero rows."""
    kz, ky, kx = sc._as_triple(kernel_size)
    sz, sy, sx = sc._as_triple(stride)
    pz, py, px = sc._as_triple(padding)
    D, H, W = in_shape
    if out_w is None:
        out_w = W
    n_col = H * W
    dev = colz.device
    ok0 = colz >= 0
    czs = torch.where(ok0, colz, 0).to(torch.int64)
    col = czs >> 6
    y = col // out_w
    x = col - y * out_w
    dy, dx = sc._bev_taps(ky, kx, dev)
    dy, dx = dy[:, None], dx[:, None]
    yi = y * sy - py + dy  # (ky*kx, V_out)
    xi = x * sx - px + dx
    bev_ok = ok0 & (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
    m = meta[torch.where(bev_ok, yi * W + xi, n_col)]
    u0, u1 = sc._u32(m[None, ..., 0]), sc._u32(m[None, ..., 1])
    start = m[None, ..., 2].to(torch.int64)
    zi = (czs & 63) * sz - pz + torch.arange(kz, device=dev)[:, None, None]
    hit = (bev_ok[None] & (zi >= 0) & (zi < D)
           & sc._test_bit(u0, u1, zi.clamp(0, 63)))
    pos = torch.where(hit, start + sc._rank(u0, u1, zi.clamp(0, 63)),
                      in_capacity)
    return pos.clamp(max=in_capacity).reshape(kz * ky * kx, -1).to(
        torch.int32)

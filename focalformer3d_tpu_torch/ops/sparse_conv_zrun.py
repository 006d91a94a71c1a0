"""z-run plans: one code per (output site, BEV tap) for the kz=3 z taps.

Port of the plan of ``focalformer3d_tpu/ops/sparse_conv_zrun.py``
(``build_zplan``) and the plain version of its apply. CSR order is z-minor,
so for one output site and one BEV tap (dy, dx) the present taps among
z0 = z*sz - pz, z0 + 1, z0 + 2 are consecutive CSR rows of one input column.
A plan stores, per (BEV tap r = dy*kx + dx, output site j),

    code = (anchor << 3) | pattern        (0 when no tap is present)

with bit dz of ``pattern`` set when tap dz is present and ``anchor`` the CSR
position of the first present tap; tap dz then reads row
anchor + popcount(pattern & ((1 << dz) - 1)). The pattern 0b101 (z0 and
z0 + 2 present, z0 + 1 absent) reads anchor and anchor + 1. The TPU plan's
4-block pattern (e0..e3), window-relative anchors biased by +4 and spill
lists serve its one-hot selection; a card reads rows directly, so this
packing keeps only the absolute anchor and the three presence bits.

``apply_conv_zrun_plain`` is K3's plain version: it expands the codes into
the rulebook they encode (``zrun_rules``) and runs the gather + matmul of
``sparse_conv_cuda.apply_conv_plain``.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import sparse_conv as sc
from .sparse_conv_cuda import apply_conv_plain

ZTAPS = 3
MAX_ANCHOR = 2 ** 28  # anchor << 3 stays within int32


def build_zplan(table: sc.VoxelTable, in_shape, out_coords: torch.Tensor,
                out_valid: torch.Tensor, kernel_size=3, stride=1,
                padding=0) -> torch.Tensor:
    """z-run codes (ky*kx, V_out) int32 of one conv geometry on one voxel
    set, straight from the column meta: one meta row fetch and one rank per
    (site, BEV tap)."""
    kz, ky, kx = sc._as_triple(kernel_size)
    sz, sy, sx = sc._as_triple(stride)
    pz, py, px = sc._as_triple(padding)
    if kz != ZTAPS:
        raise ValueError(f"z-run plans need kz == {ZTAPS}, got {kz}")
    if table.capacity >= MAX_ANCHOR:
        raise ValueError(f"capacity {table.capacity} >= {MAX_ANCHOR}")
    D, H, W = in_shape
    n_col = H * W
    dev = out_coords.device
    oc = out_coords.to(torch.int64)

    dy, dx = sc._bev_taps(ky, kx, dev)
    dy, dx = dy[:, None], dx[:, None]
    yi = oc[:, 1] * sy - py + dy  # (ky*kx, V_out)
    xi = oc[:, 2] * sx - px + dx
    bev_ok = out_valid & (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
    m = table.meta[torch.where(bev_ok, yi * W + xi, n_col)]
    u0, u1 = sc._u32(m[..., 0]), sc._u32(m[..., 1])
    z0 = (oc[:, 0] * sz - pz).expand_as(yi)
    pattern = torch.zeros_like(yi)
    for dz in range(ZTAPS):
        zi = z0 + dz
        present = (bev_ok & (zi >= 0) & (zi < D)
                   & sc._test_bit(u0, u1, zi.clamp(0, 63)))
        pattern = pattern | (present.to(torch.int64) << dz)
    anchor = m[..., 2].to(torch.int64) + sc._rank(u0, u1, z0.clamp(0, 63))
    return torch.where(pattern > 0, (anchor << 3) | pattern,
                       0).to(torch.int32)


def zrun_rules(codes: torch.Tensor, v_in: int) -> torch.Tensor:
    """Expand codes (..., R, V_out) into the rulebook they encode, (...,
    3R, V_out) int32, dz-major taps, ``v_in`` for misses and for positions
    past it (as ``sparse_conv.build_conv_rules`` clips them)."""
    c = codes.to(torch.int64)
    pattern = c & 7
    anchor = c >> 3
    taps = []
    for dz in range(ZTAPS):
        below = pattern & ((1 << dz) - 1)
        off = (below & 1) + ((below >> 1) & 1)
        present = ((pattern >> dz) & 1) == 1
        row = (anchor + off).clamp(max=v_in)
        taps.append(torch.where(present, row, v_in))
    return torch.cat(taps, dim=-2).to(torch.int32)


def apply_conv_zrun_plain(features: torch.Tensor, codes: torch.Tensor,
                          weights: torch.Tensor, out_valid: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          compute_dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """The sparse conv the codes encode, as gather + matmul. features (B,
    V_in, C); codes (B, R, V_out); weights (3R, C, Cout) dz-major; out_valid
    (B, V_out)."""
    rules = zrun_rules(codes, features.shape[1])
    return apply_conv_plain(features, rules, weights, out_valid, bias,
                            compute_dtype)

"""Sparse 3D convolution index build: CSR + z-bitmask rulebooks, torch ops.

Port of the index build of ``focalformer3d_tpu/ops/sparse_conv.py`` (the
exact ``voxel`` engine). A voxel set of one sample is a fixed-capacity table

    coords (V, 3) int32 (z, y, x), valid (V,) bool, in CSR order
    meta (H*W + 1, 4) int32 = [zbits lo-word, zbits hi-word, row_start, count]

and a neighbour lookup is one meta row fetch plus a popcount rank:

    pos(col, z) = row_start[col] + popcount(zbits[col] & ((1 << z) - 1))

The z-bitmask words are stored as int32 two's complement, so ``meta``
matches the JAX table bit for bit. Torch has no popcount and no logical
shift on int32 (its ``>>`` is arithmetic, and ``1 << 31`` overflows), so
the word arithmetic runs on int64 tensors that hold the unsigned 32-bit
value of each word (``_u32``), and ``_i32`` folds the result back into
two's complement.

Tables are always CSR-ordered here (the voxelizer and ``build_downsample``
emit that order), so a CSR position is a table row and the JAX engine's
``rows`` indirection (``use_positions=False``) has no counterpart. The
rulebook these functions build is the contract of the sparse-conv apply
(``ops/sparse_conv_cuda.py``): ``(K, V_out)`` CSR positions in dz-major
tap order ((dz, dy, dx) with dx fastest) with ``V_in`` as the miss
sentinel.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

_MASK32 = 0xFFFFFFFF


def _as_triple(v) -> Tuple[int, int, int]:
    if isinstance(v, int):
        return (v, v, v)
    return tuple(v)  # type: ignore[return-value]


# ---------------------------------------------------------------------------
# two-word (64-bit) z-bitmask helpers, on int64 tensors holding uint32 values
# ---------------------------------------------------------------------------

def _u32(w: torch.Tensor) -> torch.Tensor:
    """int32 two's-complement word -> int64 holding its unsigned value."""
    return w.to(torch.int64) & _MASK32


def _i32(u: torch.Tensor) -> torch.Tensor:
    """int64 holding an unsigned 32-bit value -> int32 two's complement."""
    u = u & _MASK32
    return torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32)


def _popcount(u: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int64 tensors holding 32-bit unsigned values."""
    u = u - ((u >> 1) & 0x55555555)
    u = (u & 0x33333333) + ((u >> 2) & 0x33333333)
    u = (u + (u >> 4)) & 0x0F0F0F0F
    return ((u * 0x01010101) & _MASK32) >> 24


def _zbit(z: torch.Tensor):
    """(1 << z) split across two unsigned words (z in [0, 64))."""
    z = z.to(torch.int64)
    one = torch.ones_like(z)
    lo = torch.where(z < 32, one << z.clamp(0, 31), 0)
    hi = torch.where(z >= 32, one << (z - 32).clamp(0, 31), 0)
    return lo, hi


def _low_mask(z: torch.Tensor):
    """Bits [0, z) across two unsigned words."""
    z = z.to(torch.int64)
    one = torch.ones_like(z)
    lo = torch.where(z < 32, (one << z.clamp(0, 31)) - 1, _MASK32)
    hi = torch.where(z >= 32, (one << (z - 32).clamp(0, 31)) - 1, 0)
    return lo, hi


def _test_bit(u0, u1, z: torch.Tensor) -> torch.Tensor:
    z = z.to(torch.int64)
    lo = (u0 >> z.clamp(0, 31)) & 1
    hi = (u1 >> (z - 32).clamp(0, 31)) & 1
    return torch.where(z < 32, lo, hi) == 1


def _rank(u0, u1, z: torch.Tensor) -> torch.Tensor:
    """Number of set bits strictly below z."""
    m0, m1 = _low_mask(z)
    return _popcount(u0 & m0) + _popcount(u1 & m1)


# ---------------------------------------------------------------------------
# voxel table
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class VoxelTable:
    """CSR + z-bitmask index over a CSR-ordered voxel set (one sample)."""

    coords: torch.Tensor  # (V, 3) int32 (z, y, x)
    valid: torch.Tensor  # (V,) bool
    meta: torch.Tensor  # (H*W + 1, 4) int32 [bits_lo, bits_hi, start, cnt]

    @property
    def capacity(self) -> int:
        return self.coords.shape[-2]


def _column_bits(coords, valid, shape):
    """z-bits per BEV column as two (H*W + 1,) unsigned-word tensors.

    Built by scatter-add, which equals OR only because the voxels of a
    table are unique; the sums of distinct bits stay below 2**32 in int64,
    so bit 31 needs no wrap here."""
    D, H, W = shape
    n_col = H * W
    col = coords[:, 1].to(torch.int64) * W + coords[:, 2]
    cslot = torch.where(valid, col, n_col)
    b0, b1 = _zbit(coords[:, 0])
    bits0 = torch.zeros(n_col + 1, dtype=torch.int64, device=coords.device)
    bits1 = torch.zeros_like(bits0)
    bits0.index_add_(0, cslot, torch.where(valid, b0, 0))
    bits1.index_add_(0, cslot, torch.where(valid, b1, 0))
    return bits0, bits1


def _meta_from_bits(bits0, bits1) -> torch.Tensor:
    """[bits0, bits1, exclusive-cumsum(count), count] int32 rows; the final
    (overflow) slot gets zero bits. Takes unsigned-word tensors."""
    bits0 = bits0.clone()
    bits1 = bits1.clone()
    bits0[-1] = 0
    bits1[-1] = 0
    counts = _popcount(bits0) + _popcount(bits1)
    row_start = torch.cumsum(counts, 0) - counts
    return torch.stack(
        [_i32(bits0), _i32(bits1), row_start.to(torch.int32),
         counts.to(torch.int32)], dim=-1,
    )


def build_table_csr(coords: torch.Tensor, valid: torch.Tensor,
                    shape) -> VoxelTable:
    """Table over an already CSR-ordered voxel set (the order
    ``ops/voxelize.py`` emits)."""
    D, H, W = shape
    if D > 64:
        raise ValueError(f"z extent {D} > 64 (bitmask words)")
    meta = _meta_from_bits(*_column_bits(coords, valid, shape))
    return VoxelTable(coords, valid, meta)


def table_from_meta(coords_csr, valid_csr, meta) -> VoxelTable:
    """Table over a CSR-ordered set whose column meta is already known (the
    out_meta of ``build_downsample``)."""
    return VoxelTable(coords_csr, valid_csr, meta)


def build_conv_rules(in_table: VoxelTable, in_shape, out_coords, out_valid,
                     kernel_size, stride, padding) -> torch.Tensor:
    """Rulebook (K, V_out) int32: the input CSR position feeding each
    output site per tap, dz-major tap order; V_in is the miss
    sentinel. out[j] = sum_d W[d] * x[j*stride - padding + d].

    One meta fetch per BEV tap serves all kz z-taps; the (kz, ky*kx, V_out)
    result is dz-major once flattened."""
    kz, ky, kx = _as_triple(kernel_size)
    sz, sy, sx = _as_triple(stride)
    pz, py, px = _as_triple(padding)
    D, H, W = in_shape
    V = in_table.capacity
    n_col = H * W
    dev = out_coords.device
    oc = out_coords.to(torch.int64)

    dy = torch.arange(ky, device=dev).repeat_interleave(kx)  # (ky*kx,)
    dx = torch.arange(kx, device=dev).repeat(ky)
    yi = oc[None, :, 1] * sy - py + dy[:, None]  # (ky*kx, V_out)
    xi = oc[None, :, 2] * sx - px + dx[:, None]
    bev_ok = (out_valid[None] & (yi >= 0) & (yi < H)
              & (xi >= 0) & (xi < W))
    colq = torch.where(bev_ok, yi * W + xi, n_col)
    m = in_table.meta[colq]  # (ky*kx, V_out, 4)
    u0, u1 = _u32(m[None, ..., 0]), _u32(m[None, ..., 1])
    start = m[None, ..., 2].to(torch.int64)

    dz = torch.arange(kz, device=dev)[:, None, None]
    zi = (oc[None, None, :, 0] * sz - pz + dz).expand(kz, ky * kx, -1)
    ok = bev_ok[None] & (zi >= 0) & (zi < D) & _test_bit(u0, u1, zi)
    pos = torch.where(ok, start + _rank(u0, u1, zi), V)
    return pos.reshape(kz * ky * kx, -1).clamp(0, V).to(torch.int32)


def build_subm_rules(table: VoxelTable, shape,
                     kernel_size=3) -> torch.Tensor:
    """Submanifold rulebook: output sites == input sites, stride 1,
    padding (k-1)//2."""
    k = _as_triple(kernel_size)
    pad = tuple((x - 1) // 2 for x in k)
    return build_conv_rules(table, shape, table.coords, table.valid, k,
                            (1, 1, 1), pad)


def conv_out_shape(in_shape, kernel_size, stride, padding):
    k, s, p = _as_triple(kernel_size), _as_triple(stride), _as_triple(padding)
    out = tuple(
        (d + 2 * pi - ki) // si + 1
        for d, ki, si, pi in zip(in_shape, k, s, p)
    )
    if any(d <= 0 for d in out):
        raise ValueError(
            f"sparse conv output shape {out} non-positive for input "
            f"{tuple(in_shape)} kernel {k} stride {s} padding {p}"
        )
    return out


def _compress_even_bits(x):
    """Unsigned 32-bit words: keep the bits at even positions, packed into
    the low 16."""
    x = x & 0x55555555
    x = (x | (x >> 1)) & 0x33333333
    x = (x | (x >> 2)) & 0x0F0F0F0F
    x = (x | (x >> 4)) & 0x00FF00FF
    x = (x | (x >> 8)) & 0x0000FFFF
    return x


def _downsample_bits(u0, u1, D, Do, kz, sz, pz):
    """z-bitmask (unsigned words) of the strided conv's active outputs, per
    column: out bit zo is set iff some input z = zo*sz - pz + dz is set."""
    if sz == 2 and Do <= 32:
        ulo = torch.zeros_like(u0)
        uhi = torch.zeros_like(u1)
        for dz in range(kz):
            n = dz - pz
            if n > 0:  # shift the 64-bit pair right by n
                ulo = ulo | (u0 >> n) | ((u1 << (32 - n)) & _MASK32)
                uhi = uhi | (u1 >> n)
            elif n < 0:  # left by -n
                s = -n
                ulo = ulo | ((u0 << s) & _MASK32)
                uhi = uhi | ((u1 << s) & _MASK32) | (u0 >> (32 - s))
            else:
                ulo = ulo | u0
                uhi = uhi | u1
        out = _compress_even_bits(ulo) | (_compress_even_bits(uhi) << 16)
        mask = (1 << Do) - 1 if Do < 32 else _MASK32
        return out & mask, torch.zeros_like(u1)
    o0 = torch.zeros_like(u0)
    o1 = torch.zeros_like(u1)
    for zo in range(Do):
        hit = torch.zeros_like(u0)
        for dz in range(kz):
            zi = zo * sz - pz + dz
            if zi < 0 or zi >= D:
                continue
            w = u0 if zi < 32 else u1
            hit = hit | ((w >> (zi % 32)) & 1)
        if zo < 32:
            o0 = o0 | (hit << zo)
        else:
            o1 = o1 | (hit << (zo - 32))
    return o0, o1


def _bev_union(z, in_hw, out_hw, ky, kx, sy, sx, py, px):
    """OR over the ky*kx BEV taps: out col (yo, xo) sees in col
    (yo*sy - py + dy, xo*sx - px + dx); z is (H, W)."""
    H, W = in_hw
    Ho, Wo = out_hw
    ph = max(0, (Ho - 1) * sy + ky - py - H)
    pw = max(0, (Wo - 1) * sx + kx - px - W)
    zp = z.new_zeros((py + H + ph, px + W + pw))
    zp[py:py + H, px:px + W] = z
    o = z.new_zeros((Ho, Wo))
    for dy in range(ky):
        for dx in range(kx):
            o = o | zp[dy:dy + (Ho - 1) * sy + 1:sy,
                       dx:dx + (Wo - 1) * sx + 1:sx]
    return o


def build_downsample(coords, valid, in_shape, kernel_size, stride, padding,
                     out_capacity: int):
    """Active output set of a strided sparse conv.

    Returns (out_coords (Vo, 3) int32, out_valid (Vo,), out_shape, overflow
    count, out_meta). Output order is CSR; out_meta is the next level's
    column index (``table_from_meta``). Output z-bitmasks are word
    arithmetic on the input bitmasks, the BEV union is ky*kx strided
    slices, and the coordinate list is one scatter per candidate output
    cell of each input voxel."""
    kz, ky, kx = _as_triple(kernel_size)
    sz, sy, sx = _as_triple(stride)
    pz, py, px = _as_triple(padding)
    D, H, W = in_shape
    out_shape = conv_out_shape(in_shape, kernel_size, stride, padding)
    Do, Ho, Wo = out_shape
    dev = coords.device

    in0, in1 = _column_bits(coords, valid, in_shape)
    z0, z1 = _downsample_bits(in0[:-1], in1[:-1], D, Do, kz, sz, pz)
    o0 = _bev_union(z0.reshape(H, W), (H, W), (Ho, Wo), ky, kx, sy, sx,
                    py, px)
    o1 = _bev_union(z1.reshape(H, W), (H, W), (Ho, Wo), ky, kx, sy, sx,
                    py, px)
    zero = o0.new_zeros(1)
    out_meta = _meta_from_bits(torch.cat([o0.reshape(-1), zero]),
                               torch.cat([o1.reshape(-1), zero]))
    total = out_meta[-2, 2].to(torch.int64) + out_meta[-2, 3]

    # coordinate list: each input voxel writes its candidate output cells
    # (ceil(k/s) per dim) at their CSR rows; duplicates write equal values
    ocoords = torch.zeros((out_capacity + 1, 3), dtype=torch.int32,
                          device=dev)
    n_col_o = Ho * Wo
    c = coords.to(torch.int64)
    for by in range((ky + sy - 1) // sy):
        for bx in range((kx + sx - 1) // sx):
            yo = (c[:, 1] + py) // sy - by
            xo = (c[:, 2] + px) // sx - bx
            offy = c[:, 1] + py - yo * sy
            offx = c[:, 2] + px - xo * sx
            bev_ok = (valid & (offy >= 0) & (offy < ky) & (offx >= 0)
                      & (offx < kx) & (yo >= 0) & (yo < Ho) & (xo >= 0)
                      & (xo < Wo))
            m = out_meta[torch.where(bev_ok, yo * Wo + xo, n_col_o)]
            u0, u1 = _u32(m[:, 0]), _u32(m[:, 1])
            start = m[:, 2].to(torch.int64)
            for bz in range((kz + sz - 1) // sz):
                zo = (c[:, 0] + pz) // sz - bz
                offz = c[:, 0] + pz - zo * sz
                ok = bev_ok & (offz >= 0) & (offz < kz) & (zo >= 0) & (zo < Do)
                row = start + _rank(u0, u1, zo)
                row = torch.where(ok & (row < out_capacity), row,
                                  out_capacity)
                ocoords[row] = torch.stack([zo, yo, xo], -1).to(torch.int32)
    out_valid = (torch.arange(out_capacity, device=dev)
                 < torch.clamp(total, max=out_capacity))
    overflow = torch.clamp(total - out_capacity, min=0)
    return ocoords[:-1], out_valid, out_shape, overflow, out_meta


def to_dense(features, coords, valid, shape) -> torch.Tensor:
    """Scatter a voxel table (V, C) into a dense (D, H, W, C) grid."""
    D, H, W = shape
    C = features.shape[1]
    c = coords.to(torch.int64)
    key = (c[:, 1] * W + c[:, 2]) * D + c[:, 0]  # z-minor, CSR order
    idx = torch.where(valid, key, D * H * W)
    dense = features.new_zeros((D * H * W + 1, C))
    dense[idx] = features * valid[:, None].to(features.dtype)
    return dense[:-1].reshape(H, W, D, C).permute(2, 0, 1, 3)

"""The index build's CUDA kernels (``csrc/plan_builder.cu``) and their
plain versions.

- ``plan_rules``, K2, the rulebook builder (replacing the TPU kernel
  ``focalformer3d_tpu/ops/plan_builder.py:_plan_kernel``); its plain
  version is ``plan_builder.decode_rules`` per sample. Both give the
  absolute rulebook that the sparse-conv apply (K1) reads, equal to
  ``sparse_conv.build_conv_rules``:

      rules[b, k, j] = row_start[col] + popcount(zbits[col] & ((1 << zi) - 1))
                       for tap k of output site j where its z bit is set,
                       in_capacity elsewhere

- ``index_table``, the column tables of a batch of CSR voxel sets; its
  plain version ``index_table_plain`` runs ``sparse_conv.build_table_csr``
  per sample.
- ``index_downsample``, the active output set of a strided conv; its plain
  version ``index_downsample_plain`` runs ``sparse_conv.build_downsample``
  per sample.

Each takes a batch and launches its kernels once for all of it (the batch
in ``blockIdx.z``) for tensors on a card, or raises; for tensors on the CPU
it runs its plain version. The outputs are equal bit for bit. The kernels
are compiled at first use by ``cuda_build``.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from . import sparse_conv as sc
from .plan_builder import decode_rules

SOURCE = cuda_build.CSRC / "plan_builder.cu"

# columns a block of the index build's scans takes (kTile of the source)
TILE_COLUMNS = 2048
_ARGTYPES = {
    "plan_rules_forward": [ctypes.c_void_p] * 3
    + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 3
    + [ctypes.c_void_p],
    "index_table_forward": [ctypes.c_void_p] * 5
    + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 3
    + [ctypes.c_void_p],
    "index_downsample_forward": [ctypes.c_void_p] * 9
    + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 4
    + [ctypes.c_void_p],
}
_fns: dict = {}
# calls that launched kernels, by kind: K2 ``rules``; ``table`` and
# ``downsample`` (a memset and three kernels each)
_launches = cuda_build.Launches("rules", "table", "downsample")


def launch_count(kind: str = "rules") -> int:
    """Launches of one kind since the last ``reset_launch_count``."""
    return _launches.counts[kind]


def reset_launch_count() -> None:
    _launches.reset()


def _load(symbol: str):
    if symbol not in _fns:
        _fns[symbol] = cuda_build.load(SOURCE, symbol, _ARGTYPES[symbol])
    return _fns[symbol]


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def plan_rules(meta: torch.Tensor, colz: torch.Tensor, in_capacity: int,
               kernel_size=3, stride=1, padding=0,
               in_shape=(41, 1440, 1440), out_w=None) -> torch.Tensor:
    """Batched rulebook of one conv geometry.

    meta int32 (B, H*W + 1, 4) of the input level; colz int32 (B, V_out) of
    packed output sites (col*64+z in the output grid of width ``out_w``, -1
    invalid); both contiguous, on one device. Returns int32 (B, K, V_out),
    dz-major taps, ``in_capacity`` for misses. On a CUDA device this
    launches the kernel (or raises); on the CPU it runs ``decode_rules``."""
    kz, ky, kx = sc._as_triple(kernel_size)
    D, H, W = in_shape
    if out_w is None:
        out_w = W
    if meta.dtype != torch.int32 or colz.dtype != torch.int32:
        raise TypeError("meta and colz must be int32")
    if not (meta.is_contiguous() and colz.is_contiguous()):
        raise ValueError("meta and colz must be contiguous")
    B, V_out = colz.shape
    if meta.shape != (B, H * W + 1, 4):
        raise ValueError(f"meta {tuple(meta.shape)} is not (B={B}, "
                         f"{H * W + 1}, 4) for the input grid {in_shape}")
    if D > 64:
        raise ValueError(f"z extent {D} > 64 (bitmask words)")
    if not cuda_build.on_card(meta, colz):
        return torch.stack([
            decode_rules(colz[b], in_capacity, meta[b], kernel_size, stride,
                         padding, in_shape, out_w) for b in range(B)])
    cuda_build.check_aligned(meta)
    geom = (ctypes.c_int * 13)(
        kz, ky, kx, *sc._as_triple(stride), *sc._as_triple(padding),
        D, H, W, out_w)
    fn = _load("plan_rules_forward")
    rules = torch.empty((B, kz * ky * kx, V_out), dtype=torch.int32,
                        device=meta.device)
    cuda_build.check_launch(fn(
        meta.data_ptr(), colz.data_ptr(), rules.data_ptr(), geom, B, V_out,
        in_capacity, _stream(meta)), "plan_rules")
    _launches.add("rules")
    return rules


def _check_sites(coords: torch.Tensor, valid: torch.Tensor, shape) -> int:
    """The batch size of (B, V, 3) int32 coords and (B, V) bool valid, both
    contiguous; raises where the tables' z extent passes 64."""
    if coords.dtype != torch.int32 or valid.dtype != torch.bool:
        raise TypeError("coords must be int32 and valid bool")
    if not (coords.is_contiguous() and valid.is_contiguous()):
        raise ValueError("coords and valid must be contiguous")
    if valid.dim() != 2 or coords.shape != (*valid.shape, 3):
        raise ValueError(f"coords {tuple(coords.shape)} and valid "
                         f"{tuple(valid.shape)} are not (B, V, 3), (B, V)")
    if shape[0] > 64:
        raise ValueError(f"z extent {shape[0]} > 64 (bitmask words)")
    return valid.shape[0]


def _scratch(B: int, n_in: int, n_out: int, device):
    """The kernels' scratch: the input columns' z-words, the scans' tile
    sums."""
    n_tiles = -(-n_out // TILE_COLUMNS)
    return (torch.empty((B, n_in), dtype=torch.int64, device=device),
            torch.empty((B, n_tiles), dtype=torch.int32, device=device),
            n_tiles)


def index_table_plain(coords: torch.Tensor, valid: torch.Tensor,
                      shape) -> torch.Tensor:
    """``index_table``'s plain version, on any device."""
    return torch.stack([sc.build_table_csr(coords[b], valid[b], shape).meta
                        for b in range(valid.shape[0])])


def index_table(coords: torch.Tensor, valid: torch.Tensor,
                shape) -> torch.Tensor:
    """Column metas (B, H*W + 1, 4) int32 of a batch of CSR-ordered voxel
    sets, coords (B, V, 3) int32 zyx and valid (B, V) bool: per sample the
    meta of ``sparse_conv.build_table_csr``. On a CUDA device this
    launches the kernels (or raises); on the CPU it runs
    ``index_table_plain``."""
    B = _check_sites(coords, valid, shape)
    D, H, W = shape
    if not cuda_build.on_card(coords, valid):
        return index_table_plain(coords, valid, shape)
    bits, tile_sums, n_tiles = _scratch(B, H * W, H * W, coords.device)
    meta = torch.empty((B, H * W + 1, 4), dtype=torch.int32,
                       device=coords.device)
    cuda_build.check_aligned(meta)
    cuda_build.check_launch(_load("index_table_forward")(
        coords.data_ptr(), valid.data_ptr(), bits.data_ptr(),
        tile_sums.data_ptr(), meta.data_ptr(), (ctypes.c_int * 3)(D, H, W),
        B, valid.shape[1], n_tiles, _stream(coords)), "index_table")
    _launches.add("table")
    return meta


def index_downsample_plain(coords: torch.Tensor, valid: torch.Tensor,
                           in_shape, kernel_size, stride, padding,
                           out_capacity: int):
    """``index_downsample``'s plain version, on any device."""
    outs = [sc.build_downsample(coords[b], valid[b], in_shape, kernel_size,
                                stride, padding, out_capacity)
            for b in range(valid.shape[0])]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]),
            sc.conv_out_shape(in_shape, kernel_size, stride, padding),
            torch.stack([o[3] for o in outs]),
            torch.stack([o[4] for o in outs]))


def index_downsample(coords: torch.Tensor, valid: torch.Tensor, in_shape,
                     kernel_size, stride, padding, out_capacity: int):
    """Active output sets of a strided sparse conv over a batch of
    CSR-ordered voxel sets (coords (B, V, 3) int32, valid (B, V) bool):
    (out_coords (B, Vo, 3) int32, out_valid (B, Vo) bool, out_shape,
    overflow (B,) int64, out_meta (B, Ho*Wo + 1, 4) int32), per sample
    what ``sparse_conv.build_downsample`` returns. On a CUDA device this
    launches the kernels (or raises); on the CPU it runs
    ``index_downsample_plain``."""
    B = _check_sites(coords, valid, in_shape)
    out_shape = sc.conv_out_shape(in_shape, kernel_size, stride, padding)
    if out_shape[0] > 64:
        raise ValueError(f"output z extent {out_shape[0]} > 64 (bitmask "
                         "words)")
    if not cuda_build.on_card(coords, valid):
        return index_downsample_plain(coords, valid, in_shape, kernel_size,
                                      stride, padding, out_capacity)
    D, H, W = in_shape
    Do, Ho, Wo = out_shape
    dev = coords.device
    bits, tile_sums, n_tiles = _scratch(B, H * W, Ho * Wo, dev)
    words = torch.empty((B, Ho * Wo), dtype=torch.int64, device=dev)
    meta = torch.empty((B, Ho * Wo + 1, 4), dtype=torch.int32, device=dev)
    out_coords = torch.empty((B, out_capacity, 3), dtype=torch.int32,
                             device=dev)
    out_valid = torch.empty((B, out_capacity), dtype=torch.bool, device=dev)
    overflow = torch.empty((B,), dtype=torch.int64, device=dev)
    cuda_build.check_aligned(meta)
    geom = (ctypes.c_int * 15)(
        *sc._as_triple(kernel_size), *sc._as_triple(stride),
        *sc._as_triple(padding), D, H, W, Do, Ho, Wo)
    cuda_build.check_launch(_load("index_downsample_forward")(
        coords.data_ptr(), valid.data_ptr(), bits.data_ptr(),
        words.data_ptr(), tile_sums.data_ptr(), meta.data_ptr(),
        out_coords.data_ptr(), out_valid.data_ptr(), overflow.data_ptr(),
        geom, B, valid.shape[1], out_capacity, n_tiles, _stream(coords)),
        "index_downsample")
    _launches.add("downsample")
    return out_coords, out_valid, out_shape, overflow, meta

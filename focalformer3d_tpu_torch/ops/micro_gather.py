"""Kernel B: the gather probes, hand-written CUDA kernels and their plain
versions.

For tensors on a card the two entry points launch the kernels of
``csrc/micro_gather.cu``; for tensors on the CPU they run the plain
versions beside them.

- ``gather_taps`` replaces the Pallas functions of P6
  (``tools/micro_gather_kernel.py:_ohdot_kernel``, ``_take_kernel``,
  ``_takerow_kernel``): ``out[i, t] = bf16(sum_k f32(window[rel[i, t, k] //
  div]))``, summed in tap order. The one-hot kernel indexes ``rel // pack``
  (``div = pack``), the take kernels ``rel`` (``div = 1``).
- ``gather_rows`` replaces P7's ``tools/micro_gather2.py:kernel`` and
  ``kernel2``, which compute one function: ``out[n] = x[idx[n]]``, exact.

An index outside the table (or a negative ``rel``) reads a zero row in both
the kernels and the plain versions.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

SOURCE = cuda_build.CSRC / "micro_gather.cu"
MAX_WINDOW_BYTES = 227 * 1024  # shared memory a block can use on Hopper

_fns = {}
_launches = cuda_build.Launches("taps", "rows")


def launch_count(kind: str = "taps") -> int:
    """Launches of ``gather_taps`` (``taps``) or ``gather_rows`` (``rows``)
    since the last ``reset_launch_count``."""
    return _launches.counts[kind]


def reset_launch_count() -> None:
    _launches.reset()


def _load(kind: str):
    if kind not in _fns:
        n_ints = 6 if kind == "taps" else 3
        _fns[kind] = cuda_build.load(
            SOURCE, f"micro_gather_{kind}",
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * n_ints
            + [ctypes.c_void_p])
    return _fns[kind]


def _rows(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """table[index] with out-of-range indices as zero rows."""
    ok = (index >= 0) & (index < table.shape[0])
    got = table[torch.where(ok, index, 0).long()]
    return torch.where(ok[..., None], got, 0)


def gather_taps_plain(rel: torch.Tensor, window: torch.Tensor,
                      div: int) -> torch.Tensor:
    """f32 sums over the taps in tap order, rounded once to bf16."""
    idx = torch.where(rel >= 0, torch.div(rel, div, rounding_mode="floor"),
                      -1)
    acc = torch.zeros(rel.shape[:2] + window.shape[1:], dtype=torch.float32,
                      device=rel.device)
    for k in range(rel.shape[2]):
        acc += _rows(window, idx[:, :, k]).float()
    return acc.to(torch.bfloat16)


def gather_taps(rel: torch.Tensor, window: torch.Tensor,
                div: int) -> torch.Tensor:
    """rel int32 (n_tiles, T, K), window bf16 (R, L) with L a multiple of 8
    and at most 227 KB, contiguous, on one device; div >= 1. Returns bf16
    (n_tiles, T, L). On a CUDA device this launches the kernel (or raises);
    on the CPU it runs ``gather_taps_plain``."""
    if rel.dtype != torch.int32 or window.dtype != torch.bfloat16:
        raise TypeError("rel must be int32 and window bfloat16")
    if not (rel.is_contiguous() and window.is_contiguous()):
        raise ValueError("rel and window must be contiguous")
    if rel.dim() != 3 or window.dim() != 2:
        raise ValueError(f"rel (n_tiles, T, K) and window (R, L) expected, "
                         f"got {tuple(rel.shape)} and {tuple(window.shape)}")
    R, L = window.shape
    if L % 8 or R * L * 2 > MAX_WINDOW_BYTES or div < 1:
        raise ValueError(f"window ({R}, {L}) must have L % 8 == 0 and fit "
                         f"{MAX_WINDOW_BYTES} bytes; div={div} must be >= 1")
    if not cuda_build.on_card(rel, window):
        return gather_taps_plain(rel, window, div)
    cuda_build.check_aligned(window)
    n_tiles, T, K = rel.shape
    out = torch.empty((n_tiles, T, L), dtype=torch.bfloat16,
                      device=rel.device)
    stream = torch.cuda.current_stream(rel.device).cuda_stream
    cuda_build.check_launch(_load("taps")(
        rel.data_ptr(), window.data_ptr(), out.data_ptr(), n_tiles, T, K, R,
        L, div, stream), "micro_gather_taps")
    _launches.add("taps")
    return out


def gather_rows_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return _rows(x, idx)


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x bf16 (V, C) with C a multiple of 8, idx int32 (N,), contiguous, on
    one device. Returns bf16 (N, C), ``x[idx]``. On a CUDA device this
    launches the kernel (or raises); on the CPU it runs
    ``gather_rows_plain``."""
    if x.dtype != torch.bfloat16 or idx.dtype != torch.int32:
        raise TypeError("x must be bfloat16 and idx int32")
    if not (x.is_contiguous() and idx.is_contiguous()):
        raise ValueError("x and idx must be contiguous")
    if x.dim() != 2 or idx.dim() != 1 or x.shape[1] % 8:
        raise ValueError(f"x (V, C) with C % 8 == 0 and idx (N,) expected, "
                         f"got {tuple(x.shape)} and {tuple(idx.shape)}")
    if not cuda_build.on_card(x, idx):
        return gather_rows_plain(x, idx)
    cuda_build.check_aligned(x)
    V, C = x.shape
    out = torch.empty((idx.shape[0], C), dtype=torch.bfloat16,
                      device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    cuda_build.check_launch(_load("rows")(
        x.data_ptr(), idx.data_ptr(), out.data_ptr(), V, idx.shape[0], C,
        stream), "micro_gather_rows")
    _launches.add("rows")
    return out

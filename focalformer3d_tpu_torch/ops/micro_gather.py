"""Kernel B: the gather probes, hand-written CUDA kernels and their plain
versions.

For tensors on a card the two entry points launch the kernels of
``csrc/micro_gather.cu``; for tensors on the CPU they run the plain
versions beside them.

- ``gather_taps`` replaces the Pallas functions of P6
  (``tools/micro_gather_kernel.py:_ohdot_kernel``, ``_take_kernel``,
  ``_takerow_kernel``): ``out[i, t] = bf16(sum_k f32(window[rel[i, t, k] //
  div]))``, summed in tap order. The one-hot kernel indexes ``rel // pack``
  (``div = pack``), the take kernels ``rel`` (``div = 1``). Persistent
  blocks walk stages of rel rows; ``taps_plan`` picks the route: the window
  staged in shared memory once per block (``smem``), or its rows read from
  device memory (``global``) where it does not fit beside the stages.
- ``gather_rows`` replaces P7's ``tools/micro_gather2.py:kernel`` and
  ``kernel2``, which compute one function: ``out[n] = x[idx[n]]``, exact.
  ``rows_plan`` picks the route: lane groups sized to the row (``lanes``),
  or one bulk copy in and one out per row (``bulk``).

An index outside the table (or a negative ``rel``) reads a zero row in both
the kernels and the plain versions.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import cuda_build

SOURCE = cuda_build.CSRC / "micro_gather.cu"
SMEM_BYTES = 232_448  # shared memory a block can use on Hopper (227 KB)
MAX_WINDOW_BYTES = 227 * 1024  # the largest window gather_taps takes
MAX_TAPS = 4096  # taps per row of rel: two stages of a few rows must fit

TAPS_SMEM = 0  # the window in shared memory, behind it a zero row
TAPS_GLOBAL = 1  # window rows read from device memory (L2, L1)
TAPS_ROUTE_NAMES = {TAPS_SMEM: "smem", TAPS_GLOBAL: "global"}
TAPS_STAGE_ROWS = 64  # rel rows a stage holds, where they fit

ROWS_LANES = 0  # a group of lanes per row, sized to the row
ROWS_BULK = 1  # one lane per row: a bulk copy in, a bulk copy out
ROWS_ROUTE_NAMES = {ROWS_LANES: "lanes", ROWS_BULK: "bulk"}
BULK_BLOCK_BYTES = 64 * 1024  # row buffers of a bulk-route block

_fns = {}
_launches = cuda_build.Launches("taps", "rows")


def launch_count(kind: str = "taps") -> int:
    """Launches of ``gather_taps`` (``taps``) or ``gather_rows`` (``rows``)
    since the last ``reset_launch_count``."""
    return _launches.counts[kind]


def reset_launch_count() -> None:
    _launches.reset()


_ARGS = {  # the scalars of each C interface, after three pointers
    "taps": [ctypes.c_int] * 4 + [ctypes.c_uint, ctypes.c_int] * 2
    + [ctypes.c_int] * 3,
    "rows": [ctypes.c_int] * 6,
}


def _load(kind: str):
    if kind not in _fns:
        _fns[kind] = cuda_build.load(
            SOURCE, f"micro_gather_{kind}",
            [ctypes.c_void_p] * 3 + _ARGS[kind] + [ctypes.c_void_p])
    return _fns[kind]


def fast_div_magic(d: int) -> tuple:
    """(m, l) with n // d == (umulhi(m, n) + n) >> l for 0 <= n < 2**31
    (Granlund and Montgomery): l = ceil(log2 d), m = floor(2**32 (2**l -
    d) / d) + 1, which fits 32 bits. The kernel divides by it."""
    if d < 1:
        raise ValueError(f"d={d} must be >= 1")
    l = (d - 1).bit_length()
    return (2**32 * (2**l - d)) // d + 1, l


def taps_smem_bytes(route: int, R: int, L: int, K: int,
                    stage_rows: int) -> int:
    """Shared bytes of a gather_taps block: on ``smem`` the (R, L) window
    and one zero row, then two stages of ``stage_rows`` x K int32 indices,
    each rounded up to 16 bytes (``csrc/micro_gather.cu`` lays them out so).
    """
    window = (R + 1) * L * 2 if route == TAPS_SMEM else 0
    return window + 2 * 4 * (-(-stage_rows * K // 4) * 4)


def taps_plan(R: int, L: int, K: int, route: Optional[int] = None) -> dict:
    """The route and stage of gather_taps for an (R, L) window and K taps.

    ``smem`` where the window, its zero row and two stages of
    ``TAPS_STAGE_ROWS`` rows fit in a block's shared memory, else
    ``global``; ``route`` forces one (``smem`` raises where it does not
    fit). A stage holds ``TAPS_STAGE_ROWS`` rows, halved on the global
    route until two stages fit (at most ``MAX_TAPS`` taps). Returns the
    route's number and name, the stage rows and the shared bytes.

    Measured on an NVIDIA H100 80GB HBM3 at 700 W (``tools/kernel_times.py
    --kernels gather``, P6's 1024 tiles of 128 rows and 27 taps, both routes
    in one call): ``smem`` 0.0524 ms at W 256 and 0.0570 at W 512 (one
    block of 1024 threads per SM), ``global`` 0.0650 at both. Stages of 128
    rows gained 0-3%, of 32 rows lost 6%."""
    fits = taps_smem_bytes(TAPS_SMEM, R, L, K, TAPS_STAGE_ROWS) <= SMEM_BYTES
    if route is None:
        route = TAPS_SMEM if fits else TAPS_GLOBAL
    if route not in TAPS_ROUTE_NAMES:
        raise ValueError(f"route={route} is not a route of gather_taps")
    if route == TAPS_SMEM and not fits:
        raise ValueError(f"window ({R}, {L}) and two stages of "
                         f"{TAPS_STAGE_ROWS} x {K} indices exceed "
                         f"{SMEM_BYTES} bytes of shared memory")
    rows = TAPS_STAGE_ROWS
    while rows > 1 and taps_smem_bytes(route, R, L, K, rows) > SMEM_BYTES:
        rows //= 2
    smem = taps_smem_bytes(route, R, L, K, rows)
    if smem > SMEM_BYTES:
        raise ValueError(f"K={K} taps: two stages of one row exceed "
                         f"{SMEM_BYTES} bytes of shared memory")
    return {"route": route, "name": TAPS_ROUTE_NAMES[route],
            "stage_rows": rows, "smem_bytes": smem}


def rows_lanes(C: int) -> int:
    """Lanes that share one row of C bf16 values (C / 8 16-byte chunks):
    the least power of two that covers the chunks, at most a warp (which
    then loops over the row)."""
    lanes = 1
    while lanes < C // 8 and lanes < 32:
        lanes *= 2
    return lanes


def rows_route(C: int) -> int:
    """The route gather_rows takes at row width C: ``bulk`` from rows of
    256 bytes (C = 128) on, ``lanes`` below.

    Measured on an NVIDIA H100 80GB HBM3 at 700 W (``tools/kernel_times.py
    --kernels gather``: P7's 1.08 M rows from 64 MB tables, both routes in
    one call, CUDA-graph replay), ms at rows of 64 B / 128 B / 256 B / 512
    B / 1 KB / 2 KB / 4 KB: ``lanes`` 0.0561 / 0.0939 / 0.1782 / 0.3561 /
    0.6990 / 1.3734 / 2.7224, ``bulk`` 0.1144 / 0.1162 / 0.1766 / 0.3464
    / 0.6854 / 1.3622 / 2.7199; on the 4 MiB table (64 B rows) 0.0081
    against 0.0266. A bulk copy per row moves a wide row with one
    instruction; a narrow row is all per-row overhead (the mbarrier, two
    round trips), where a lane group keeps four rows in flight."""
    return ROWS_BULK if C >= 128 else ROWS_LANES


def rows_plan(C: int, route: Optional[int] = None) -> dict:
    """The route of gather_rows at row width C (``route`` forces one), the
    lanes a row takes on ``lanes`` and the rows a block takes on ``bulk``
    (as many as ``BULK_BLOCK_BYTES`` hold, 1-32)."""
    route = rows_route(C) if route is None else route
    if route not in ROWS_ROUTE_NAMES:
        raise ValueError(f"route={route} is not a route of gather_rows")
    return {"route": route, "name": ROWS_ROUTE_NAMES[route],
            "lanes": rows_lanes(C),
            "bulk_rows": max(1, min(32, BULK_BLOCK_BYTES // (2 * C)))}


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


def gather_taps(rel: torch.Tensor, window: torch.Tensor, div: int,
                route: Optional[int] = None) -> torch.Tensor:
    """rel int32 (n_tiles, T, K) with K <= ``MAX_TAPS``, window bf16 (R, L)
    with L a multiple of 8 and at most 227 KB, contiguous, on one device;
    div >= 1. Returns bf16 (n_tiles, T, L). On a CUDA device this launches
    the kernel on the route of ``taps_plan`` (``route`` forces one) or
    raises; on the CPU it runs ``gather_taps_plain``."""
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
    n_tiles, T, K = rel.shape
    if K > MAX_TAPS:
        raise ValueError(f"K={K} taps exceed {MAX_TAPS}")
    plan = taps_plan(R, L, K, route)
    if not cuda_build.on_card(rel, window):
        return gather_taps_plain(rel, window, div)
    cuda_build.check_aligned(window)
    out = torch.empty((n_tiles, T, L), dtype=torch.bfloat16,
                      device=rel.device)
    rows = plan["stage_rows"]
    vec16 = rel.data_ptr() % 16 == 0 and rows * K % 4 == 0
    stream = torch.cuda.current_stream(rel.device).cuda_stream
    cuda_build.check_launch(_load("taps")(
        rel.data_ptr(), window.data_ptr(), out.data_ptr(), n_tiles * T, K, R,
        L, *fast_div_magic(div), *fast_div_magic(L // 8), plan["route"],
        rows, int(vec16), stream), "micro_gather_taps")
    _launches.add("taps")
    return out


def gather_rows_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return _rows(x, idx)


def gather_rows(x: torch.Tensor, idx: torch.Tensor,
                route: Optional[int] = None) -> torch.Tensor:
    """x bf16 (V, C) with C a multiple of 8, idx int32 (N,), contiguous, on
    one device. Returns bf16 (N, C), ``x[idx]``. On a CUDA device this
    launches the kernel on the route of ``rows_plan`` (``route`` forces
    one) or raises; on the CPU it runs ``gather_rows_plain``."""
    if x.dtype != torch.bfloat16 or idx.dtype != torch.int32:
        raise TypeError("x must be bfloat16 and idx int32")
    if not (x.is_contiguous() and idx.is_contiguous()):
        raise ValueError("x and idx must be contiguous")
    if x.dim() != 2 or idx.dim() != 1 or x.shape[1] % 8:
        raise ValueError(f"x (V, C) with C % 8 == 0 and idx (N,) expected, "
                         f"got {tuple(x.shape)} and {tuple(idx.shape)}")
    V, C = x.shape
    plan = rows_plan(C, route)
    if not cuda_build.on_card(x, idx):
        return gather_rows_plain(x, idx)
    cuda_build.check_aligned(x)
    out = torch.empty((idx.shape[0], C), dtype=torch.bfloat16,
                      device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    cuda_build.check_launch(_load("rows")(
        x.data_ptr(), idx.data_ptr(), out.data_ptr(), V, idx.shape[0], C,
        plan["route"], plan["lanes"], plan["bulk_rows"], stream),
        "micro_gather_rows")
    _launches.add("rows")
    return out

"""Kernel C: the meta widening probe, a hand-written CUDA kernel and its plain
version.

``widen_meta9`` launches the kernel of ``csrc/micro_widen.cu`` for tensors
on a card and runs ``widen_meta9_plain`` (``widen_concat`` of
``tools/micro_meta9.py``, in torch ops) for tensors on the CPU. It replaces
the Pallas function ``tools/micro_meta9.py:_widen_kernel`` (P9): with ``mp``
the meta between W + 1 zero rows in front and 2W + 2 behind,

    out[r, 4t:4t+4] = mp[r + dy*W + dx],  t = 3*dy + dx,  r < n_col + W + 1

exactly. The port's rulebook builder (K2) reads the meta without this
widening; the probe measures what the TPU measured.

A block of the kernel writes a tile of ``tile_rows`` output rows, one
contiguous span, a warp 512 contiguous bytes at a time; ``widen_plan``
gives the launch.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import cuda_build

SOURCE = cuda_build.CSRC / "micro_widen.cu"
PASS_ROWS = 32  # rows a block's 288 threads (one 16-byte chunk each) cover
TILE_ROWS = 128  # output rows a block writes
DIRECT = 0  # the route: each chunk read from the meta through L1
ROUTE_NAMES = {DIRECT: "direct"}

_fn = None
_launches = cuda_build.Launches("widen")


def launch_count() -> int:
    """Kernel launches since the last ``reset_launch_count``."""
    return _launches.counts["widen"]


def reset_launch_count() -> None:
    _launches.reset()


def _load():
    global _fn
    if _fn is None:
        _fn = cuda_build.load(SOURCE, "micro_widen_meta9",
                              [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                              + [ctypes.c_void_p])
    return _fn


def widen_plan(n_meta: int, W: int, route: Optional[int] = None) -> dict:
    """The launch of ``widen_meta9`` for a meta of ``n_meta`` rows at grid
    width W: its route (``route`` forces one; ``direct`` is the only one),
    the tile rows, the grid of tiles that covers the n_meta + W output rows,
    and the block's shared bytes (none).

    Measured on an NVIDIA H100 80GB HBM3 at 700 W (``tools/kernel_times.py
    --kernels widen``, P9's L0 / L1 / L2): tiles of 128 rows 0.1154 /
    0.0274 / 0.0073 ms, of 256 rows 0.1182 / 0.0291 / 0.0075 (eight passes'
    loads in flight: 0.1183 / 0.0284 / 0.0074), of 512 rows 0.1221 / 0.0296
    / 0.0077; stores without the streaming hint 0.1160 / 0.0307 / 0.0085;
    the tile's three meta strips staged in shared memory by cp.async first
    0.1156 / 0.0276 / 0.0078 (L1 already serves the reuse)."""
    route = DIRECT if route is None else route
    if route not in ROUTE_NAMES:
        raise ValueError(f"route={route} is not a route of widen_meta9")
    return {"route": route, "name": ROUTE_NAMES[route],
            "tile_rows": TILE_ROWS, "grid": -(-(n_meta + W) // TILE_ROWS),
            "smem_bytes": 0}


def padded_meta(meta: torch.Tensor, W: int) -> torch.Tensor:
    """The meta between W + 1 zero rows in front and 2W + 2 behind."""
    z = meta.new_zeros
    return torch.cat([z((W + 1, 4)), meta, z((2 * W + 2, 4))])


def nine_slices(mp: torch.Tensor, W: int, n_rows: int):
    """The nine shifted row slices of the padded meta, (dy, dx) row-major."""
    return [mp[dy * W + dx:dy * W + dx + n_rows]
            for dy in range(3) for dx in range(3)]


def widen_meta9_plain(meta: torch.Tensor, W: int) -> torch.Tensor:
    """P9's ``widen_concat``: the nine slices concatenated on axis 1."""
    n_rows = meta.shape[0] + W
    return torch.cat(nine_slices(padded_meta(meta, W), W, n_rows), dim=1)


def widen_meta9(meta: torch.Tensor, W: int,
                route: Optional[int] = None) -> torch.Tensor:
    """meta int32 (n_col + 1, 4), contiguous; W >= 1. Returns int32
    (n_col + W + 1, 36). On a CUDA device this launches the kernel on the
    route of ``widen_plan`` (``route`` forces one) or raises; on the CPU it
    runs ``widen_meta9_plain``."""
    if meta.dtype != torch.int32:
        raise TypeError("meta must be int32")
    if meta.dim() != 2 or meta.shape[1] != 4 or not meta.is_contiguous():
        raise ValueError(f"meta must be a contiguous (n_col + 1, 4) tensor, "
                         f"got {tuple(meta.shape)}")
    if W < 1:
        raise ValueError(f"W={W} must be >= 1")
    plan = widen_plan(meta.shape[0], W, route)
    if not cuda_build.on_card(meta):
        return widen_meta9_plain(meta, W)
    cuda_build.check_aligned(meta)
    out = torch.empty((meta.shape[0] + W, 36), dtype=torch.int32,
                      device=meta.device)
    stream = torch.cuda.current_stream(meta.device).cuda_stream
    cuda_build.check_launch(_load()(
        meta.data_ptr(), out.data_ptr(), meta.shape[0], W, plan["tile_rows"],
        plan["grid"], stream), "micro_widen")
    _launches.add("widen")
    return out

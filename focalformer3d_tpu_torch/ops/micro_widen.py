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
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

SOURCE = cuda_build.CSRC / "micro_widen.cu"

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
                              [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                              + [ctypes.c_void_p])
    return _fn


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


def widen_meta9(meta: torch.Tensor, W: int) -> torch.Tensor:
    """meta int32 (n_col + 1, 4), contiguous; W >= 1. Returns int32
    (n_col + W + 1, 36). On a CUDA device this launches the kernel (or
    raises); on the CPU it runs ``widen_meta9_plain``."""
    if meta.dtype != torch.int32:
        raise TypeError("meta must be int32")
    if meta.dim() != 2 or meta.shape[1] != 4 or not meta.is_contiguous():
        raise ValueError(f"meta must be a contiguous (n_col + 1, 4) tensor, "
                         f"got {tuple(meta.shape)}")
    if W < 1:
        raise ValueError(f"W={W} must be >= 1")
    if not cuda_build.on_card(meta):
        return widen_meta9_plain(meta, W)
    cuda_build.check_aligned(meta)
    out = torch.empty((meta.shape[0] + W, 36), dtype=torch.int32,
                      device=meta.device)
    stream = torch.cuda.current_stream(meta.device).cuda_stream
    cuda_build.check_launch(_load()(
        meta.data_ptr(), out.data_ptr(), meta.shape[0], W, stream),
        "micro_widen")
    _launches.add("widen")
    return out

"""K2: the rulebook builder, a hand-written CUDA kernel and its plain version.

``plan_rules`` is the entry point. For tensors on a card it launches the
kernel of ``csrc/plan_builder.cu`` (replacing the TPU kernel
``focalformer3d_tpu/ops/plan_builder.py:_plan_kernel``); for tensors on the
CPU it runs ``plan_builder.decode_rules`` per sample. Both give the
absolute rulebook that the sparse-conv apply (K1) reads, equal to
``sparse_conv.build_conv_rules``:

    rules[b, k, j] = row_start[col] + popcount(zbits[col] & ((1 << zi) - 1))
                     for tap k of output site j where its z bit is set,
                     in_capacity elsewhere

The kernel is compiled at first use by ``cuda_build``.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from . import sparse_conv as sc
from .plan_builder import decode_rules

SOURCE = cuda_build.CSRC / "plan_builder.cu"

_fn = None
_launches = 0


def launch_count() -> int:
    """Kernel launches since the last ``reset_launch_count``."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def _load():
    global _fn
    if _fn is None:
        _fn = cuda_build.load(
            SOURCE, "plan_rules_forward",
            [ctypes.c_void_p] * 3 + [ctypes.POINTER(ctypes.c_int)]
            + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    return _fn


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
    if meta.device != colz.device:
        raise ValueError("meta and colz must be on one device")
    if not (meta.is_contiguous() and colz.is_contiguous()):
        raise ValueError("meta and colz must be contiguous")
    B, V_out = colz.shape
    if meta.shape != (B, H * W + 1, 4):
        raise ValueError(f"meta {tuple(meta.shape)} is not (B={B}, "
                         f"{H * W + 1}, 4) for the input grid {in_shape}")
    if D > 64:
        raise ValueError(f"z extent {D} > 64 (bitmask words)")
    if meta.device.type == "cpu":
        return torch.stack([
            decode_rules(colz[b], in_capacity, meta[b], kernel_size, stride,
                         padding, in_shape, out_w) for b in range(B)])
    if meta.device.type != "cuda":
        raise ValueError(f"unsupported device {meta.device}")
    if meta.data_ptr() % 16:
        raise ValueError("meta must be 16-byte aligned")
    geom = (ctypes.c_int * 13)(
        kz, ky, kx, *sc._as_triple(stride), *sc._as_triple(padding),
        D, H, W, out_w)
    fn = _load()
    rules = torch.empty((B, kz * ky * kx, V_out), dtype=torch.int32,
                        device=meta.device)
    stream = torch.cuda.current_stream(meta.device).cuda_stream
    cuda_build.check_launch(fn(
        meta.data_ptr(), colz.data_ptr(), rules.data_ptr(), geom, B, V_out,
        in_capacity, stream), "plan_rules")
    global _launches
    _launches += 1
    return rules

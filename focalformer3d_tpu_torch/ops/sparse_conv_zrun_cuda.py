"""K3: the z-run sparse-conv apply, a hand-written CUDA kernel and its plain
version.

``zrun_conv`` is the entry point. For tensors on a card it launches the
kernel of ``csrc/sparse_conv_zrun.cu`` (replacing the TPU kernel
``focalformer3d_tpu/ops/sparse_conv_zrun.py:_zkernel``); for tensors on the
CPU it runs ``sparse_conv_zrun.apply_conv_zrun_plain``. Both compute K1's
conv (``sparse_conv_cuda.sparse_conv``) over the rulebook that the z-run
codes of ``sparse_conv_zrun.build_zplan`` encode, with the same rounding.

The kernel is compiled at first use by ``cuda_build``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import cuda_build
from .sparse_conv_cuda import check_operands, pad_operands
from .sparse_conv_zrun import ZTAPS, apply_conv_zrun_plain

SOURCE = cuda_build.CSRC / "sparse_conv_zrun.cu"
MAX_C = 128  # 3C-wide A rows and 3C x Cout weights fit in shared memory

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
            SOURCE, "sparse_conv_zrun_forward",
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    return _fn


def zrun_conv(features: torch.Tensor, codes: torch.Tensor,
              weights: torch.Tensor, out_valid: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sparse conv apply from z-run codes, bf16 operands, f32 accumulation.

    features bf16 (B, V_in, C); codes int32 (B, ky*kx, V_out) from
    ``build_zplan``; weights bf16 (3*ky*kx, C, Cout), dz-major taps; bias
    f32 (Cout,) or None; out_valid bool (B, V_out); all contiguous, on one
    device. Returns f32 (B, V_out, Cout); inactive sites are zero. On a CUDA
    device this launches the kernel (or raises); on the CPU it runs
    ``apply_conv_zrun_plain`` with the same rounding."""
    check_operands(features, codes, weights, out_valid, bias, ZTAPS)
    if features.device.type == "cpu":
        return apply_conv_zrun_plain(features, codes, weights, out_valid,
                                     bias, torch.float32)
    if features.device.type != "cuda":
        raise ValueError(f"unsupported device {features.device}")
    c_out = weights.shape[2]
    features, weights, bias = pad_operands(features, weights, bias, MAX_C)
    B, V_in, C = features.shape
    C_out = weights.shape[2]
    R, V_out = codes.shape[1:]
    fn = _load()
    out = torch.empty((B, V_out, C_out), dtype=torch.float32,
                      device=features.device)
    stream = torch.cuda.current_stream(features.device).cuda_stream
    cuda_build.check_launch(fn(
        features.data_ptr(), codes.data_ptr(), weights.data_ptr(),
        bias.data_ptr() if bias is not None else None,
        out_valid.data_ptr(), out.data_ptr(), B, V_in, V_out, R, C, C_out,
        stream,
    ), "sparse_conv_zrun")
    global _launches
    _launches += 1
    return out if C_out == c_out else out[..., :c_out].contiguous()

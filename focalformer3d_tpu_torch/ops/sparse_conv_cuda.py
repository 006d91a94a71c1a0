"""K1: the sparse-conv apply, a hand-written CUDA kernel and its plain version.

``sparse_conv`` is the entry point. For tensors on a card it launches the
kernel of ``csrc/sparse_conv.cu`` (replacing the TPU kernel
``focalformer3d_tpu/ops/sparse_conv_pallas.py:_kernel``); for tensors on the
CPU it runs ``apply_conv_plain`` with the kernel's rounding. Both compute
``focalformer3d_tpu.ops.sparse_conv.apply_conv`` over absolute rulebooks:

    out[b, j] = out_valid[b, j] ? bias + sum_k feats[b, rules[b, k, j]] @ W[k]
                                : 0

The kernel is compiled with ``nvcc`` into ``focalformer3d_tpu_torch/_build/``
at first use (a few seconds; the library has a plain C interface and is
loaded with ``ctypes``), from the sources in this package only.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import cuda_build

SOURCE = cuda_build.CSRC / "sparse_conv.cu"
COUTS = (16, 32, 64, 128)
MAX_C = 256

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
            SOURCE, "sparse_conv_forward",
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    return _fn


def pad_channels(x: torch.Tensor, dim: int):
    """Zero-pad one channel dim to a multiple of 16 (C=5 -> 16)."""
    c = x.shape[dim]
    cp = -(-c // 16) * 16
    if cp == c:
        return x
    pad = [0, 0] * (x.dim() - 1 - dim % x.dim()) + [0, cp - c]
    return torch.nn.functional.pad(x, pad)


def apply_conv_plain(features: torch.Tensor, rules: torch.Tensor,
                     weights: torch.Tensor, out_valid: torch.Tensor,
                     bias: Optional[torch.Tensor] = None,
                     compute_dtype: torch.dtype = torch.float32
                     ) -> torch.Tensor:
    """Gather + matmul of ``sparse_conv.apply_conv``, batched.

    features (B, V_in, C); rules (B, K, V_out) with V_in as the miss
    sentinel; weights (K, C, Cout); out_valid (B, V_out). Operands are cast
    to ``compute_dtype`` and the result is returned in that dtype."""
    B, V_in, C = features.shape
    K, _, C_out = weights.shape
    V_out = rules.shape[2]
    fpad = torch.cat([features, features.new_zeros((B, 1, C))], dim=1)
    idx = rules.transpose(1, 2).reshape(B, V_out * K).long()
    g = torch.gather(fpad, 1, idx[..., None].expand(-1, -1, C))
    g = g.reshape(B, V_out, K * C).to(compute_dtype)
    acc = g @ weights.reshape(K * C, C_out).to(compute_dtype)
    if bias is not None:
        acc = acc + bias.to(compute_dtype)
    return torch.where(out_valid[..., None], acc, 0.0)


def check_operands(features, index, weights, out_valid, bias,
                   taps_per_entry: int = 1):
    """Dtype, device, contiguity and shape checks shared by the conv
    kernels' wrappers: ``index`` (B, R, V_out) int32 holds one entry per
    ``taps_per_entry`` taps of ``weights`` (K, C, Cout)."""
    dev = features.device
    if features.dtype != torch.bfloat16 or weights.dtype != torch.bfloat16:
        raise TypeError("features and weights must be bfloat16")
    if index.dtype != torch.int32 or out_valid.dtype != torch.bool:
        raise TypeError("rules must be int32 and out_valid bool")
    if bias is not None and bias.dtype != torch.float32:
        raise TypeError("bias must be float32")
    tensors = [features, index, weights, out_valid] + (
        [bias] if bias is not None else [])
    for t in tensors:
        if t.device != dev:
            raise ValueError("all operands must be on one device")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    if features.dim() != 3 or index.dim() != 3 or weights.dim() != 3:
        raise ValueError("features (B,V,C), rules (B,K,V_out), weights "
                         "(K,C,Cout) expected")
    B, _, C = features.shape
    K, Cw, C_out = weights.shape
    if (Cw != C or index.shape[0] != B
            or index.shape[1] * taps_per_entry != K):
        raise ValueError(f"shape mismatch: features {tuple(features.shape)}"
                         f" rules {tuple(index.shape)} weights "
                         f"{tuple(weights.shape)}")
    if out_valid.shape != (B, index.shape[2]):
        raise ValueError("out_valid must be (B, V_out)")
    if bias is not None and bias.shape != (C_out,):
        raise ValueError("bias must be (Cout,)")


def pad_operands(features, weights, bias, max_c: int):
    """Pad C to a multiple of 16 and Cout up to the next width in ``COUTS``,
    as the conv kernels take them (zero channels add nothing)."""
    c_out = weights.shape[2]
    if features.shape[2] > max_c or c_out > COUTS[-1]:
        raise ValueError(f"kernel takes C <= {max_c} and Cout <= "
                         f"{COUTS[-1]}; got C={features.shape[2]}, "
                         f"Cout={c_out}")
    cout_k = next(c for c in COUTS if c >= c_out)
    features = pad_channels(features, 2)
    weights = pad_channels(weights, 1)
    if cout_k != c_out:
        weights = torch.nn.functional.pad(weights, (0, cout_k - c_out))
        if bias is not None:
            bias = torch.nn.functional.pad(bias, (0, cout_k - c_out))
    for t in (features, weights):
        if t.data_ptr() % 16:
            raise ValueError("features and weights must be 16-byte aligned")
    return features, weights, bias


def sparse_conv(features: torch.Tensor, rules: torch.Tensor,
                weights: torch.Tensor, out_valid: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sparse conv apply with bf16 operands and f32 accumulation.

    features bf16 (B, V_in, C); rules int32 (B, K, V_out) of CSR positions
    with V_in as the miss sentinel; weights bf16 (K, C, Cout), dz-major
    taps; bias f32 (Cout,) or None; out_valid bool (B, V_out); all
    contiguous, on one device. Returns f32 (B, V_out, Cout); inactive
    sites are zero. C is zero-padded to a multiple of 16 and Cout to a
    width in ``COUTS`` here. On a CUDA device this launches the kernel (or
    raises); on the CPU it runs ``apply_conv_plain`` with the same
    rounding."""
    check_operands(features, rules, weights, out_valid, bias)
    if features.device.type == "cpu":
        return apply_conv_plain(features, rules, weights, out_valid,
                                bias, torch.float32)
    if features.device.type != "cuda":
        raise ValueError(f"unsupported device {features.device}")
    c_out = weights.shape[2]
    features, weights, bias = pad_operands(features, weights, bias, MAX_C)
    B, V_in, C = features.shape
    K, _, C_out = weights.shape
    V_out = rules.shape[2]
    fn = _load()
    out = torch.empty((B, V_out, C_out), dtype=torch.float32,
                      device=features.device)
    stream = torch.cuda.current_stream(features.device).cuda_stream
    cuda_build.check_launch(fn(
        features.data_ptr(), rules.data_ptr(), weights.data_ptr(),
        bias.data_ptr() if bias is not None else None,
        out_valid.data_ptr(), out.data_ptr(), B, V_in, V_out, K, C, C_out,
        stream,
    ), "sparse_conv")
    global _launches
    _launches += 1
    return out if C_out == c_out else out[..., :c_out].contiguous()

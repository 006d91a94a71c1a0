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
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "sparse_conv.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
COUTS = (16, 32, 64, 128)
MAX_C = 256

_lib = None
_launches = 0


def launch_count() -> int:
    """Kernel launches since the last ``reset_launch_count``."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the sparse-conv kernel")


def build() -> Path:
    """Compile the kernel library if this source has not been built yet.

    The library name carries a hash of the source and flags, so an edited
    source is never served by a stale build. Returns the library path."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    lib = BUILD_DIR / f"libsparse_conv_{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, lib)
    return lib


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.sparse_conv_forward
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def build_seconds() -> float:
    """Build (if needed) and load the library; returns the seconds taken."""
    t0 = time.perf_counter()
    _load()
    return time.perf_counter() - t0


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


def _check(features, rules, weights, out_valid, bias):
    dev = features.device
    if features.dtype != torch.bfloat16 or weights.dtype != torch.bfloat16:
        raise TypeError("features and weights must be bfloat16")
    if rules.dtype != torch.int32 or out_valid.dtype != torch.bool:
        raise TypeError("rules must be int32 and out_valid bool")
    if bias is not None and bias.dtype != torch.float32:
        raise TypeError("bias must be float32")
    tensors = [features, rules, weights, out_valid] + (
        [bias] if bias is not None else [])
    for t in tensors:
        if t.device != dev:
            raise ValueError("all operands must be on one device")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    if features.dim() != 3 or rules.dim() != 3 or weights.dim() != 3:
        raise ValueError("features (B,V,C), rules (B,K,V_out), weights "
                         "(K,C,Cout) expected")
    B, _, C = features.shape
    K, Cw, C_out = weights.shape
    if Cw != C or rules.shape[:2] != (B, K):
        raise ValueError(f"shape mismatch: features {tuple(features.shape)}"
                         f" rules {tuple(rules.shape)} weights "
                         f"{tuple(weights.shape)}")
    if out_valid.shape != (B, rules.shape[2]):
        raise ValueError("out_valid must be (B, V_out)")
    if bias is not None and bias.shape != (C_out,):
        raise ValueError("bias must be (Cout,)")


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
    _check(features, rules, weights, out_valid, bias)
    if features.device.type == "cpu":
        return apply_conv_plain(features, rules, weights, out_valid,
                                bias, torch.float32)
    if features.device.type != "cuda":
        raise ValueError(f"unsupported device {features.device}")
    c_out = weights.shape[2]
    if features.shape[2] > MAX_C or c_out > COUTS[-1]:
        raise ValueError(f"kernel takes C <= {MAX_C} and Cout <= "
                         f"{COUTS[-1]}; got C={features.shape[2]}, "
                         f"Cout={c_out}")
    # Cout is padded up to the next width the kernel is instantiated for
    cout_k = next(c for c in COUTS if c >= c_out)
    features = pad_channels(features, 2)
    weights = pad_channels(weights, 1)
    if cout_k != c_out:
        weights = torch.nn.functional.pad(weights, (0, cout_k - c_out))
        if bias is not None:
            bias = torch.nn.functional.pad(bias, (0, cout_k - c_out))
    B, V_in, C = features.shape
    K, _, C_out = weights.shape
    V_out = rules.shape[2]
    for t in (features, weights):
        if t.data_ptr() % 16:
            raise ValueError("features and weights must be 16-byte aligned")
    lib = _load()
    out = torch.empty((B, V_out, C_out), dtype=torch.float32,
                      device=features.device)
    stream = torch.cuda.current_stream(features.device).cuda_stream
    err = lib.sparse_conv_forward(
        features.data_ptr(), rules.data_ptr(), weights.data_ptr(),
        bias.data_ptr() if bias is not None else None,
        out_valid.data_ptr(), out.data_ptr(), B, V_in, V_out, K, C, C_out,
        stream,
    )
    if err != 0:
        raise RuntimeError(f"sparse_conv kernel launch failed: cudaError "
                           f"{err}")
    global _launches
    _launches += 1
    return out if cout_k == c_out else out[..., :c_out].contiguous()

"""K1: the sparse conv, forward and backward, as hand-written CUDA kernels.

``sparse_conv`` is the forward entry point. For tensors on a card it
launches the kernel of ``csrc/sparse_conv.cu`` (replacing the TPU kernel
``focalformer3d_tpu/ops/sparse_conv_pallas.py:_kernel``); for tensors on the
CPU it runs ``apply_conv_plain`` with the kernel's rounding. Both compute
``focalformer3d_tpu.ops.sparse_conv.apply_conv`` over absolute rulebooks:

    out[b, j] = out_valid[b, j] ? bias + sum_k feats[b, rules[b, k, j]] @ W[k]
                                : 0

``sparse_conv_train`` is the differentiable conv of the training path, a
``torch.autograd.Function`` that carries the JAX custom VJP
(``sparse_conv_pallas._conv_core``) with its rounding:

- forward: ``sparse_conv`` with the features and weights cast to bf16
  inside the Function, so the cotangents come back in the caller's dtype;
- dx: the same kernel on the transposed rulebook with ``W[K-1-k]^T`` and
  the cotangent cast to bf16 (``conv_dx``, counted apart from the forward);
- dW: the kernel of ``csrc/sparse_conv_wgrad.cu`` (``conv_wgrad``;
  ``dW[k] = sum_j bf16(x[rules[k, j]])^T g[j]``, g in f32, f32 sums),
  which replaces the TPU kernel's gather mode, the dot after it and the
  spill correction (``sparse_conv_pallas.py:726-767``);
- db: the sum of the masked cotangent.

Each kernel's plain version sits beside it and is what a CPU tensor gets.
The kernels are compiled with ``nvcc`` into ``focalformer3d_tpu_torch/_build/``
at first use (a few seconds each; plain C interfaces loaded with
``ctypes``), from the sources in this package only.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import cuda_build

SOURCE = cuda_build.CSRC / "sparse_conv.cu"
WGRAD_SOURCE = cuda_build.CSRC / "sparse_conv_wgrad.cu"
COUTS = (16, 32, 64, 128)
MAX_C = 256
WGRAD_BLOCKS = 2048  # target blocks per dW launch (taps x site slices)
WGRAD_CHUNK = 64  # sites per staged chunk (kChunk of the dW kernel)

_fn = None
_wgrad_fn = None
_launches = {"forward": 0, "dx": 0, "wgrad": 0}


def launch_count(kind: str = "forward") -> int:
    """Launches of one kernel use since the last ``reset_launch_count``:
    ``forward`` (K1), ``dx`` (K1 on a transposed rulebook) or ``wgrad``
    (the dW kernel)."""
    return _launches[kind]


def reset_launch_count() -> None:
    for k in _launches:
        _launches[k] = 0


def _load():
    global _fn
    if _fn is None:
        _fn = cuda_build.load(
            SOURCE, "sparse_conv_forward",
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    return _fn


def _load_wgrad():
    global _wgrad_fn
    if _wgrad_fn is None:
        _wgrad_fn = cuda_build.load(
            WGRAD_SOURCE, "sparse_conv_wgrad",
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    return _wgrad_fn


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


def _run_forward(features, rules, weights, out_valid, bias):
    """Launch the forward kernel (checked operands on a card)."""
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
    return out if C_out == c_out else out[..., :c_out].contiguous()


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return True


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
    if not _on_card(features):
        return apply_conv_plain(features, rules, weights, out_valid,
                                bias, torch.float32)
    out = _run_forward(features, rules, weights, out_valid, bias)
    _launches["forward"] += 1
    return out


def conv_dx(grad: torch.Tensor, rules_t: torch.Tensor,
            weights: torch.Tensor) -> torch.Tensor:
    """dx of the sparse conv: K1 on the transposed rulebook.

    grad f32 (B, V_out, Cout), already masked to the valid outputs;
    rules_t int32 (B, K, V_in) from ``sparse_conv.transpose_rules`` (V_out
    is its miss sentinel); weights bf16 (K, C, Cout). Returns f32
    (B, V_in, C): ``dx[i] = sum_k bf16(g[rules_t[k, i]]) @ W[K-1-k]^T``,
    which is ``sum_{k, j: rules[k, j] = i} g[j] @ W[k]^T``. The kernel's
    "C" is the forward's Cout and its "Cout" the forward's C."""
    g = grad.to(torch.bfloat16).contiguous()
    w_t = weights.flip(0).transpose(1, 2).contiguous()
    every = torch.ones(rules_t.shape[0], rules_t.shape[2], dtype=torch.bool,
                       device=g.device)
    check_operands(g, rules_t, w_t, every, None)
    if not _on_card(g):
        return apply_conv_plain(g, rules_t, w_t, every, None, torch.float32)
    out = _run_forward(g, rules_t, w_t, every, None)
    _launches["dx"] += 1
    return out


def wgrad_plain(features: torch.Tensor, grad: torch.Tensor,
                rules: torch.Tensor) -> torch.Tensor:
    """Plain version of the dW kernel: per tap, the gathered rows (misses
    as zero rows) in f32 against the f32 cotangent, summed over B and the
    sites. features (B, V_in, C), grad f32 (B, V_out, Cout), rules
    (B, K, V_out). Returns f32 (K, C, Cout)."""
    B, V_in, C = features.shape
    fpad = torch.cat([features.float(), features.new_zeros((B, 1, C),
                                                          dtype=torch.float32)],
                     dim=1)
    g2 = grad.float().reshape(-1, grad.shape[-1])
    taps = []
    for k in range(rules.shape[1]):
        idx = rules[:, k].long()[..., None].expand(-1, -1, C)
        taps.append(torch.gather(fpad, 1, idx).reshape(-1, C).T @ g2)
    return torch.stack(taps)


def conv_wgrad(features: torch.Tensor, grad: torch.Tensor,
               rules: torch.Tensor) -> torch.Tensor:
    """dW of the sparse conv with JAX's rounding.

    features bf16 (B, V_in, C); grad f32 (B, V_out, Cout), masked to the
    valid outputs; rules int32 (B, K, V_out). Returns f32 (K, C, Cout). On
    a CUDA device this launches the kernel of ``csrc/sparse_conv_wgrad.cu``
    (or raises); on the CPU it runs ``wgrad_plain``. C and Cout are
    zero-padded to widths in ``COUTS`` for the kernel."""
    if features.dtype != torch.bfloat16 or grad.dtype != torch.float32:
        raise TypeError("features must be bfloat16 and grad float32")
    if rules.dtype != torch.int32:
        raise TypeError("rules must be int32")
    for t in (grad, rules):
        if t.device != features.device:
            raise ValueError("all operands must be on one device")
    for t in (features, grad, rules):
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    if (features.dim() != 3 or rules.dim() != 3 or grad.dim() != 3
            or rules.shape[0] != features.shape[0]
            or grad.shape[:2] != (rules.shape[0], rules.shape[2])):
        raise ValueError(f"shape mismatch: features {tuple(features.shape)} "
                         f"grad {tuple(grad.shape)} rules "
                         f"{tuple(rules.shape)}")
    B, V_in, C = features.shape
    K, V_out = rules.shape[1], rules.shape[2]
    c_out = grad.shape[2]
    if not _on_card(features):
        return wgrad_plain(features, grad, rules)
    if C > COUTS[-1] or c_out > COUTS[-1]:
        raise ValueError(f"dW kernel takes C, Cout <= {COUTS[-1]}; got "
                         f"C={C}, Cout={c_out}")
    cp = next(c for c in COUTS if c >= C)
    op = next(c for c in COUTS if c >= c_out)
    x = torch.nn.functional.pad(features, (0, cp - C)) if cp != C \
        else features
    g = torch.nn.functional.pad(grad, (0, op - c_out)) if op != c_out \
        else grad
    if x.data_ptr() % 16 or g.data_ptr() % 16:
        raise ValueError("features and grad must be 16-byte aligned")
    n_chunks = max(1, -(-(B * V_out) // WGRAD_CHUNK))
    n_slices = min(n_chunks, -(-WGRAD_BLOCKS // K))
    partial = torch.empty((n_slices, K, cp, op), dtype=torch.float32,
                          device=x.device)
    dw = torch.empty((K, cp, op), dtype=torch.float32, device=x.device)
    fn = _load_wgrad()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    cuda_build.check_launch(fn(
        x.data_ptr(), g.data_ptr(), rules.data_ptr(), partial.data_ptr(),
        dw.data_ptr(), B, V_in, V_out, K, cp, op, n_slices, stream,
    ), "sparse_conv_wgrad")
    _launches["wgrad"] += 1
    return dw[:, :C, :c_out].contiguous() if (cp, op) != (C, c_out) else dw


class _SparseConvFn(torch.autograd.Function):
    """The JAX custom VJP of K1 (``sparse_conv_pallas.py:690-776``)."""

    @staticmethod
    def forward(ctx, features, weights, bias, rules, rules_t, out_valid):
        xb = features.to(torch.bfloat16).contiguous()
        wb = weights.to(torch.bfloat16).contiguous()
        out = sparse_conv(xb, rules, wb, out_valid, bias)
        ctx.save_for_backward(xb, wb, rules, rules_t, out_valid)
        ctx.dtypes = (features.dtype, weights.dtype)
        return out

    @staticmethod
    def backward(ctx, grad):
        xb, wb, rules, rules_t, out_valid = ctx.saved_tensors
        g = torch.where(out_valid[..., None], grad.float(), 0.0).contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = conv_dx(g, rules_t, wb).to(ctx.dtypes[0])
        if ctx.needs_input_grad[1]:
            dw = conv_wgrad(xb, g, rules).to(ctx.dtypes[1])
        if ctx.needs_input_grad[2]:
            db = g.sum((0, 1))
        return dx, dw, db, None, None, None


def sparse_conv_train(features: torch.Tensor, rules: torch.Tensor,
                      rules_t: torch.Tensor, weights: torch.Tensor,
                      out_valid: torch.Tensor,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable sparse conv on the kernels: features (B, V_in, C) and
    weights (K, C, Cout) in any float dtype (cast to bf16 inside), rules
    (B, K, V_out) and their transpose rules_t (B, K, V_in), out_valid
    (B, V_out), bias f32 (Cout,) or None. Returns f32 (B, V_out, Cout)."""
    return _SparseConvFn.apply(features, weights, bias, rules, rules_t,
                               out_valid)


def _round_bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16 values (kept in f32), with an identity gradient."""
    return t + (t.to(torch.bfloat16).float() - t).detach()


class _RoundGradBf16(torch.autograd.Function):
    """Identity whose backward rounds the cotangent to bf16 values."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def apply_conv_bf16_plain(features, rules, weights, out_valid, bias=None):
    """The plain version of ``sparse_conv_train``: autograd through
    ``apply_conv_plain`` with the kernels' rounding. Forward, dW and db see
    bf16-rounded features and weights against the f32 cotangent; dx comes
    from a second, value-free copy of the conv (``y2 - y2.detach()`` adds
    exact zeros) whose cotangent is rounded to bf16, as the dx kernel's is.
    Returns f32 (B, V_out, Cout)."""
    xb, wb = _round_bf16(features.float()), _round_bf16(weights.float())
    y = apply_conv_plain(xb.detach(), rules, wb, out_valid, bias,
                         torch.float32)
    if xb.requires_grad:
        y2 = _RoundGradBf16.apply(apply_conv_plain(
            xb, rules, wb.detach(), out_valid, None, torch.float32))
        y = y + (y2 - y2.detach())
    return y

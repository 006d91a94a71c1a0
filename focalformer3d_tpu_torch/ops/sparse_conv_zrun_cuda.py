"""K3: the z-run sparse-conv apply, a hand-written CUDA kernel and its plain
version.

``zrun_conv`` is the entry point. For tensors on a card it launches the
kernel of ``csrc/sparse_conv_zrun.cu`` (replacing the TPU kernel
``focalformer3d_tpu/ops/sparse_conv_zrun.py:_zkernel``); for tensors on the
CPU it runs ``sparse_conv_zrun.apply_conv_zrun_plain``. Both compute K1's
conv (``sparse_conv_cuda.sparse_conv``) over the rulebook that the z-run
codes of ``sparse_conv_zrun.build_zplan`` encode, with the same rounding.

The kernel is K1's (``csrc/sparse_conv_tile.cuh``) reading codes: a stage
holds the three z taps of one BEV tap, a 3C-deep contraction. Host-side
parts, each with a version the CPU runs: ``pack_zrun_weights`` (W as the
kernel's shared-memory image; ``unpack_zrun_weights`` inverts it),
``zrun_hit_shares`` (``hit_shares`` over codes) and ``route_for`` (K1's
choice per width). The kernel is compiled at first use by ``cuda_build``.

``zrun_conv_train`` is the differentiable conv of the ``cuda_zrun``
training path, the JAX custom VJP ``sparse_conv_zrun._zconv_core``: K3
forward on the bf16-rounded operands, and K1's backward
(``sparse_conv_cuda._SparseConvFn``'s) on the rulebook the codes encode
(``sparse_conv_zrun.zrun_rules``, taps dz-major as K3's weights, so dW
comes back in their layout): dx is K1 on its transpose, dW the dW kernel
on it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import cuda_build
from . import sparse_conv_cuda as k1
from .sparse_conv_cuda import check_operands, pad_operands
from .sparse_conv_zrun import ZTAPS, apply_conv_zrun_plain

SOURCE = cuda_build.CSRC / "sparse_conv_zrun.cu"
MAX_C = 128  # channels per tap of one launch
MAX_BEV = k1.MAX_TAPS // ZTAPS  # one mask bit per (BEV tap, z tap)
route_for = k1.route_for  # the instruction per width, as K1 takes it

_fn = None
_grid_fn = None
_launches = cuda_build.Launches("zrun")


def launch_count() -> int:
    """Kernel launches since the last ``reset_launch_count``."""
    return _launches.counts["zrun"]


def reset_launch_count() -> None:
    _launches.reset()


def _load():
    global _fn
    if _fn is None:
        _fn = cuda_build.load(
            SOURCE, "sparse_conv_zrun_forward",
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    return _fn


def _load_grid():
    global _grid_fn
    if _grid_fn is None:
        _grid_fn = cuda_build.load(
            SOURCE, "sparse_conv_zrun_grid",
            [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)])
    return _grid_fn


def pack_zrun_weights(weights: torch.Tensor) -> torch.Tensor:
    """W (3R, C, Cout), dz-major taps, as the kernel keeps it: (R, 3 C / 16,
    Cout, 16), per BEV tap r the images of ``sparse_conv_cuda.pack_weights``
    of W[r], W[R + r], W[2R + r] one after the other, so the K-blocks of z
    tap dz are blocks dz * C / 16 .. of a 3C-deep operand."""
    K, C, c_out = weights.shape
    if K % ZTAPS:
        raise ValueError(f"z-run weights need 3R taps; got {K}")
    R = K // ZTAPS
    by_bev = weights.reshape(ZTAPS, R, C, c_out).transpose(0, 1)
    return k1.pack_weights(by_bev.reshape(K, C, c_out)).reshape(
        R, ZTAPS * C // 16, c_out, 16)


def unpack_zrun_weights(packed: torch.Tensor) -> torch.Tensor:
    """The (3R, C, Cout) tensor that ``pack_zrun_weights`` packed."""
    R, J, c_out, _ = packed.shape
    C = J * 16 // ZTAPS
    taps = k1.unpack_weights(packed.reshape(R * ZTAPS, C // 16, c_out, 16))
    return taps.reshape(R, ZTAPS, C, c_out).transpose(0, 1).reshape(
        ZTAPS * R, C, c_out)


def zrun_hit_shares(codes: torch.Tensor) -> dict:
    """``sparse_conv_cuda.hit_shares`` over codes (B, R, V_out): the share
    of (128-site tile, BEV tap), (64-row group, BEV tap), (16-row strip,
    BEV tap) and (site, BEV tap) pairs where some code has a z tap."""
    return k1.hit_shares_of((codes & 7) != 0)


@functools.lru_cache(maxsize=256)
def _grid(B: int, V_out: int, R: int, C: int, c_out: int, route: int):
    """(persistent blocks, stages, W resident, shared bytes, z taps per
    stage) of one conv on the current card."""
    info = (ctypes.c_int * 4)()
    grid = _load_grid()(B, V_out, R, C, c_out, route, info)
    if grid <= 0:
        raise RuntimeError(f"sparse_conv_zrun_grid failed: cudaError {-grid}"
                           f" for R={R}, C={C}, Cout={c_out}")
    return grid, info[0], bool(info[1]), info[2], info[3]


def launch_plan(B: int, V_out: int, R: int, C: int, c_out: int,
                route: Optional[int] = None) -> dict:
    """What one launch at kernel widths does on the current card: its
    route, persistent grid, pipeline stages, whether W stays in shared
    memory, the shared bytes a block takes and the z taps a stage holds."""
    route = route_for(C, c_out) if route is None else route
    grid, stages, resident, smem, tps = _grid(B, V_out, R, C, c_out, route)
    return {"route": k1.ROUTE_NAMES[route], "grid": grid, "stages": stages,
            "w_resident": resident, "smem_bytes": smem, "z_per_stage": tps}


def zrun_conv(features: torch.Tensor, codes: torch.Tensor,
              weights: torch.Tensor, out_valid: torch.Tensor,
              bias: Optional[torch.Tensor] = None, *,
              route: Optional[int] = None) -> torch.Tensor:
    """Sparse conv apply from z-run codes, bf16 operands, f32 accumulation.

    features bf16 (B, V_in, C); codes int32 (B, ky*kx, V_out) from
    ``build_zplan``; weights bf16 (3*ky*kx, C, Cout), dz-major taps; bias
    f32 (Cout,) or None; out_valid bool (B, V_out); all contiguous, on one
    device. Returns f32 (B, V_out, Cout); inactive sites are zero. On a CUDA
    device this launches the kernel (or raises) on ``route_for``'s route,
    or on ``route`` (``ROUTE_WGMMA`` / ``ROUTE_MMA_SYNC`` of
    ``sparse_conv_cuda``) where given; on the CPU it runs
    ``apply_conv_zrun_plain`` with the same rounding."""
    if route not in (None, *k1.ROUTE_NAMES):
        raise ValueError(f"route={route} is not a route of the kernel")
    check_operands(features, codes, weights, out_valid, bias, ZTAPS)
    if not cuda_build.on_card(features):
        return apply_conv_zrun_plain(features, codes, weights, out_valid,
                                     bias, torch.float32)
    if codes.shape[1] > MAX_BEV:
        raise ValueError(f"kernel takes at most {MAX_BEV} BEV taps; got "
                         f"{codes.shape[1]}")
    c_out = weights.shape[2]
    features, weights, bias = pad_operands(features, weights, bias, MAX_C)
    B, V_in, C = features.shape
    C_out = weights.shape[2]
    R, V_out = codes.shape[1:]
    out = torch.empty((B, V_out, C_out), dtype=torch.float32,
                      device=features.device)
    if B == 0 or V_out == 0:
        return out[..., :c_out]
    route = route_for(C, C_out) if route is None else route
    grid = _grid(B, V_out, R, C, C_out, route)[0]
    packed = pack_zrun_weights(weights)
    stream = torch.cuda.current_stream(features.device).cuda_stream
    cuda_build.check_launch(_load()(
        features.data_ptr(), codes.data_ptr(), packed.data_ptr(),
        bias.data_ptr() if bias is not None else None,
        out_valid.data_ptr(), out.data_ptr(), B, V_in, V_out, R, C, C_out,
        route, grid, stream,
    ), "sparse_conv_zrun")
    _launches.add("zrun")
    return out if C_out == c_out else out[..., :c_out].contiguous()


class _ZrunConvFn(torch.autograd.Function):
    """The JAX custom VJP of K3 (``sparse_conv_zrun.py:558-582``): K3
    forward, K1's dx and dW (``_SparseConvFn.backward``)."""

    @staticmethod
    def forward(ctx, features, weights, bias, codes, rules, rules_t,
                out_valid):
        xb = features.to(torch.bfloat16).contiguous()
        wb = weights.to(torch.bfloat16).contiguous()
        out = zrun_conv(xb, codes, wb, out_valid, bias)
        ctx.save_for_backward(xb, wb, rules, rules_t, out_valid)
        ctx.dtypes = (features.dtype, weights.dtype)
        return out

    @staticmethod
    def backward(ctx, grad):
        return (*k1._SparseConvFn.backward(ctx, grad)[:3], None, None, None,
                None)


def zrun_conv_train(features: torch.Tensor, codes: torch.Tensor,
                    rules: torch.Tensor, rules_t: torch.Tensor,
                    weights: torch.Tensor, out_valid: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable z-run sparse conv on the kernels: features (B, V_in,
    C) and weights (3R, C, Cout), dz-major, in any float dtype (cast to
    bf16 inside); codes (B, R, V_out) from ``build_zplan``; ``rules`` (B,
    3R, V_out) the rulebook they encode (``zrun_rules(codes, V_in)``) and
    ``rules_t`` (B, 3R, V_in) its ``sparse_conv.transpose_rules`` (a
    submanifold rulebook is its own), as
    ``sparse_encoder.backward_index`` builds them; out_valid (B, V_out);
    bias f32 (Cout,) or None. Returns f32 (B, V_out, Cout). Its plain
    version is ``sparse_conv_cuda.apply_conv_bf16_plain`` on ``rules``."""
    return _ZrunConvFn.apply(features, weights, bias, codes, rules, rules_t,
                             out_valid)

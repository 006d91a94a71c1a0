"""k x k local-window attention on 2D maps (the ``bevfusion`` neck's
``P_IML``).

Port of ``focalformer3d_tpu/ops/local_attn.py`` (``local_attention``).
``local_attention`` takes its path from its operands:

- on the CPU, the plain version ``local_attention_plain``: plain torch ops,
  the key and value maps zero-padded by k // 2 once and each of the k^2
  window offsets reading a shifted view of them, so the peak footprint is
  (..., H, W, k^2) logits rather than (..., H, W, k^2, C) gathered keys;
  out-of-image neighbours get the logit -1e9 before the softmax, as in JAX;
- on a card, the hand-written kernel of ``csrc/local_attn.cu``
  (``local_attention_cuda``: logits, softmax and weighted sum in one
  launch, float32 inside, the output rounded once), inside the autograd
  Function ``LocalAttention`` where a gradient is needed: its forward also
  writes the float32 softmax weights, and its backward is torch ops over
  them (``local_attention_backward``).

The kernel takes bfloat16 or float32 maps whose channels fill 16-byte
chunks, kernel sizes 3 to 9 (odd), and as many channels as its block's
shared memory holds (``smem_bytes``); the wrapper raises on anything else.
It is compiled at first use by ``cuda_build``.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from . import cuda_build

SOURCE = cuda_build.CSRC / "local_attn.cu"
KERNEL_SIZES = (3, 5, 7, 9)
TILE = 8  # output positions a block takes along H and W (kTile)
MAX_SMEM = 232448  # bytes of shared memory a block may use on the card
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_fns: dict = {}
_launches = cuda_build.Launches("forward")


def launch_count() -> int:
    """Kernel launches since the last ``reset_launch_count``."""
    return _launches.counts["forward"]


def reset_launch_count() -> None:
    _launches.reset()


def smem_bytes(channels: int, itemsize: int, kernel_size: int) -> int:
    """A block's shared memory (``smem_bytes`` of the source): the k halo
    (later the v halo) and the q tile in 16-byte chunks, one chunk of
    padding a position and a row, and the tile's float32 logits."""
    nc = channels * itemsize // 16
    pos = nc + 1
    halo = TILE + kernel_size - 1
    chunks = halo * (halo * pos + 1) + TILE * (TILE * pos + 1)
    return 16 * chunks + 4 * TILE * TILE * kernel_size ** 2


def check_operands(query: torch.Tensor, key: torch.Tensor,
                   value: torch.Tensor, kernel_size: int) -> None:
    """Raise for operands the kernel does not take."""
    if kernel_size not in KERNEL_SIZES:
        raise ValueError(f"kernel_size {kernel_size}: the kernel takes "
                         f"{KERNEL_SIZES}")
    if not query.dtype == key.dtype == value.dtype \
            or query.dtype not in _DTYPES:
        raise TypeError(f"query, key and value must be one of "
                        f"{tuple(_DTYPES)}, not {query.dtype}, {key.dtype}, "
                        f"{value.dtype}")
    if query.dim() < 3 or not query.shape == key.shape == value.shape:
        raise ValueError(f"query {tuple(query.shape)}, key "
                         f"{tuple(key.shape)} and value {tuple(value.shape)}"
                         " must be one (..., H, W, C) shape")
    c, itemsize = query.shape[-1], query.element_size()
    if c == 0 or c * itemsize % 16:
        raise ValueError(f"C {c} does not fill 16-byte chunks of "
                         f"{query.dtype}")
    if smem_bytes(c, itemsize, kernel_size) > MAX_SMEM:
        raise ValueError(f"C {c} of {query.dtype} at kernel_size "
                         f"{kernel_size} needs more than {MAX_SMEM} bytes "
                         "of shared memory a block")


def local_attention_cuda(query: torch.Tensor, key: torch.Tensor,
                         value: torch.Tensor, kernel_size: int = 9,
                         weights: bool = False):
    """The kernel: (out (..., H, W, C) in the operands' dtype, the float32
    softmax weights (..., H, W, k^2) where ``weights``, else None). Raises
    for operands off a card or that the kernel does not take."""
    if not cuda_build.on_card(query, key, value):
        raise ValueError("local_attention_cuda needs operands on a card")
    check_operands(query, key, value, kernel_size)
    q, k, v = (t.contiguous() for t in (query, key, value))
    *lead, H, W, C = q.shape
    out = torch.empty_like(q)
    w = (torch.empty((*lead, H, W, kernel_size ** 2), dtype=torch.float32,
                     device=q.device) if weights else None)
    cuda_build.check_aligned(q, k, v, out)
    if "forward" not in _fns:
        _fns["forward"] = cuda_build.load(SOURCE, "local_attn_forward",
                                          _ARGTYPES)
    cuda_build.check_launch(_fns["forward"](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if w is None else w.data_ptr(), math.prod(lead), H, W, C,
        kernel_size, _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream), "local_attention")
    _launches.add("forward")
    return out, w


class LocalAttention(torch.autograd.Function):
    """The kernel's forward, keeping its softmax weights, and the backward
    of ``local_attention_backward``."""

    @staticmethod
    def forward(ctx, query, key, value, kernel_size):
        out, w = local_attention_cuda(query, key, value, kernel_size,
                                      weights=True)
        ctx.save_for_backward(query, key, value, w)
        ctx.kernel_size = kernel_size
        return out

    @staticmethod
    def backward(ctx, dout):
        query, key, value, w = ctx.saved_tensors
        return (*local_attention_backward(dout, query, key, value, w,
                                          ctx.kernel_size), None)


def local_attention(query: torch.Tensor, key: torch.Tensor,
                    value: torch.Tensor, kernel_size: int = 9
                    ) -> torch.Tensor:
    """query, key, value (..., H, W, C) -> (..., H, W, C).

    logits[p, d] = <query[p], key[p + d]>; out[p] = sum_d softmax_d(logits)
    * value[p + d], over the kernel_size^2 offsets d in row-major order
    (dy, then dx). On a card the kernel (through ``LocalAttention`` where a
    gradient is needed); on the CPU ``local_attention_plain``."""
    if not cuda_build.on_card(query, key, value):
        return local_attention_plain(query, key, value, kernel_size)
    if torch.is_grad_enabled() and (query.requires_grad or key.requires_grad
                                    or value.requires_grad):
        return LocalAttention.apply(query, key, value, kernel_size)
    return local_attention_cuda(query, key, value, kernel_size)[0]


def local_attention_plain(query: torch.Tensor, key: torch.Tensor,
                          value: torch.Tensor, kernel_size: int = 9
                          ) -> torch.Tensor:
    """``local_attention``'s plain version, on any device."""
    H, W = query.shape[-3], query.shape[-2]
    r = kernel_size // 2
    pad = (0, 0, r, r, r, r)  # C, then W, then H
    kp = F.pad(key, pad)
    vp = F.pad(value, pad)
    offsets = [(dy, dx) for dy in range(kernel_size)
               for dx in range(kernel_size)]
    logits = torch.stack(
        [(query * kp[..., dy:dy + H, dx:dx + W, :]).sum(-1)
         for dy, dx in offsets], dim=-1)
    ones = F.pad(query.new_ones((H, W)), (r, r, r, r))
    valid = torch.stack([ones[dy:dy + H, dx:dx + W] > 0.5
                         for dy, dx in offsets], dim=-1)
    logits = torch.where(valid, logits, logits.new_tensor(-1e9))
    w = torch.softmax(logits, dim=-1)
    out = torch.zeros_like(value)
    for i, (dy, dx) in enumerate(offsets):
        out = out + vp[..., dy:dy + H, dx:dx + W, :] * w[..., i:i + 1]
    return out


def local_attention_backward(dout: torch.Tensor, query: torch.Tensor,
                             key: torch.Tensor, value: torch.Tensor,
                             weights: torch.Tensor, kernel_size: int = 9):
    """(dquery, dkey, dvalue) of ``local_attention`` from its softmax
    weights (..., H, W, k^2), on any device, in the weights' precision
    (float32 at least), returned in the operands' dtypes:

        dw[p, d] = <dout[p], value[p + d]>
        dlogits  = w * (dw - sum_d w * dw)
        dquery[p]     = sum_d dlogits[p, d] * key[p + d]
        dkey[p + d]  += dlogits[p, d] * query[p]
        dvalue[p + d] += w[p, d] * dout[p]

    An out-of-image neighbour's weight is 0, so it takes no gradient."""
    H, W = query.shape[-3], query.shape[-2]
    r = kernel_size // 2
    pad = (0, 0, r, r, r, r)
    dt = torch.promote_types(weights.dtype, torch.float32)
    w = weights.to(dt)
    g, q = dout.to(dt), query.to(dt)
    kp, vp = F.pad(key.to(dt), pad), F.pad(value.to(dt), pad)
    offsets = [(dy, dx) for dy in range(kernel_size)
               for dx in range(kernel_size)]
    dw = torch.stack([(g * vp[..., dy:dy + H, dx:dx + W, :]).sum(-1)
                      for dy, dx in offsets], dim=-1)
    dl = w * (dw - (w * dw).sum(-1, keepdim=True))
    dq = torch.zeros_like(q)
    dkp, dvp = torch.zeros_like(kp), torch.zeros_like(vp)
    for i, (dy, dx) in enumerate(offsets):
        win = (..., slice(dy, dy + H), slice(dx, dx + W), slice(None))
        dq += dl[..., i:i + 1] * kp[win]
        dkp[win] += dl[..., i:i + 1] * q
        dvp[win] += w[..., i:i + 1] * g
    crop = (..., slice(r, r + H), slice(r, r + W), slice(None))
    return (dq.to(query.dtype), dkp[crop].to(key.dtype),
            dvp[crop].to(value.dtype))

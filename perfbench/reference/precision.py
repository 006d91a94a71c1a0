"""The control: the reference computed one step below the stated precision.

A part stated in bfloat16 is computed with every product's operands
rounded to float8 (e4m3, one scale per tensor from its largest magnitude,
as fp8 inference scales them); a part stated in float32 with TF32 off is
computed with TF32 on. ``control(model, fp8, exempt)`` runs the block so:
the modules named in ``fp8`` (and what they call, but for the modules
named in ``exempt`` inside them) round their operands, everything else
runs with TF32 allowed. The rounding passes the
gradient straight through, so a training step can run under it.
``control(..., round_to=round_bf16, tf32=False)`` is no control: it puts
the stated bfloat16 rounding of a part computed in float32 (the sparse
convs' operands in training) into the reference, for the look that
``calibrate.py --look`` makes.
"""
from __future__ import annotations

import contextlib
from typing import Iterable, Iterator

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_map

E4M3_MAX = 448.0
_PRODUCTS = {F.conv2d, F.conv3d, F.linear, torch.matmul, torch.mm, torch.bmm,
             torch.einsum, torch.baddbmm, torch.addmm,
             torch.Tensor.__matmul__, torch.Tensor.matmul, torch.Tensor.mm,
             torch.Tensor.bmm, F.scaled_dot_product_attention}


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` on the e4m3 grid of its own scale, in its dtype; the gradient
    passes through unchanged."""
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
    q = ((x.detach().float() / scale).to(torch.float8_e4m3fn).float()
         * scale).to(x.dtype)
    return x + (q - x).detach()


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16, in its dtype; the gradient passes
    through unchanged."""
    return x + (x.detach().to(torch.bfloat16).to(x.dtype) - x).detach()


class _RoundedProducts(TorchFunctionMode):
    def __init__(self, round_to):
        super().__init__()
        self.depth = 0
        self.round_to = round_to

    def _quantize(self, a):
        if (torch.is_tensor(a) and a.is_floating_point() and a.dim() >= 2
                and a.numel()):
            return self.round_to(a)
        return a

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.depth > 0 and func in _PRODUCTS:
            args, kwargs = tree_map(self._quantize, (args, kwargs))
        return func(*args, **kwargs)


@contextlib.contextmanager
def control(model: torch.nn.Module, fp8: Iterable[str],
            exempt: Iterable[str] = (), round_to=round_fp8,
            tf32: bool = True) -> Iterator[None]:
    mode = _RoundedProducts(round_to)
    handles = []
    fp8, exempt = tuple(fp8), tuple(exempt)

    def step(d):
        def hook(*_):
            mode.depth += d
        return hook

    for name, mod in model.named_modules():
        if name in fp8 or name in exempt:
            d = 1 if name in fp8 else -1000
            handles.append(mod.register_forward_pre_hook(step(d)))
            handles.append(mod.register_forward_hook(step(-d)))
    missing = set(fp8 + exempt) - {n for n, _ in model.named_modules()}
    if missing:
        raise ValueError(f"no module {sorted(missing)} in the model")
    b = torch.backends
    saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32)
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = tf32
    try:
        with mode:
            yield
    finally:
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = saved
        for h in handles:
            h.remove()

"""P1: the product ceiling and K1's phase split, on the H100.

The TPU probe (``tools/micro_mxu_probe.py``) had two parts.

1. ``probe_matmuls``: ``jnp.dot`` rates at the shapes of the one-hot and
   weight products and at a large aligned product (the chip's ceiling),
   then ``gk`` (P1a): one product per step of a 600-step Pallas grid, every
   step writing the same output block. Here ``torch.matmul`` gives the
   rates, and kernel A (``ops/micro_dot.py``) runs ``gk``: 600 blocks of
   (2304, 64) @ (64, 128), the last one storing, beside one
   ``torch.matmul`` over the same (600, 2304, 64) operand.
2. ``probe_kernel`` (P1b, ``_variant_kernel``): copies of the production
   kernel with phases switched off, at levels L0-L2 of ``make_level``. Its
   modes ``full``, ``pertap``, ``dbuf`` and ``merged`` stage the same
   function differently on the TPU; on the card they are one launch, K1's
   probe in full mode (``ops/sparse_conv_cuda.sparse_conv_probe``), timed
   beside production K1 and equal to it bit for bit. ``oh_only`` (the
   one-hot build alone) is the gather only; ``dots_only`` (products on a
   one-hot nothing wrote) is the product only, on a zeroed tile. The mode
   with neither (``only copy`` of P5) completes the split. One more row
   per level runs the full conv on the instruction route production K1 did
   not choose at that width.

    python -m focalformer3d_tpu_torch.tools.micro_mxu_probe
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import micro_dot
from ..ops import sparse_conv_cuda as k1
from . import _common
from .micro_dotshape import dot_case, operands

# tools/micro_mxu_probe.py:54-67, (M, K, N)
MATMUL_SHAPES = ((8192, 1024, 1024), (2304, 64, 128), (2304, 128, 128),
                 (2304, 256, 128), (256, 1152, 128), (256, 1152, 16),
                 (4608, 64, 128), (512, 1152, 128))
GK = (600, 2304, 64, 128)  # (tiles, M, K, N), tools/micro_mxu_probe.py:80-81
SMALL_MATMUL = ((64, 32, 32), (32, 16, 16))
SMALL_GK = (4, 32, 16, 32)
MODES = (("full = pertap = dbuf = merged", k1.PHASE_FULL),
         ("oh_only -> gather only", k1.PHASE_GATHER),
         ("dots_only -> product only", k1.PHASE_MMA),
         ("neither (P5's only copy)", 0))


def run(device: torch.device, size: str = "full") -> list:
    full = size == "full"
    rows = []
    rng = np.random.default_rng(0)
    for m, k, n in MATMUL_SHAPES if full else SMALL_MATMUL:
        a = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32))
        b = torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32))
        a, b = (t.to(device).to(torch.bfloat16) for t in (a, b))
        rows.append(_common.op_case(
            device, "P1a", f"({m}, {k}) @ ({k}, {n})", op="torch.matmul",
            fn=lambda a=a, b=b: torch.matmul(a, b),
            nbytes=(m * k + k * n + m * n) * 2, flops=2 * m * k * n,
            rate=(2 * m * k * n, 1e12, "TFLOP/s")))

    tiles, m, k, n = GK if full else SMALL_GK
    a, b = operands(1, tiles, m, k, n)
    a = torch.from_numpy(a).to(device).to(torch.bfloat16)
    b = torch.from_numpy(b).to(device).to(torch.bfloat16)
    for route in micro_dot.ROUTE_NAMES:  # the headline is the wgmma route
        rows.append(dot_case(
            device, "P1a", f"gk: grid({tiles}) x ({m}, {k}) @ ({k}, {n}), "
            "the last block stores", a, b, tiles, 1, m, tiles - 1,
            library_batched=True, headline=route == micro_dot.ROUTE_WGMMA,
            route=route))
    del a, b

    levels = _common.LEVELS if full else _common.SMALL_LEVELS
    rng = np.random.RandomState(0)  # the draws of probe_kernel's levels
    for lv, (v, c, cout, shape) in levels.items():
        feats, rules, w, valid = _common.make_level(rng, v, c, cout, shape,
                                                    device)
        args = (feats.to(torch.bfloat16)[None], rules[None],
                w.to(torch.bfloat16), valid[None])
        split = [_common.conv_case(
            device, "P1b", f"L{lv} V={v} C={c}: {mode}", *args,
            phases=phases, headline=lv == 0 and phases == k1.PHASE_FULL)
            for mode, phases in MODES]
        _common.phase_split(split)
        rows += split
        # the full conv on the route production did not take at this width
        other = 1 - k1.route_for(c, cout)
        rows.append(_common.conv_case(
            device, "P1b", f"L{lv} V={v} C={c}: full, other route", *args,
            route=other))
    return rows


def main():
    _common.main(run)


if __name__ == "__main__":
    main()

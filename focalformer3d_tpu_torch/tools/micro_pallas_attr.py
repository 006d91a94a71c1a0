"""P5: K1's time by stage, with stages switched off, on the H100.

The TPU probe (``tools/micro_pallas_attr.py``, ``variant_kernel``) timed
the production kernel with its stages disabled one after another (one-hot
build, one-hot product ``gmm``, lane mask, weight product ``fmm``) on a
clustered L0 voxel set (120 000 voxels, C = 16, two z draws per column).
Here K1's probe (``ops/sparse_conv_cuda.sparse_conv_probe``) runs the
same set: ``full``; ``no fmm`` and ``no mask/fmm`` keep the gather and
drop the product (one launch on the card); ``no gmm`` drops the gather
and keeps the product on a zeroed tile; ``only copy`` keeps neither (the
rule loads and the epilogue).

    python -m focalformer3d_tpu_torch.tools.micro_pallas_attr
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import sparse_conv_cuda as k1
from . import _common

SET = (120_000, 16, (41, 1440, 1440))  # (V, C, grid), :83
SMALL_SET = (600, 16, (5, 40, 40))
MODES = (("full", k1.PHASE_FULL),
         ("no fmm = no mask/fmm -> gather only", k1.PHASE_GATHER),
         ("no gmm -> product only", k1.PHASE_MMA),
         ("only copy -> neither", 0))


def run(device: torch.device, size: str = "full") -> list:
    v, c, shape = SET if size == "full" else SMALL_SET
    feats, rules, w, valid = _common.clustered_set(
        np.random.RandomState(0), v, c, shape, device)
    args = (feats.to(torch.bfloat16)[None], rules[None],
            w.to(torch.bfloat16), valid[None])
    rows = [_common.conv_case(device, "P5", f"clustered V={v} C={c}: {mode}",
                              *args, phases=phases)
            for mode, phases in MODES]
    _common.phase_split(rows)
    return rows


def main():
    _common.main(run)


if __name__ == "__main__":
    main()

"""P8: a batched launch against one launch per sample, on the H100.

The TPU probe (``tools/micro_batch_grid.py``, ``_kernel_flat``) timed the
production kernel's batched grid (B, n_tiles) against a copy with the batch
axis stripped, at levels L0 and L1 of ``make_level``. On the card the
question becomes: one launch over batch 2 (``grid.y = B``) against two
launches of batch 1, on the same two rulebooks, with K1's probe in full
mode (``ops/sparse_conv_cuda.sparse_conv_probe``). The two give the same
bits; production K1 at batch 2 is timed beside them.

    python -m focalformer3d_tpu_torch.tools.micro_batch_grid
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import sparse_conv_cuda as k1
from . import _common


def run(device: torch.device, size: str = "full") -> list:
    levels = _common.LEVELS if size == "full" else _common.SMALL_LEVELS
    rng = np.random.RandomState(0)
    rows = []
    for lv in (0, 1):
        v, c, cout, shape = levels[lv]
        samples = [_common.make_level(rng, v, c, cout, shape, device)
                   for _ in range(2)]
        feats = torch.stack([s[0] for s in samples]).to(torch.bfloat16)
        rules = torch.stack([s[1] for s in samples])
        valid = torch.stack([s[3] for s in samples])
        w = samples[0][2].to(torch.bfloat16)
        kept = []
        rows.append(_common.conv_case(
            device, "P8", f"L{lv} V={v} C={c}: batch 2, one launch", feats,
            rules, w, valid, keep=kept))
        nbytes, flops, _ = _common.conv_bytes_flops(feats, rules, w, valid)
        rows.append(_common.case(
            device, "P8", f"L{lv} V={v} C={c}: batch 1, two launches",
            kernel="sparse_conv_probe",
            run=lambda: [k1.sparse_conv_probe(feats[b:b + 1], rules[b:b + 1],
                                              w, valid[b:b + 1])
                         for b in range(2)],
            plain=lambda: k1.sparse_conv_probe_plain(
                feats.float(), rules, w.float(), valid),
            check="scale", nbytes=nbytes, flops=flops, keep=kept,
            rate=(flops, 1e12, "TFLOP/s")))
        rows[-1]["equal_batch2"] = torch.equal(kept[-1], kept[0])
        rows[-1]["ok"] = rows[-1]["ok"] and rows[-1]["equal_batch2"]
        if device.type == "cuda":
            rows[-1]["vs_batch2"] = rows[-1]["ms"] / rows[-2]["ms"]
    return rows


def main():
    _common.main(run)


if __name__ == "__main__":
    main()

"""P6: in-kernel gathers from a window held in fast memory, on the H100.

The TPU probe (``tools/micro_gather_kernel.py``) summed K = 27 gathered rows
for each of T rows of 1024 tiles from one (W, cl) window in VMEM, three
ways: a one-hot product (``_ohdot_kernel``), ``take_along_axis`` per tap
(``_take_kernel``) and one fused take (``_takerow_kernel``). The one-hot
kernel indexes ``rel // pack``, the two takes ``rel``: for pack > 1 they are
two functions. Here kernel B's ``gather_taps`` (``ops/micro_gather.py``)
computes each function once, with ``div`` explicit, the window staged in
shared memory; for pack 1 all three are one function. Where ``div`` is 1,
``torch.nn.functional.embedding_bag(mode="sum")`` computes the same
function and is timed beside it.

    python -m focalformer3d_tpu_torch.tools.micro_gather_kernel
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import micro_gather
from . import _common

T, K, N_TILES = 128, 27, 1024
CONFIGS = ((256, 128, 4), (512, 128, 8), (256, 128, 1))  # (W, cl, pack)
SMALL = (16, 27, 2, ((64, 32, 4), (64, 32, 1)))


def operands(seed: int, n_tiles: int, t: int, k: int, W: int, cl: int,
             pack: int):
    """rel int32 (n_tiles, T, K) uniform in [0, W // pack) and the window
    float32 (max(W, W // pack), cl) of standard normals, as the original
    draws them (numpy, ``RandomState(seed)``)."""
    rng = np.random.RandomState(seed)
    wb = W // pack
    rel = rng.randint(0, wb, size=(n_tiles, t, k)).astype(np.int32)
    return rel, rng.randn(max(W, wb), cl).astype(np.float32)


def run(device: torch.device, size: str = "full") -> list:
    t, k, n_tiles, configs = ((T, K, N_TILES, CONFIGS) if size == "full"
                              else SMALL)
    rows = []
    for seed, (W, cl, pack) in enumerate(configs):
        rel, xw = operands(seed, n_tiles, t, k, W, cl, pack)
        rel = torch.from_numpy(rel).to(device)
        xw = torch.from_numpy(xw).to(device).to(torch.bfloat16)
        nbytes = rel.numel() * 4 + xw.numel() * 2 + n_tiles * t * cl * 2
        work = {"nbytes": nbytes, "flops": n_tiles * t * k * cl,
                "peak": "f32", "rate": (n_tiles * t * k, 1e9, "Grows/s")}
        names = ([(f"W={W} pack={pack} ohdot (rel // {pack})", pack),
                  (f"W={W} pack={pack} take = takerow (rel)", 1)]
                 if pack > 1 else
                 [(f"W={W} pack=1 ohdot = take = takerow", 1)])
        for name, div in names:
            flat = rel.view(-1, k)
            rows.append(_common.case(
                device, "P6", name, kernel="micro_gather_taps",
                run=lambda div=div: micro_gather.gather_taps(rel, xw, div),
                plain=lambda div=div: micro_gather.gather_taps_plain(
                    rel, xw, div),
                check="scale",
                library=(lambda flat=flat: torch.nn.functional.embedding_bag(
                    flat, xw, mode="sum")) if div == 1 else None,
                op="embedding_bag(mode='sum')" if div == 1 else None,
                headline=pack == 1, **work))
    return rows


def main():
    _common.main(run)


if __name__ == "__main__":
    main()

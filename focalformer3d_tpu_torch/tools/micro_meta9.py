"""P9: widening the column meta to its nine BEV neighbours, on the H100.

The TPU probe (``tools/micro_meta9.py``) timed four formulations of
``widen_meta9`` at the grids of levels L0-L2: ``concat`` (nine shifted
slices of the padded meta concatenated on axis 1, the production form),
``stack``, a row ``gather``, and a Pallas stencil kernel
(``_widen_kernel``), each checked against ``concat``. Here kernel C
(``ops/micro_widen.py``) takes the Pallas kernel's place, ``torch.cat`` of
the nine slices (the padded meta built before the timing) is its library
yardstick, and ``stack`` and ``gather`` are PyTorch ops; all are held
equal to ``concat`` bit for bit.

    python -m focalformer3d_tpu_torch.tools.micro_meta9
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import micro_widen
from . import _common

GRIDS = ((1440, "L0"), (720, "L1"), (360, "L2"))
SMALL_GRIDS = ((20, "L0"), (12, "L1"))


def meta_for(seed: int, W: int) -> np.ndarray:
    """int32 (W * W + 1, 4) uniform in [0, 2**30), numpy
    ``RandomState(seed)``, as the original draws it."""
    rng = np.random.RandomState(seed)
    return rng.randint(0, 2**30, size=(W * W + 1, 4)).astype(np.int32)


def run(device: torch.device, size: str = "full") -> list:
    rows = []
    for seed, (W, level) in enumerate(GRIDS if size == "full"
                                      else SMALL_GRIDS):
        meta = torch.from_numpy(meta_for(seed, W)).to(device)
        n_rows = meta.shape[0] + W
        nbytes = meta.numel() * 4 + n_rows * 36 * 4
        mp = micro_widen.padded_meta(meta, W)
        parts = micro_widen.nine_slices(mp, W, n_rows)

        def concat(meta=meta, W=W):
            return micro_widen.widen_meta9_plain(meta, W)

        rate = (nbytes, 1e9, "GB/s")
        rows.append(_common.case(
            device, "P9", f"{level} W={W}", kernel="micro_widen",
            run=lambda: micro_widen.widen_meta9(meta, W), plain=concat,
            check="exact", nbytes=nbytes,
            library=lambda parts=parts: torch.cat(parts, dim=1),
            op="torch.cat of the nine slices", rate=rate,
            headline=level == "L0"))
        rows.append(_common.op_case(
            device, "P9", f"{level} W={W} stack",
            op="torch.stack(slices, 1).reshape",
            fn=lambda parts=parts: torch.stack(parts, 1).reshape(n_rows, 36),
            ref=concat, nbytes=nbytes, rate=rate))
        offs = torch.tensor([dy * W + dx for dy in range(3)
                             for dx in range(3)], device=device)
        idx = torch.arange(n_rows, device=device)[:, None] + offs
        rows.append(_common.op_case(
            device, "P9", f"{level} W={W} gather", op="mp[idx] row gather",
            fn=lambda mp=mp, idx=idx: mp[idx].reshape(n_rows, 36),
            ref=concat, nbytes=nbytes, rate=rate))
    return rows


def main():
    _common.main(run)


if __name__ == "__main__":
    main()

"""P9: widening the column meta to its nine BEV neighbours, on the H100.

The TPU probe (``tools/micro_meta9.py``) timed four formulations of
``widen_meta9`` at the grids of levels L0-L2: ``concat`` (nine shifted
slices of the padded meta concatenated on axis 1, the production form),
``stack``, a row ``gather``, and a Pallas stencil kernel
(``_widen_kernel``), each checked against ``concat``. Here kernel C
(``ops/micro_widen.py``) takes the Pallas kernel's place. Its library
yardstick is one copy of a strided view of the padded meta (built before
the timing), ``strided_widen``: row r's nine neighbours lie at rows r +
dy * W + dx, so a (n_rows, 3, 3, 4) view with strides (4, 4W, 4, 1) is
the widened meta, and ``reshape`` copies it once. ``torch.cat`` of the
nine slices (the production form), ``stack`` and ``gather`` are PyTorch
ops timed beside it; all are held equal to ``concat`` bit for bit.

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


def strided_widen(mp: torch.Tensor, W: int, n_rows: int) -> torch.Tensor:
    """The widened meta as one copy of a strided view of the padded meta
    ``mp`` (contiguous (rows, 4) int32)."""
    return torch.as_strided(mp, (n_rows, 3, 3, 4),
                            (4, 4 * W, 4, 1)).reshape(n_rows, 36)


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
        plan = micro_widen.widen_plan(meta.shape[0], W)
        rows.append(_common.case(
            device, "P9", f"{level} W={W}", kernel="micro_widen",
            run=lambda: micro_widen.widen_meta9(meta, W), plain=concat,
            check="exact", nbytes=nbytes,
            library=lambda mp=mp, W=W: strided_widen(mp, W, n_rows),
            op="as_strided(mp).reshape (one copy)", rate=rate,
            headline=level == "L0", route=plan["name"],
            tile_rows=plan["tile_rows"]))
        rows.append(_common.op_case(
            device, "P9", f"{level} W={W} strided view",
            op="as_strided(mp).reshape (one copy)",
            fn=lambda mp=mp, W=W: strided_widen(mp, W, n_rows),
            ref=concat, nbytes=nbytes, rate=rate))
        rows.append(_common.op_case(
            device, "P9", f"{level} W={W} cat",
            op="torch.cat of the nine slices",
            fn=lambda parts=parts: torch.cat(parts, dim=1),
            ref=concat, nbytes=nbytes, rate=rate))
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

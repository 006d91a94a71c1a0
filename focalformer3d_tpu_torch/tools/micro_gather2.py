"""P7: row gathers at several row widths, slab gathers, and a gather from a
table in fast memory, on the H100.

The TPU probe (``tools/micro_gather2.py``) timed XLA row gathers over a
~64 MB table at row widths of 64 B to 4 KB, slab gathers of S consecutive
rows (``lax.gather`` and ``dynamic_slice`` in ``vmap``), and two Pallas
kernels (``kernel``: a per-row loop; ``kernel2``: ``jnp.take``) that
gather rows from a 4 MB table held in VMEM, one function. Here:

- the row gather at each width is kernel B's ``gather_rows``
  (``ops/micro_gather.py``) beside ``x[idx]``;
- the slab gathers are PyTorch ops: ``x[starts + arange(S)]`` for
  ``lax.gather``, and ``x.unfold(0, S, 1)[starts]`` (a strided view
  indexed) for ``dynamic_slice`` in ``vmap``, held equal to each other;
- the 4 MB table is ``gather_rows`` beside ``torch.index_select``; the
  table sits in device memory and fits the card's 50 MB L2 cache.

The width sweep's tables come from a seeded ``torch.Generator`` on the
device (7 tables of 32 M values); the other inputs from numpy.

    python -m focalformer3d_tpu_torch.tools.micro_gather2
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import micro_gather
from . import _common

WIDTHS = (32, 64, 128, 256, 512, 1024, 2048)  # bf16 values per row
SWEEP = {"rows": 1_080_000, "table_elems": 32 * 1024 * 1024}
SLAB = {"V": 120_000, "C": 32, "cases": ((1, 3_240_000), (4, 1_080_000),
                                         (8, 540_000))}
VMEM = {"V": 65_536, "C": 32, "N": 262_144}  # the 4 MB table
SMALL = {"widths": (32, 64), "sweep": {"rows": 1000, "table_elems": 4096},
         "slab": {"V": 500, "C": 32, "cases": ((1, 300), (8, 100))},
         "vmem": {"V": 256, "C": 32, "N": 1024}}


def table_rows(seed: int, v: int, c: int, n: int):
    """x float32 (V, C) standard normal and idx int32 (N,) uniform in
    [0, V), numpy ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    x = rng.randn(v, c).astype(np.float32)
    return x, rng.randint(0, v, size=n).astype(np.int32)


def table_bytes(rows: torch.Tensor, c: int) -> int:
    """The bytes of a bf16 table of width ``c`` that a gather of ``rows``
    must read: each distinct row once."""
    return int(torch.unique(rows).numel()) * c * 2


def _rows_case(device, name, x, idx, headline=False, library=None,
               op=None):
    n, c = idx.shape[0], x.shape[1]
    nbytes = idx.numel() * 4 + table_bytes(idx, c) + n * c * 2
    return _common.case(
        device, "P7", name, kernel="micro_gather_rows",
        run=lambda: micro_gather.gather_rows(x, idx),
        plain=lambda: micro_gather.gather_rows_plain(x, idx),
        check="exact", nbytes=nbytes, library=library, op=op,
        rate=(n, 1e6, "Mrows/s"), headline=headline)


def run(device: torch.device, size: str = "full") -> list:
    full = size == "full"
    widths = WIDTHS if full else SMALL["widths"]
    sweep = SWEEP if full else SMALL["sweep"]
    slab = SLAB if full else SMALL["slab"]
    vmem = VMEM if full else SMALL["vmem"]
    rows = []
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    n = sweep["rows"]
    for width in widths:  # the original's ~64 MB table at each width
        v = max(1, sweep["table_elems"] // width)
        x = torch.randn(v, width, generator=gen, device=device).to(
            torch.bfloat16)
        idx = torch.randint(0, v, (n,), generator=gen, device=device,
                            dtype=torch.int32)
        rows.append(_rows_case(
            device, f"row gather {width * 2} B rows, table {v} x {width}",
            x, idx, library=lambda x=x, idx=idx: x[idx], op="x[idx]"))
        del x, idx

    xs, _ = table_rows(1, slab["V"], slab["C"], 1)
    xs = torch.from_numpy(xs).to(device).to(torch.bfloat16)
    rng = np.random.RandomState(2)
    for S, count in slab["cases"]:
        starts = torch.from_numpy(rng.randint(
            0, slab["V"] - S, size=count).astype(np.int64)).to(device)
        offs = torch.arange(S, device=device)
        nbytes = (count * 8 + table_bytes(starts[:, None] + offs, slab["C"])
                  + count * S * slab["C"] * 2)

        def gathered(starts=starts, offs=offs):
            return xs[starts[:, None] + offs]

        rows.append(_common.op_case(
            device, "P7", f"slab gather S={S} n={count}",
            op="x[starts + arange(S)] (lax.gather)", fn=gathered,
            nbytes=nbytes, rate=(count * S * slab["C"] * 2, 1e9, "GB/s")))
        if S > 1:
            rows.append(_common.op_case(
                device, "P7", f"slab S={S} n={count} as dynamic_slice in "
                "vmap", op="x.unfold(0, S, 1)[starts] (dynamic_slice)",
                fn=lambda S=S, starts=starts: xs.unfold(0, S, 1)[starts]
                .transpose(1, 2).contiguous(),
                ref=gathered, nbytes=nbytes,
                rate=(count * S * slab["C"] * 2, 1e9, "GB/s")))

    x, idx = table_rows(3, vmem["V"], vmem["C"], vmem["N"])
    x = torch.from_numpy(x).to(device).to(torch.bfloat16)
    idx = torch.from_numpy(idx).to(device)
    rows.append(_rows_case(
        device, f"table {vmem['V']} x {vmem['C']} "
        f"({vmem['V'] * vmem['C'] * 2 / 2**20:g} MiB), {vmem['N']} rows: "
        "kernel = kernel2", x, idx, headline=True,
        library=lambda: torch.index_select(x, 0, idx),
        op="torch.index_select"))
    return rows


def main():
    _common.main(run)


if __name__ == "__main__":
    main()

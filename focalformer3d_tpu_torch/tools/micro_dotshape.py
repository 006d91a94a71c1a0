"""P2: the cost law of one tensor-core product's shape, on the H100.

The TPU probe (``tools/micro_dotshape.py``) ran ``N_TILES`` grid steps of
``reps`` products (M, K) @ (K, N), bf16 operands and f32 sums, the operand
shifted by r (``a + r``) so that no product repeats, and kept 8 rows of the
sum. Here kernel A (``ops/micro_dot.py``) runs the same: ``N_TILES``
blocks, each computing all its products, one block storing 8 rows. Inputs
are normal draws from a seeded numpy generator (the original used ones).
Each row also times ``torch.matmul`` on one (M, K) @ (K, N) product
(``one_matmul_ms``), the rate a library reaches at that shape.

    python -m focalformer3d_tpu_torch.tools.micro_dotshape
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import micro_dot
from . import _common

N_TILES = 600
# (M, K, N, reps), tools/micro_dotshape.py:98-116
SHAPES = ((2304, 64, 128, 3), (768, 64, 384, 3), (768, 64, 1536, 3),
          (768, 64, 512, 3), (2304, 128, 128, 3), (2304, 256, 128, 3),
          (2304, 512, 128, 3), (2304, 1536, 128, 1), (1152, 64, 128, 3),
          (4608, 64, 128, 3), (256, 64, 128, 27), (256, 1152, 128, 3))
SMALL_TILES = 3
SMALL_SHAPES = ((32, 16, 32, 3), (24, 64, 48, 2), (16, 80, 16, 1))
ROWS_OUT = 8


def operands(seed: int, n_a: int, m: int, k: int, n: int):
    """a (n_a, M, K) and b (K, N): standard normal float32 draws from
    ``np.random.default_rng(seed)``, as numpy arrays (rounded to bf16 where
    they are used)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n_a, m, k), dtype=np.float32)
    return a, rng.standard_normal((k, n), dtype=np.float32)


def dot_case(device, probe: str, name: str, a, b, n_blocks: int,
             reps: int, rows_out: int, store_block: int,
             library_batched: bool = False, headline: bool = False) -> dict:
    """Kernel A on bf16 ``a`` (n_a, M, K), ``b`` (K, N) against its plain
    version (1e-3 of scale: f32 sums in another order). Its work is every
    block's products; its bytes a, b read once and the stored rows written
    once. With ``library_batched`` (n_a = n_blocks, reps 1) one
    ``torch.matmul(a, b)`` computes every block's product and is the
    library yardstick; otherwise ``torch.matmul`` of one product is timed
    beside it."""
    n_a, m, k = a.shape
    n = b.shape[1]
    flops = 2 * m * k * n * reps * n_blocks
    nbytes = a.numel() * 2 + b.numel() * 2 + rows_out * n * 4
    extra = {}
    if not library_batched and device.type == "cuda":
        one_ms = _common.time_ms(device, lambda: torch.matmul(a[0], b))[0]
        extra["one_matmul_ms"] = one_ms
        extra["one_matmul_tflops"] = 2 * m * k * n / (one_ms * 1e-3) / 1e12
    return _common.case(
        device, probe, name, kernel="micro_dot",
        run=lambda: micro_dot.dot_probe(a, b, n_blocks, reps, rows_out,
                                        store_block),
        plain=lambda: micro_dot.dot_probe_plain(a, b, reps, rows_out,
                                                store_block),
        check="scale", nbytes=nbytes, flops=flops,
        library=(lambda: torch.matmul(a, b)) if library_batched else None,
        op="torch.matmul(a, b), every block's product" if library_batched
        else None,
        rate=(flops, 1e12, "TFLOP/s"), headline=headline, **extra)


def shape_case(device, probe: str, m: int, k: int, n: int, reps: int,
               n_tiles: int, seed: int) -> dict:
    """One (M, K, N, reps) shape of P2/P3 over ``n_tiles`` blocks."""
    a, b = operands(seed, 1, m, k, n)
    a = torch.from_numpy(a).to(device).to(torch.bfloat16)
    b = torch.from_numpy(b).to(device).to(torch.bfloat16)
    return dot_case(device, probe, f"M={m} K={k} N={n} reps={reps} "
                    f"tiles={n_tiles}", a, b, n_tiles, reps, ROWS_OUT, 0)


def run(device: torch.device, size: str = "full") -> list:
    shapes, n_tiles = ((SHAPES, N_TILES) if size == "full"
                       else (SMALL_SHAPES, SMALL_TILES))
    return [shape_case(device, "P2", m, k, n, reps, n_tiles, seed)
            for seed, (m, k, n, reps) in enumerate(shapes)]


def main():
    _common.main(run)


if __name__ == "__main__":
    main()

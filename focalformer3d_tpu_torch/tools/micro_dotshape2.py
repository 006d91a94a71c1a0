"""P3: per-launch against per-block cost of a product, on the H100.

The TPU probe (``tools/micro_dotshape2.py``) varied the grid's step count at
fixed work per step, and the work per step at fixed total work, to tell a
per-call floor from a per-step one. Here kernel A (``ops/micro_dot.py``)
runs the same products (see ``micro_dotshape``) with one block per step.
The original's two rows with "parallel" grid semantics repeat two shapes:
blocks of a CUDA grid always run in parallel, so those rows are the same
launch as their "arbitrary" twins and run once.

    python -m focalformer3d_tpu_torch.tools.micro_dotshape2
"""
from __future__ import annotations

import torch

from . import _common
from .micro_dotshape import shape_case

# (M, K, N, reps, tiles), tools/micro_dotshape2.py:84-94, each shape once
SHAPES = ((2304, 64, 128, 3, 600), (2304, 64, 128, 3, 300),
          (2304, 64, 128, 3, 150), (2304, 64, 128, 3, 75),
          (2304, 64, 128, 3, 16), (9216, 64, 128, 3, 150),
          (4608, 64, 128, 3, 300))
SMALL_SHAPES = ((32, 16, 32, 3, 4), (32, 16, 32, 3, 2), (64, 16, 32, 3, 1))


def run(device: torch.device, size: str = "full") -> list:
    shapes = SHAPES if size == "full" else SMALL_SHAPES
    return [shape_case(device, "P3", m, k, n, reps, tiles, 100 + seed)
            for seed, (m, k, n, reps, tiles) in enumerate(shapes)]


def main():
    _common.main(run)


if __name__ == "__main__":
    main()

"""Kernel A: the dot-shape probe, a hand-written CUDA kernel and its plain
version.

``dot_probe`` launches the kernel of ``csrc/micro_dot.cu`` for tensors on a
card and runs ``dot_probe_plain`` for tensors on the CPU. It replaces the
Pallas functions of the TPU probes P1a (``tools/micro_mxu_probe.py:gk``), P2
(``tools/micro_dotshape.py:_kernel``/``_outer``) and P3
(``tools/micro_dotshape2.py:_outer``):

    out = sum_{r < reps} bf16(a[store_block mod n_a] + r) @ b   [:rows_out]

in f32 from bf16 operands, where every one of ``n_blocks`` blocks computes
its own product ``a[i mod n_a]`` and only block ``store_block`` stores.
P1a is ``n_a = n_blocks``, ``reps = 1``, ``rows_out = M``, ``store_block =
n_blocks - 1``; P2 and P3 are ``n_a = 1``, ``rows_out = 8``,
``store_block = 0``.

The kernel runs its product on one of two instruction routes over the same
shared-memory tiles: ``ROUTE_WGMMA`` (``wgmma.mma_async`` m64nNk16 by two
warpgroups, the default) or ``ROUTE_MMA_SYNC`` (``mma.sync`` m16n8k16 by
eight warps). K1 chooses its route per width from their rates, so the
probes time both.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

SOURCE = cuda_build.CSRC / "micro_dot.cu"
ROUTE_WGMMA = 0
ROUTE_MMA_SYNC = 1
ROUTE_NAMES = {ROUTE_WGMMA: "wgmma", ROUTE_MMA_SYNC: "mma.sync"}
STAGE_BYTES = 2 * 128 * 64 * 2  # the kernel's two stages of a + r
MAX_SMEM = 227 * 1024  # shared memory a block can take on an H100

_fn = None
_launches = cuda_build.Launches("dot")


def launch_count() -> int:
    """Kernel launches since the last ``reset_launch_count``."""
    return _launches.counts["dot"]


def reset_launch_count() -> None:
    _launches.reset()


def _load():
    global _fn
    if _fn is None:
        _fn = cuda_build.load(SOURCE, "micro_dot_probe",
                              [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
                              + [ctypes.c_void_p])
    return _fn


def dot_probe_plain(a: torch.Tensor, b: torch.Tensor, reps: int,
                    rows_out: int, store_block: int) -> torch.Tensor:
    """The stored block's sum in f32: ``a + r`` rounded to bf16, products
    of the bf16 values in f32."""
    x = a[store_block % a.shape[0], :rows_out].float()
    bf = b.float()
    acc = torch.zeros(rows_out, b.shape[1], dtype=torch.float32,
                      device=a.device)
    for r in range(reps):
        acc += (x + r).to(torch.bfloat16).float() @ bf
    return acc


def column_tile(k: int, n: int) -> int:
    """The kernel's column tile: the widest of 128, 64, 32, 16 columns that
    divides N and whose (K, tile) part of b fits in shared memory beside
    the stages; 0 if none does."""
    for nt in (128, 64, 32, 16):
        if n % nt == 0 and STAGE_BYTES + k * nt * 2 <= MAX_SMEM:
            return nt
    return 0


def dot_probe(a: torch.Tensor, b: torch.Tensor, n_blocks: int, reps: int,
              rows_out: int, store_block: int,
              route: int = ROUTE_WGMMA) -> torch.Tensor:
    """a bf16 (n_a, M, K), b bf16 (K, N), contiguous, on one device; K and N
    multiples of 16 (K at most 6240: 16 columns of b must fit in shared
    memory); ``0 < rows_out <= M``, ``0 <= store_block < n_blocks``,
    ``reps >= 1``; ``route`` one of ``ROUTE_WGMMA``, ``ROUTE_MMA_SYNC``.
    Returns f32 (rows_out, N). On a CUDA device this launches the kernel
    (or raises); on the CPU it runs ``dot_probe_plain``."""
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError("a and b must be bfloat16")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    if a.dim() != 3 or b.dim() != 2 or a.shape[2] != b.shape[0]:
        raise ValueError(f"a (n_a, M, K) and b (K, N) expected, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    n_a, m, k = a.shape
    n = b.shape[1]
    if k % 16 or n % 16:
        raise ValueError(f"K={k} and N={n} must be multiples of 16")
    if not (0 < rows_out <= m and 0 <= store_block < n_blocks and reps >= 1
            and n_a >= 1):
        raise ValueError(f"rows_out={rows_out} (M={m}), store_block="
                         f"{store_block} (n_blocks={n_blocks}), reps={reps}")
    if route not in ROUTE_NAMES:
        raise ValueError(f"route={route} is not a route of the kernel")
    if not column_tile(k, n):
        raise ValueError(f"K={k} is too deep: no column tile of b fits in "
                         "shared memory")
    if not cuda_build.on_card(a, b):
        return dot_probe_plain(a, b, reps, rows_out, store_block)
    cuda_build.check_aligned(a, b)
    out = torch.empty((rows_out, n), dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    cuda_build.check_launch(_load()(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), n_a, m, k, n, reps,
        n_blocks, rows_out, store_block, route, stream), "micro_dot")
    _launches.add("dot")
    return out

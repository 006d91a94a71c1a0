"""One run of one cell of the port's benchmark.

    python3 -m perfbench.run --workload L.stream --seed 7 --seconds 46 \\
        --trace 0

From the root of a checkout: reads ``BENCHMARK.json``, the cell's
configuration and traffic files, builds the port's kernels (once per
checkout, into the port's ``_build/``), makes the weights and the pool of
scans from ``--seed`` on the card, warms up the cell's own shapes, runs
the traffic for ``--seconds``, and checks what the timed path produced
against the plain reference (``judge.py``). The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device`` and, traced, ``breakdown``, then ``check``,
each compared number with its limit; the last lines of standard error
give the same numbers.

It runs on the card and exits with code 2, printing no result, where
there is none or fewer than the cell asks for. ``--device cpu`` exists for
the tests, at their tiny configurations. It exits with code 3, printing
no result, where the JAX package or JAX itself was loaded.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path
from typing import List

BANNED = {"jax", "jaxlib", "flax", "optax", "focalformer3d_tpu"}


def process_start() -> float:
    """Wall-clock time at which this process started."""
    try:
        stat = Path("/proc/self/stat").read_text()
        ticks = int(stat.rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def banned_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & BANNED)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the card; the benchmark) or 'cpu' (tests)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    t_proc = process_start()
    args = parse_args(argv)
    from .spec import PKG, load_cell

    cache = Path.cwd() / PKG / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    # one intra-op host thread, as torchrun starts each of a node's
    # processes (the configurations' ``assumed.host_threads``)
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    os.environ.setdefault("MKL_NUM_THREADS", "1")

    import torch

    cell = load_cell(args.workload)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            print(f"perfbench: {cell.name} needs {cell.chips} CUDA "
                  f"device(s); this machine has "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        torch.set_num_threads(1)
    elif device.type != "cpu":
        print(f"perfbench: unknown device {args.device}", file=sys.stderr)
        return 2
    else:
        torch.set_num_threads(min(4, torch.get_num_threads()))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from . import bench

    result, notes, checks = bench.run_cell(cell, device, args.seed,
                                           args.seconds, bool(args.trace),
                                           t_proc)
    found = banned_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}; nothing it "
              f"measures may", file=sys.stderr)
        return 3
    for line in notes:
        print(line, flush=True)
    for name, (value, limit) in checks.items():
        print(f"check {name} {value!r} limit {limit!r}"
              f"{'' if value <= limit else ' FAILED'}", file=sys.stderr)
    result["check"] = {k: {"value": v, "limit": lim}
                       for k, (v, lim) in checks.items()}
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

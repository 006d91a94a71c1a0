"""The knee of a stream cell: its latency at a few fixed rates.

    python3 -m perfbench.sweep --workload L.stream --seed 5 \\
        --rates 8,10,12,14,16 --seconds 20

One set-up, then one window per rate (the cell's traffic with that
``rate_hz``): per rate the scans, p50 / p95 / max latency, the median
service time, and the backlog at the window's end (how late the last
scan started). The sustained rate is the highest whose backlog does not
grow; the cell runs at 0.7 of it.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from . import bench
    from .spec import load_cell

    cell = load_cell(args.workload)
    device = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sess = bench.Session(cell, device)
    sess.build()
    pr = sess.prepare(args.seed, False)
    for rate in (float(r) for r in args.rates.split(",")):
        traffic = dict(cell.traffic, rate_hz=rate)
        w = sess.measure(pr, args.seconds, False, traffic)
        lat = np.asarray(w.latency_ms)
        service = np.asarray(w.end) - np.asarray(w.start)
        due_last = (len(lat) - 1) / rate
        print(json.dumps({
            "rate_hz": rate, "scans": len(lat),
            "failed": int(sum(w.failed)),
            "p50_ms": float(np.percentile(lat, 50)),
            "p95_ms": float(np.percentile(lat, 95)),
            "max_ms": float(lat.max()),
            "service_median_ms": float(np.median(service) * 1e3),
            "backlog_end_ms": float((w.start[-1] - due_last) * 1e3)}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

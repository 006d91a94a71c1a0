"""Median of the stream's scans, each from when it was due to its boxes on the
host."""
from perfbench.metrics import _read


def read(ctx):
    return _read.latency_pct(ctx, 50)

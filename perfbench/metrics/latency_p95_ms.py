"""95th percentile of the stream's scans, each from when it was due to its
boxes on the host; a failed scan misses every limit."""
from perfbench.metrics import _read


def read(ctx):
    return _read.latency_pct(ctx, 95)

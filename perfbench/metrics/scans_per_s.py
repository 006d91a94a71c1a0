"""Scans whose boxes reached the host, over the whole offline window."""
from perfbench.metrics import _read


def read(ctx):
    return _read.rate(ctx, "offline")

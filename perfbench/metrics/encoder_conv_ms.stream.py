"""Median ms a scan in the sparse encoder's convs (port stages sparse convs and
dense tail)."""
from perfbench.metrics import _read


def read(ctx):
    return _read.stage_ms(ctx, "stream", ("sparse convs", "dense tail"))

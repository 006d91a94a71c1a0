"""Median ms a scan in the sparse encoder's index build (port stage index
build)."""
from perfbench.metrics import _read


def read(ctx):
    return _read.stage_ms(ctx, "stream", ("index build",))

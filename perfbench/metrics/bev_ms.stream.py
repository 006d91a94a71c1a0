"""Median ms a scan in SECOND, its neck and the fusion layers (port stages
SECOND + neck, FocalEncoder)."""
from perfbench.metrics import _read


def read(ctx):
    return _read.stage_ms(ctx, "stream", ("SECOND + neck", "FocalEncoder"))

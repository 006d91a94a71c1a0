"""Median ms a scan in the camera branch (port stages image backbone + FPN,
LSS lift, LSS splat, BevEncode)."""
from perfbench.metrics import _read

STAGES = ("image backbone + FPN", "LSS lift", "LSS splat", "BevEncode")


def read(ctx):
    return _read.stage_ms(ctx, "stream", STAGES)

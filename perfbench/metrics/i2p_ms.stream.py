"""Median ms a scan in the camera projection (port stages image proj, I2P:
``shared_conv_img``, then ``shared_conv_pts`` and the first fusion layer's
I2P)."""
from perfbench.metrics import _read

STAGES = ("image proj", "I2P")


def read(ctx):
    return _read.stage_ms(ctx, "stream", STAGES)

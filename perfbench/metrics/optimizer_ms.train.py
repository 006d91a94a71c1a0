"""Median ms a training step in the optimizer (phase optimizer)."""
from perfbench.metrics import _read


def read(ctx):
    return _read.stage_ms(ctx, "train", ("optimizer",))

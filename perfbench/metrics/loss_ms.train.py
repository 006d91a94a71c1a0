"""Median ms a training step in the loss and its Hungarian assignment (phase
loss)."""
from perfbench.metrics import _read


def read(ctx):
    return _read.stage_ms(ctx, "train", ("loss",))

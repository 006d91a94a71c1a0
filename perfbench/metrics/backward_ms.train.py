"""Median ms a training step in the backward (phase backward)."""
from perfbench.metrics import _read


def read(ctx):
    return _read.stage_ms(ctx, "train", ("backward",))

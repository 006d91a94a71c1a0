"""Samples of the training steps completed, over the whole window."""
from perfbench.metrics import _read


def read(ctx):
    return _read.rate(ctx, "train")

"""Share of the traced batches' time in which no device operation ran, in
percent."""
from perfbench.metrics import _read


def read(ctx):
    return _read.idle_pct(ctx, "offline")

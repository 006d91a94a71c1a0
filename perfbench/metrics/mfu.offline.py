"""The batches' work at the stated peaks (work.py) over the window, in
percent."""
from perfbench.metrics import _read


def read(ctx):
    return _read.mfu_pct(ctx, "offline")

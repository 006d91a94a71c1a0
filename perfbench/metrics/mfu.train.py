"""The steps' work (three forwards' products, work.py) at the stated peaks over
the window, in percent."""
from perfbench.metrics import _read


def read(ctx):
    return _read.mfu_pct(ctx, "train")

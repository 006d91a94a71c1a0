"""The scans' work at the stated peaks (work.py) over their summed service
time, in percent."""
from perfbench.metrics import _read


def read(ctx):
    return _read.mfu_pct(ctx, "stream")

"""The encoder convs' least time (operations at the bf16 peak or bytes at
HBM's rate, the larger; work.py) over their stages' time, summed over the
window's scans, in percent."""
from perfbench.metrics import _read

STAGES = ("sparse convs", "dense tail")


def read(ctx):
    return _read.roofline_pct(ctx, "stream", STAGES,
                              "encoder_seconds_at_peak")

"""Share of the traced scans' service time (start of service to boxes on the
host) in which no device operation ran, in percent."""
from perfbench.metrics import _read


def read(ctx):
    return _read.idle_pct(ctx, "stream")

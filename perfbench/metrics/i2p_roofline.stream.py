"""The camera projection's least time (its products at the float32 peak or
its bytes at HBM's rate, the larger; ``i2p_work.py``, at the published
shapes) over its stages' time, summed over the window's scans, in
percent."""
import torch

from perfbench import i2p_work
from perfbench.metrics import _read

STAGES = ("image proj", "I2P")


def read(ctx):
    if not ctx.get("work") or not torch.cuda.is_available():
        return None  # no card with a peak table
    least = i2p_work.seconds_at_peak(
        torch.cuda.get_device_name(torch.cuda.current_device()))
    per_scan = [{"i2p_seconds_at_peak": least}] * len(ctx["window"].stages)
    return _read.roofline_pct(dict(ctx, work=per_scan), "stream", STAGES,
                              "i2p_seconds_at_peak")

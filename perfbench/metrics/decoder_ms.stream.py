"""Median ms a scan in the decoder and get_bboxes (port stage decoder, and the
caller's get_bboxes)."""
from perfbench.metrics import _read


def read(ctx):
    return _read.stage_ms(ctx, "stream", ("decoder", "get_bboxes"))

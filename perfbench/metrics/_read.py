"""What the metric readers share. ``ctx`` holds the run's ``kind``
(stream, offline, train), its ``window`` (``loops.Window``), ``setup_s``,
the analysed ``trace`` (``trace.analyse``; traced runs), and ``work``
(traced runs: per window item, ``work.count`` of its inputs, or None
where the card has no peak table)."""
from __future__ import annotations

import statistics
from typing import Optional, Sequence

import numpy as np

FAILED_MS = 1e9  # a failed scan misses every latency limit


def latencies(ctx) -> Optional[np.ndarray]:
    w = ctx["window"]
    if ctx["kind"] != "stream" or not w.latency_ms:
        return None
    return np.asarray([FAILED_MS if f else v
                       for v, f in zip(w.latency_ms, w.failed)])


def rate(ctx, kind: str) -> Optional[float]:
    """Items' samples completed over the whole window, per second."""
    w = ctx["window"]
    if ctx["kind"] != kind or not w.rows:
        return None
    done = sum(len(r) for r, f in zip(w.rows, w.failed) if not f)
    return done / w.seconds


def stage_ms(ctx, kind: str, stages: Sequence[str]) -> Optional[float]:
    """Median over the window's items of the summed ms of ``stages``;
    None where no item marked any of them."""
    w = ctx["window"]
    if ctx["kind"] != kind or not w.stages:
        return None
    if not any(s in split for split in w.stages for s in stages):
        return None
    return statistics.median(sum(split.get(s, 0.0) for s in stages)
                             for split in w.stages)


def idle_pct(ctx, kind: str) -> Optional[float]:
    t = ctx["trace"]
    if ctx["kind"] != kind or not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mfu_pct(ctx, kind: str) -> Optional[float]:
    """The work's seconds at the stated peaks over the time it took: the
    scans' summed service time in a stream, the window otherwise."""
    w, work = ctx["window"], ctx.get("work")
    if ctx["kind"] != kind or not work:
        return None
    ok = [i for i, f in enumerate(w.failed) if not f]
    need = sum(work[i]["seconds_at_peak"] for i in ok)
    took = (sum(w.end[i] - w.start[i] for i in ok) if kind == "stream"
            else w.seconds)
    return 100.0 * need / took


def roofline_pct(ctx, kind: str, stages: Sequence[str],
                 key: str) -> Optional[float]:
    """The least time of a layer's work (``work[key]``) over the time its
    stages took, summed over the window's items."""
    w, work = ctx["window"], ctx.get("work")
    if ctx["kind"] != kind or not work or not w.stages:
        return None
    took = sum(sum(split.get(s, 0.0) for s in stages) for split in w.stages)
    if took <= 0:
        return None
    return 100.0 * sum(x[key] for x in work) / (took * 1e-3)


def latency_pct(ctx, q: float) -> Optional[float]:
    """The ``q``th percentile of every scan of the stream's window."""
    a = latencies(ctx)
    return None if a is None else float(np.percentile(a, q))

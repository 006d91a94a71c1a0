"""The device's side of a traced window, from ``torch.profiler``.

From the profiled items' events: the device operations' intervals (kernels,
copies, sets), their union inside the items' service intervals
(``busy_s``), the length of those intervals (``window_s``), the device
operations that took most time, and the idle gaps inside the intervals,
each named by the innermost host operation running at its middle.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Tuple

from .loops import ITEM

Interval = Tuple[float, float]


def merge(iv: List[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def overlap(a: List[Interval], b: List[Interval]) -> List[Interval]:
    """Intersection of two merged interval lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if lo < hi:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def length(iv: List[Interval]) -> float:
    return sum(b - a for a, b in iv)


def analyse(prof, top: int = 10) -> Dict[str, object]:
    """``busy_s``, ``window_s``, ``device_ops`` and ``idle_gaps`` (lists of
    [name, seconds]) of a profile; None where it saw no device operation
    or no item."""
    from torch.autograd import DeviceType

    items, device, host = [], [], []
    by_name: Dict[str, float] = {}
    for e in prof.events():
        a, b = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.name == ITEM and e.device_type == DeviceType.CUDA:
            continue  # the item's range as the device timeline shows it
        if e.device_type == DeviceType.CUDA:
            device.append((a, b))
            by_name[e.name] = by_name.get(e.name, 0.0) + (b - a)
        elif e.name == ITEM:
            items.append((a, b))
        else:
            host.append((a, b, e.name))
    if not device or not items:
        return None
    win = merge(items)
    busy = overlap(merge(device), win)
    gaps = []
    for lo, hi in win:
        edges = [(a, b) for a, b in busy if lo <= a and b <= hi]
        t = lo
        for a, b in edges:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if hi > t:
            gaps.append((t, hi))
    host.sort()
    starts = [h[0] for h in host]
    idle: Dict[str, float] = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        k = bisect.bisect_right(starts, mid) - 1
        name = "no host operation"
        for k in range(k, max(k - 20000, -1), -1):
            if host[k][1] >= mid:
                name = host[k][2]
                break
        idle[name] = idle.get(name, 0.0) + (b - a)
    rank = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gap_rank = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": length(busy), "window_s": length(win),
            "device_ops": [[n, s] for n, s in rank],
            "idle_gaps": [[n, s] for n, s in gap_rank]}

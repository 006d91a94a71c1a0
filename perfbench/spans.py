"""The port's own spans on a traced window's profile.

While a ``torch.profiler`` records, the port runs each of its stages in a
range ``ff3d/<name>`` (``focalformer3d_tpu_torch/utils/profiler.span``).
``analyse`` joins those ranges with the device events and the CUDA API
calls of the same profile, by time on the profiler's clock and on any host
thread (autograd runs the backward on a thread of its own):

- a device-idle gap inside the traced items (``trace.analyse``'s gaps)
  belongs to the innermost ``ff3d/`` span that covers its midpoint, the
  rule by which ``trace.analyse`` names a gap after a host operation;
- a launch (``cudaLaunchKernel``, ``cudaLaunchKernelExC``,
  ``cuLaunchKernel*``) or a host sync (``cudaStreamSynchronize``,
  ``cudaDeviceSynchronize``, ``cudaEventSynchronize``, a synchronous
  ``cudaMemcpy``) belongs to the innermost span that covers its start.

Every value is per traced item. A span's own idle time, launches and syncs
leave out those of the spans inside it, so the spans' values add up to
what lies inside any span; its host time is the whole range. ``analyse``
gives None where the profile has no device event, no item or no ``ff3d/``
span. ``layer_values`` sums the spans of the two largest layers, the
index build (``index build/L<k>``) and the head (``decoder``, its heatmap
stages and rounds, ``get_bboxes``).

One traced window of a cell, with the spans' note lines, the tracing's
cost and the span helper's own cost (a card, or ``--device cpu`` at the
tests' tiny configurations):

    python3 -m perfbench.spans --workload L.stream --seed 7 --seconds 20 \\
        --untraced-seconds 20

It prints the notes, then one JSON line: the window's latencies (or its
rate), untraced before and after the traced window and traced, each
window's median stage sum, the share of the idle time that falls inside
a span, ``layer_values`` and the span helper's cost in microseconds.
"""
from __future__ import annotations

import argparse
import bisect
import json
import statistics
import sys
import time
from typing import Dict, List, Optional

from .loops import ITEM
from .trace import length, merge, overlap

PREFIX = "ff3d/"
LAUNCH = ("cudaLaunchKernel", "cudaLaunchKernelExC")
SYNC = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
        "cudaEventSynchronize", "cudaMemcpy")
OUTSIDE = "(outside every span)"


def _is_launch(name: str) -> bool:
    return name in LAUNCH or name.startswith("cuLaunchKernel")


def _owner(spans: List[tuple], starts: List[float], t: float
           ) -> Optional[str]:
    """The innermost span (the latest to start) that covers time ``t``;
    ``spans`` sorted by start."""
    k = bisect.bisect_right(starts, t) - 1
    while k >= 0:
        a, b, name = spans[k]
        if b >= t:
            return name
        k -= 1
    return None


def analyse(prof) -> Optional[Dict[str, object]]:
    """Per ``ff3d/`` span name (without the prefix) and per traced item:
    ``host_ms``, ``idle_ms``, ``launches``, ``syncs``, ``ranges``; and the
    items' ``idle_ms``, the part of it inside a span (``idle_in_spans_ms``),
    ``launches`` and ``syncs``, inside spans and in all."""
    from torch.autograd import DeviceType

    items, device, spans, calls = [], [], [], []
    for e in prof.events():
        a, b = e.time_range.start * 1e-3, e.time_range.end * 1e-3  # ms
        if e.device_type == DeviceType.CUDA:
            if e.name != ITEM:  # the item's range on the device timeline
                device.append((a, b))
        elif e.name == ITEM:
            items.append((a, b))
        elif e.name.startswith(PREFIX):
            spans.append((a, b, e.name[len(PREFIX):]))
        elif _is_launch(e.name):
            calls.append((a, "launches"))
        elif e.name in SYNC:
            calls.append((a, "syncs"))
    if not device or not items or not spans:
        return None
    n = len(items)
    win = merge(items)
    busy = overlap(merge(device), win)
    gaps, t_busy = [], [a for a, _ in busy]
    for lo, hi in win:
        t = lo
        for a, b in busy[bisect.bisect_left(t_busy, lo):]:
            if a >= hi:
                break
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if hi > t:
            gaps.append((t, hi))
    spans.sort()
    starts = [s[0] for s in spans]
    names = sorted({s[2] for s in spans})
    per = {m: {"host_ms": 0.0, "idle_ms": 0.0, "launches": 0, "syncs": 0,
               "ranges": 0} for m in names + [OUTSIDE]}
    for a, b, name in spans:
        per[name]["host_ms"] += b - a
        per[name]["ranges"] += 1
    for a, b in gaps:
        per[_owner(spans, starts, 0.5 * (a + b)) or OUTSIDE]["idle_ms"] += \
            b - a
    in_items = [(a, kind) for a, kind in calls
                if any(lo <= a <= hi for lo, hi in win)]
    for a, kind in in_items:
        per[_owner(spans, starts, a) or OUTSIDE][kind] += 1
    out = {m: {k: v / n for k, v in d.items()} for m, d in per.items()}
    idle = sum(b - a for a, b in gaps)
    return {"items": n, "window_ms": length(win) / n, "idle_ms": idle / n,
            "idle_in_spans_ms": (idle - per[OUTSIDE]["idle_ms"]) / n,
            "launches": len([c for c in in_items if c[1] == "launches"]) / n,
            "syncs": len([c for c in in_items if c[1] == "syncs"]) / n,
            "spans": {m: out[m] for m in names},
            "outside": out[OUTSIDE]}


def _family(res, key: str, match) -> float:
    return sum(d[key] for m, d in res["spans"].items() if match(m))


def _index_build(m: str) -> bool:
    return m.startswith("index build/")


def _head(m: str) -> bool:
    return m == "decoder" or m.startswith("decoder/") or m == "get_bboxes"


def layer_values(res: Optional[dict]) -> Dict[str, Optional[float]]:
    """Per traced item: device-idle ms and launches of the index build and
    of the head, and the host syncs inside any span; every value None
    where ``res`` is (no device event or no span)."""
    keys = ("index_build_idle_ms", "decoder_idle_ms",
            "index_build_launches", "decoder_launches", "host_syncs")
    if res is None:
        return dict.fromkeys(keys)
    return {"index_build_idle_ms": _family(res, "idle_ms", _index_build),
            "decoder_idle_ms": _family(res, "idle_ms", _head),
            "index_build_launches": _family(res, "launches", _index_build),
            "decoder_launches": _family(res, "launches", _head),
            "host_syncs": res["syncs"] - res["outside"]["syncs"]}


def notes(res: Optional[dict]) -> List[str]:
    """One line per span name, in the order of the names, and a summary."""
    if res is None:
        return ["spans: the profile has no device event or no ff3d/ span"]
    lines = [f"span {PREFIX}{m}: host {d['host_ms']:.4f} ms, device idle "
             f"{d['idle_ms']:.4f} ms, launches {d['launches']:.2f}, syncs "
             f"{d['syncs']:.2f}, ranges {d['ranges']:.2f} per item"
             for m, d in list(res["spans"].items())
             + [(OUTSIDE, res["outside"])]]
    share = (100.0 * res["idle_in_spans_ms"] / res["idle_ms"]
             if res["idle_ms"] > 0 else 100.0)
    lines.append(f"spans: {res['items']} items, window {res['window_ms']:.4f}"
                 f" ms, device idle {res['idle_ms']:.4f} ms an item, "
                 f"{share:.2f}% of it inside a span; launches "
                 f"{res['launches']:.2f}, syncs {res['syncs']:.2f} an item")
    return lines


def span_cost(device, n: int = 20000) -> Dict[str, float]:
    """Microseconds a ``span`` site costs: none recording and no mark (the
    shared null context), a mark, and with a profiler recording, beside
    an empty ``with`` of a null context."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    from focalformer3d_tpu_torch.utils.profiler import span

    def loop(make):
        t = time.perf_counter()
        for _ in range(n):
            with make():
                pass
        return (time.perf_counter() - t) / n * 1e6

    null = contextlib.nullcontext()
    out = {"empty_with_us": loop(lambda: null),
           "null_us": loop(lambda: span("cost")),
           "mark_us": loop(lambda: span("cost", lambda _: None))}
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts):
        out["recording_us"] = loop(lambda: span("cost"))
    return out


def _window_numbers(w) -> Dict[str, Optional[float]]:
    ok = [i for i, f in enumerate(w.failed) if not f]
    service = [1e3 * (w.end[i] - w.start[i]) for i in ok]
    out = {"items": len(w.rows), "failed": len(w.rows) - len(ok),
           "service_p50_ms": statistics.median(service) if service else None}
    if w.latency_ms:
        out["latency_p50_ms"] = statistics.median(w.latency_ms)
    else:
        out["rate_per_s"] = sum(len(w.rows[i]) for i in ok) / w.seconds
    if w.stages:
        out["stage_sum_p50_ms"] = statistics.median(
            sum(s.values()) for s in w.stages)
        stages = sorted({k for s in w.stages for k in s})
        out["stage_p50_ms"] = {k: statistics.median(
            s.get(k, 0.0) for s in w.stages) for k in stages}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True,
                   help="the traced window")
    p.add_argument("--untraced-seconds", type=float, default=0.0,
                   help="untraced windows before and after the traced one")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    from . import bench, loops, trace
    from .spec import load_cell

    cell = load_cell(args.workload)
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = bench.card(device)
    print(f"device: {info['kind']}, power limit {info['power_limit']}",
          flush=True)
    sess = bench.Session(cell, device)
    sess.build()
    prep = sess.prepare(args.seed, trace=False)
    result = {"workload": cell.name, "seed": args.seed,
              "device": info["kind"], "power_limit": info["power_limit"]}
    if args.untraced_seconds:
        result["untraced_before"] = _window_numbers(
            sess.measure(prep, args.untraced_seconds, False))
    program = sess.program
    if sess.train:
        batch = loops.batches_of(cell.traffic)[prep.first]
        loops.profile_warmup(device, lambda: prep.step(
            program.model, prep.opt_state, loops.take(prep.pool, batch),
            prep.gen))
        prep.first += 1
    else:
        loops.profile_warmup(device, lambda: program.infer(
            loops.take(prep.pool, [0])))
    w = sess.measure(prep, args.seconds, True)
    res = analyse(w.profile)
    tr = trace.analyse(w.profile)
    w.profile = None
    for line in notes(res):
        print(line, flush=True)
    result["traced"] = _window_numbers(w)
    if args.untraced_seconds:
        result["untraced_after"] = _window_numbers(
            sess.measure(prep, args.untraced_seconds, False))
    result["idle_in_spans_pct"] = (
        100.0 * res["idle_in_spans_ms"] / res["idle_ms"]
        if res and res["idle_ms"] > 0 else None)
    result["device_idle_pct"] = (100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
                                 if tr else None)
    result["layer_values"] = layer_values(res)
    result["span_cost_us"] = span_cost(device)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

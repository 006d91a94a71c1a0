"""The one traffic generator: a mix's parameters (``traffic/<mix>.json``)
drive one of three loops over a pool of scans made from the seed.

- ``stream``: batch 1, open loop, periodic arrivals at ``rate_hz``. Each
  scan is timed from when it was due to when its boxes are on the host; a
  scan that finds the system busy waits, and its wait counts. The
  generator's lateness (how late a scan started that found the system
  idle) is kept apart.
- ``offline``: closed loop over batches of ``batch`` pool scans, issued
  back to back: batch k's boxes are copied to the host after batch k + 1
  is issued, so host work overlaps the device as far as the program lets
  it.
- ``train``: closed loop of training steps on batches of ``batch`` pool
  scans with their ground truth. The first ``check_steps`` steps belong to
  the set-up (the reference follows them); the window goes on from there.

Every seed draws the same sizes (points, boxes, cameras, pool, arrivals)
and only their contents and order differ.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .data import synthetic
from .spec import load_rig

BOX_KEYS = ("bboxes", "scores", "labels", "mask")
ITEM = "perfbench.item"


@dataclasses.dataclass
class Seeds:
    data: np.random.RandomState
    weights: int
    order: np.random.RandomState
    step: int


def seeds(seed: int) -> Seeds:
    """Independent streams for the pool, the weights, the order of the
    pool in the window and the training step's generator."""
    ss = np.random.SeedSequence(seed).spawn(4)
    words = [int(s.generate_state(1, np.uint64)[0]) >> 1 for s in ss]
    return Seeds(np.random.RandomState(np.random.MT19937(ss[0])), words[1],
                 np.random.RandomState(np.random.MT19937(ss[2])), words[3])


def make_pool(traffic: dict, config: dict, cfg, rng: np.random.RandomState,
              device: torch.device) -> Dict[str, torch.Tensor]:
    """``pool`` scans of the configuration's rig (``"scan"``; and their
    cameras for a camera config), stacked on the device."""
    b = synthetic.make_batch(
        rng, load_rig(config["scan"]), batch_size=traffic["pool"],
        n_points=config["points"], n_boxes=traffic["gt_boxes"],
        max_gts=traffic["max_gts"], num_classes=cfg.decoder.num_classes,
        pc_range=cfg.voxel.point_cloud_range, with_images=cfg.input_img,
        n_cams=config.get("cameras", 0),
        img_hw=tuple(config.get("img_scale", (1, 1))))
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


def take(pool: Dict[str, torch.Tensor], idx: List[int]
         ) -> Dict[str, torch.Tensor]:
    if idx == list(range(idx[0], idx[0] + len(idx))):
        return {k: v[idx[0]:idx[0] + len(idx)] for k, v in pool.items()}
    sel = torch.tensor(idx, device=next(iter(pool.values())).device)
    return {k: v[sel] for k, v in pool.items()}


class EventClock:
    """Stage times of one item: ``mark(stage)`` records a CUDA event (the
    host clock on the CPU); ``split()`` sums ms per stage, synchronising
    once."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: list = [(None, self._now())]

    def _now(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def mark(self, stage: str) -> None:
        self.marks.append((stage, self._now()))

    def split(self) -> Dict[str, float]:
        if self.cuda:
            self.marks[-1][1].synchronize()
        out: Dict[str, float] = {}
        for (_, a), (stage, b) in zip(self.marks[:-1], self.marks[1:]):
            ms = a.elapsed_time(b) if self.cuda else (b - a) * 1e3
            out[stage] = out.get(stage, 0.0) + ms
        return out


def finite(tensors) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in tensors
               if t.is_floating_point())


@dataclasses.dataclass
class Window:
    """What a window measured: per item its pool rows, service interval
    (host seconds from the window's start), latency (stream), whether it
    failed, and, in a traced run, its stage split; the window's length;
    the outputs kept for the check; the profile of a traced run."""

    kind: str
    batch: int
    seconds: float = 0.0
    rows: List[List[int]] = dataclasses.field(default_factory=list)
    start: List[float] = dataclasses.field(default_factory=list)
    end: List[float] = dataclasses.field(default_factory=list)
    latency_ms: List[float] = dataclasses.field(default_factory=list)
    failed: List[bool] = dataclasses.field(default_factory=list)
    stages: List[Dict[str, float]] = dataclasses.field(default_factory=list)
    lateness_ms: List[float] = dataclasses.field(default_factory=list)
    kept: Dict[int, tuple] = dataclasses.field(default_factory=dict)
    profile: Optional[object] = None


class _Tracer:
    """Profiles items [first, first + n) of a traced window."""

    def __init__(self, device, first: int, n: int, enabled: bool):
        self.first, self.last = first, first + n
        self.enabled, self.device, self.prof = enabled, device, None
        self.running = False

    def before(self, i: int) -> None:
        if self.enabled and i == self.first:
            self.running = True
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if self.device.type == "cuda"
                else [])
            self.prof = profile(activities=acts)
            self.prof.__enter__()

    def after(self, i: int) -> None:
        if self.prof is not None and i == self.last - 1:
            self.stop()

    def stop(self) -> None:
        if self.running:
            self.running = False
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.prof.__exit__(None, None, None)


def profile_warmup(device: torch.device, fn: Callable[[], None]) -> None:
    """Run ``fn`` under the profiler once, so that its start-up is set-up."""
    t = _Tracer(device, 0, 1, True)
    t.before(0)
    fn()
    t.after(0)


def _to_host(dec):
    return [dec[k].to("cpu") for k in BOX_KEYS]


def stream(program, pool, traffic: dict, order: np.random.RandomState,
           seconds: float, trace: bool, keep: List[int]) -> Window:
    """Scans due every 1 / ``rate_hz`` s for ``seconds``; every scan due in
    the window is served. ``keep``: pool rows whose first request's outputs
    are kept for the check."""
    dev = program.device
    P = traffic["pool"]
    n = int(math.ceil(seconds * traffic["rate_hz"]))
    perm = np.concatenate([order.permutation(P)
                           for _ in range(n // P + 1)])[:n]
    w = Window("stream", 1)
    n_trace = min(traffic["trace_items"], n)
    tracer = _Tracer(dev, (n - n_trace) // 2, n_trace, trace)
    period = 1.0 / traffic["rate_hz"]
    t0 = time.perf_counter()
    prev_end = t0
    for i in range(n):
        due = t0 + i * period
        while True:
            now = time.perf_counter()
            if now >= due:
                break
            time.sleep(min(due - now, 0.002) if due - now > 0.0005 else 0)
        tracer.before(i)
        start = time.perf_counter()
        if prev_end <= due:
            w.lateness_ms.append((start - due) * 1e3)
        row = int(perm[i])
        clock = EventClock(dev) if trace else None
        failed = False
        try:
            with torch.profiler.record_function(ITEM):
                vox, out, dec = program.infer(
                    take(pool, [row]), clock.mark if clock else None)
                host = _to_host(dec)
            failed = not finite(host)
        except (RuntimeError, ValueError):
            failed = True
        end = time.perf_counter()
        prev_end = end
        tracer.after(i)
        if row in keep and row not in w.kept and not failed:
            w.kept[row] = ([row], vox, out, dec)
        w.rows.append([row])
        w.start.append(start - t0)
        w.end.append(end - t0)
        w.latency_ms.append((end - due) * 1e3)
        w.failed.append(failed)
        if clock is not None:
            w.stages.append(clock.split())
    tracer.stop()
    w.seconds = time.perf_counter() - t0
    w.profile = tracer.prof
    return w


def offline(program, pool, traffic: dict, order: np.random.RandomState,
            seconds: float, trace: bool, keep: List[int]) -> Window:
    """Batches of ``batch`` pool scans back to back for ``seconds``; the
    batch in flight when the window closes is finished and counted, and
    the rate is taken over all of that time."""
    dev = program.device
    batches = batches_of(traffic)
    w = Window("offline", traffic["batch"])
    tracer = _Tracer(dev, traffic["trace_skip"], traffic["trace_items"],
                     trace)
    pending = None

    def finish(p):
        i, rows, start, vox, out, dec, host, ev, clock = p
        failed = False
        try:
            if ev is not None:
                ev.synchronize()
            failed = not finite(host)
        except RuntimeError:
            failed = True
        end = time.perf_counter()
        tracer.after(i)
        if not failed and batches.index(rows) in keep and \
                batches.index(rows) not in w.kept:
            w.kept[batches.index(rows)] = (rows, vox, out, dec)
        w.rows.append(rows)
        w.start.append(start - t0)
        w.end.append(end - t0)
        w.failed.append(failed)
        if clock is not None:
            w.stages.append(clock.split())

    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        rows = batches[int(order.randint(len(batches)))]
        tracer.before(i)
        start = time.perf_counter()
        clock = EventClock(dev) if trace else None
        try:
            with torch.profiler.record_function(ITEM):
                vox, out, dec = program.infer(
                    take(pool, rows), clock.mark if clock else None)
                host = [torch.empty(dec[k].shape, dtype=dec[k].dtype,
                                    pin_memory=dev.type == "cuda")
                        for k in BOX_KEYS]
                for h, k in zip(host, BOX_KEYS):
                    h.copy_(dec[k], non_blocking=True)
                ev = None
                if dev.type == "cuda":
                    ev = torch.cuda.Event()
                    ev.record()
            cur = (i, rows, start, vox, out, dec, host, ev, clock)
        except RuntimeError:
            cur = None
            w.rows.append(rows)
            w.start.append(start - t0)
            w.end.append(time.perf_counter() - t0)
            w.failed.append(True)
        if pending is not None:
            finish(pending)
        pending = cur
        i += 1
    if pending is not None:
        finish(pending)
    tracer.stop()
    w.seconds = time.perf_counter() - t0
    w.profile = tracer.prof
    return w


def batches_of(traffic: dict) -> List[List[int]]:
    """The pool's rows, ``batch`` at a time, in order."""
    B, P = traffic["batch"], traffic["pool"]
    return [list(range(s, s + B)) for s in range(0, P, B)]


def train(program, step, opt_state, gen, pool, traffic: dict,
          seconds: float, trace: bool, first: int) -> Window:
    """Steps on the pool's batches in turn, from batch ``first``, for
    ``seconds``; the step in flight when the window closes is finished and
    counted."""
    dev = program.device
    batches = batches_of(traffic)
    w = Window("train", traffic["batch"])
    tracer = _Tracer(dev, traffic["trace_skip"], traffic["trace_items"],
                     trace)
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        rows = batches[(first + i) % len(batches)]
        tracer.before(i)
        start = time.perf_counter()
        clock = EventClock(dev) if trace else None
        try:
            with torch.profiler.record_function(ITEM):
                m = step(program.model, opt_state, take(pool, rows), gen,
                         clock.mark if clock else None)
                failed = not math.isfinite(float(m["loss"]))
        except (RuntimeError, ValueError):
            failed = True
        end = time.perf_counter()
        tracer.after(i)
        w.rows.append(rows)
        w.start.append(start - t0)
        w.end.append(end - t0)
        w.failed.append(failed)
        if clock is not None:
            w.stages.append(clock.split())
        i += 1
    tracer.stop()
    w.seconds = time.perf_counter() - t0
    w.profile = tracer.prof
    return w

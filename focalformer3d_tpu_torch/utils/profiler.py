"""Section timers and device traces.

Port of ``focalformer3d_tpu/utils/profiler.py``, the counterpart of the
reference's ``time_utils`` profiler (projects/mmdet3d_plugin/models/utils/
time_utils.py:32-77): a nestable context-manager timer with running
averages in a registry. ``.sync(x)`` names the tensors (a tensor, or a
dict / list / tuple of them) the section produced; the timer then calls
``torch.cuda.synchronize`` on their card before it stops the clock, as the
reference does. ``device_trace`` wraps ``torch.profiler``. ``StageClock``
splits a span into named stages by CUDA events on the card (the host clock
on the CPU); the benchmark CLI times with both.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Iterator, Sequence

import torch

global_timer: Dict[str, Dict[str, float]] = {}
_prefix: list = []


def _tensors(value: Any) -> Iterator[torch.Tensor]:
    if torch.is_tensor(value):
        yield value
    elif isinstance(value, dict):
        for v in value.values():
            yield from _tensors(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _tensors(v)


class _Timer:
    def __init__(self, name: str, record: bool = True):
        self.name = name
        self.record = record
        self._sync_val: Any = None
        self.ms = None  # the last section's time, once it has ended

    def sync(self, value: Any) -> Any:
        """Register tensors to wait for before stopping the clock."""
        self._sync_val = value
        return value

    def __enter__(self):
        _prefix.append(self.name)
        self.key = "/".join(_prefix)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        cards = {t.device for t in _tensors(self._sync_val)
                 if t.device.type == "cuda"}
        for dev in cards:
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - self.t0
        self.ms = dt * 1e3
        _prefix.pop()
        if self.record:
            e = global_timer.setdefault(self.key,
                                        {"total": 0.0, "count": 0.0})
            e["total"] += dt
            e["count"] += 1
        return False


@contextlib.contextmanager
def _null():
    yield None


def T(name: str, enable: bool = True, record: bool = True):
    """Timer factory; a null context when disabled (reference
    ``time_utils.T`` semantics)."""
    if not enable:
        return _null()
    return _Timer(name, record)


def timer_summary(reset: bool = False) -> str:
    lines = []
    for k in sorted(global_timer):
        e = global_timer[k]
        avg = e["total"] / max(e["count"], 1)
        lines.append(f"{k}: avg {avg * 1000:.2f} ms over {int(e['count'])}")
    if reset:
        global_timer.clear()
    return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """``torch.profiler`` over the block (host and, where there is a card,
    its kernels); the Chrome trace is written to ``log_dir/trace.json``.
    Yields the profiler."""
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


class StageClock:
    """Splits a span into stages: ``start()`` opens it, ``mark(stage)``
    ends ``stage`` (the time since the previous mark goes to it), and
    ``split()`` sums each stage's time in ms. On a card each mark records
    a CUDA event on the current stream, so marking does not synchronise;
    ``split`` does, once. On the CPU the marks read the host clock."""

    def __init__(self, device: torch.device, stages: Sequence[str] = ()):
        self.cuda = device.type == "cuda"
        self.device = device
        self.stages = tuple(stages)
        self.marks: list = []

    def _now(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def start(self) -> None:
        self.marks = [(None, self._now())]

    def mark(self, stage: str) -> None:
        self.marks.append((stage, self._now()))

    def split(self) -> Dict[str, float]:
        """ms per stage: those given at construction first (0 where none
        was marked), then any other marked."""
        if self.cuda:
            torch.cuda.synchronize(self.device)
        out = dict.fromkeys(self.stages, 0.0)
        for (_, a), (stage, b) in zip(self.marks[:-1], self.marks[1:]):
            ms = a.elapsed_time(b) if self.cuda else (b - a) * 1e3
            out[stage] = out.get(stage, 0.0) + ms
        return out

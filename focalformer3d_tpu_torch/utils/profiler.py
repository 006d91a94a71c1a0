"""Section timers, spans and stage clocks.

Port of ``focalformer3d_tpu/utils/profiler.py``, the counterpart of the
reference's ``time_utils`` profiler (projects/mmdet3d_plugin/models/utils/
time_utils.py:32-77). ``T`` is a nestable context-manager timer:
``.sync(x)`` names the tensors (a tensor, or a dict / list / tuple of
them) the section produced; the timer then calls
``torch.cuda.synchronize`` on their card before it stops the clock, as the
reference does, and keeps the section's time in ``.ms``.

``span(name, mark)`` wraps one stage of the port. While a
``torch.profiler`` records, it opens the range ``ff3d/<name>`` on the
profiler's timeline (the clock of the device kernels); on exit it calls
``mark(stage)``, the caller's stage hook. With no profiler recording and
no ``mark`` it is one shared null context: nothing else switches spans
on. The range is a host range of function scope (``_RecordFunctionFast``),
not a ``record_function`` of user scope: the profiler copies a user-scope
range onto the device's timeline, from the first to the last kernel
launched in it, where it would read as device time.

``StageClock`` splits a span into named stages by CUDA events on the card
(the host clock on the CPU); the benchmark CLI times with it and ``T``.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, Iterator, Optional, Sequence

import torch
from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast

PREFIX = "ff3d/"
_NULL = contextlib.nullcontext()


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
    def __init__(self, name: str):
        self.name = name
        self._sync_val: Any = None
        self.ms = None  # the last section's time, once it has ended

    def sync(self, value: Any) -> Any:
        """Register tensors to wait for before stopping the clock."""
        self._sync_val = value
        return value

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        cards = {t.device for t in _tensors(self._sync_val)
                 if t.device.type == "cuda"}
        for dev in cards:
            torch.cuda.synchronize(dev)
        self.ms = (time.perf_counter() - self.t0) * 1e3
        return False


def T(name: str, enable: bool = True):
    """Timer factory; a null context when disabled (reference
    ``time_utils.T`` semantics)."""
    return _Timer(name) if enable else _NULL


class _Span:
    __slots__ = ("range", "mark", "stage")

    def __init__(self, range_, mark, stage):
        self.range, self.mark, self.stage = range_, mark, stage

    def __enter__(self):
        if self.range is not None:
            self.range.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self.range is not None:
            self.range.__exit__(exc_type, exc, tb)
        if self.mark is not None and exc_type is None:
            self.mark(self.stage)
        return False


def span(name: str, mark: Optional[Callable[[str], None]] = None,
         stage: Optional[str] = None):
    """Context manager around one stage of the port.

    While a ``torch.profiler`` records, the block runs inside the range
    ``ff3d/<name>``. On a normal exit ``mark(stage)`` is called, if
    ``mark`` is given; ``stage`` defaults to ``name`` up to its first
    ``/`` ("index build/L1" marks "index build"). A span nested in another
    marks its own stage first, so the outer stage keeps the rest of the
    outer block. With no profiler recording and no ``mark`` it returns a
    shared null context and does nothing else."""
    rec = _profiler_enabled()
    if mark is None and not rec:
        return _NULL
    return _Span(_RecordFunctionFast(PREFIX + name) if rec else None, mark,
                 stage or name.split("/", 1)[0])


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

"""Background-thread batch prefetcher.

The port's copy of ``focalformer3d_tpu/data/prefetch.py`` (pure Python),
the counterpart of the reference's multi-worker DataLoader: a depth-N
thread keeps host batches ready while the card runs the step, so sample
loading and collate overlap device work (numpy-heavy stages release the
GIL, so one thread recovers most of the multi-worker benefit without
multiprocessing's pickling constraints).

Exceptions raised by the producer are re-raised at the consumer's next
`__next__`, preserving the iterator contract.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()


class Prefetcher(Iterator[T]):
    """Wrap an iterable; a worker thread stays ``depth`` items ahead."""

    def __init__(self, it: Iterable[T], depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._err: BaseException | None = None
        self._thread = threading.Thread(
            target=self._run, args=(iter(it),), daemon=True
        )
        self._thread.start()

    def _run(self, it: Iterator[T]):
        try:
            for item in it:
                self._q.put(item)
        except BaseException as e:  # noqa: BLE001 - re-raised at consumer
            self._err = e
        finally:
            self._q.put(_SENTINEL)

    def __iter__(self):
        return self

    def __next__(self) -> T:
        item = self._q.get()
        if item is _SENTINEL:
            if self._err is not None:
                err, self._err = self._err, None
                raise err
            raise StopIteration
        return item


def prefetch(it: Iterable[T], depth: int = 2) -> Iterator[T]:
    """Convenience wrapper: ``for batch in prefetch(batch_iter(e)): ...``"""
    return Prefetcher(it, depth=depth)

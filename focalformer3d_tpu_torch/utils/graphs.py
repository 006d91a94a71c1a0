"""A forward's blocks as CUDA graph replays.

A module writes a part of its forward that runs on static shapes as a
generator of blocks: it yields once after each block (the block's outputs,
or None), so one piece of code runs eagerly, while it is captured and,
through the graphs, while they replay. ``BlockGraphs`` captures the blocks
in order into one memory pool, a graph each, and replays them in that
order. ``GraphCache`` keeps a module's graphs by a key of the call's
geometry: a key's first call runs eagerly (its warm-up: lazy
initialisation, cuBLAS and cuDNN choices), its second captures and replays,
every later one replays. The module decides which calls may take graphs at
all; none may inside another capture or under a dispatch mode
(``must_run_eagerly``).

The graphs read their inputs from buffers of their own, which each replay
fills first, and everything else (parameters, buffers) in place, so a
``load_state_dict`` (a copy into the parameters) keeps them valid. A
replay's outputs live in the pool, where the next replay of their block
overwrites them: the caller clones what must outlive the call.

A cache counts blocks in ``counter`` (``train_step.kernel_launches``), by
how they ran on a card: ``<prefix>_graph_replay``,
``<prefix>_graph_capture`` and ``<prefix>_eager``.
"""
from __future__ import annotations

from typing import Callable, Hashable, Iterator, Sequence, Tuple

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from ..ops import cuda_build


def must_run_eagerly() -> bool:
    """Whether a call on a card runs its blocks eagerly whatever its key:
    inside another graph's capture, or under a dispatch mode (which would
    see no op of a replay)."""
    return (torch.cuda.is_current_stream_capturing()
            or _get_current_dispatch_mode() is not None)


class BlockGraphs:
    """The ``n_blocks`` blocks of ``build(*inputs)`` captured in order into
    one memory pool, a CUDA graph each. Each block's outputs stay in the
    pool, where the next replay of that block overwrites them."""

    def __init__(self, build: Callable[..., Iterator], n_blocks: int,
                 inputs: Sequence[torch.Tensor], counter, kind: str):
        self.inputs = [t.clone() for t in inputs]
        cuda_build.take_captured()  # drop what no earlier capture took
        blocks = build(*self.inputs)
        self.graphs, self.outputs, self.launches = [], [], []
        self.counter = counter
        pool = None
        for _ in range(n_blocks):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool,
                                  capture_error_mode="thread_local"):
                self.outputs.append(next(blocks))
            pool = graph.pool()
            self.graphs.append(graph)
            self.launches.append(cuda_build.take_captured())
            counter.add(kind + "_graph_capture")
        self.replayed = kind + "_graph_replay"

    def replay(self, inputs: Sequence[torch.Tensor]) -> Iterator:
        """Copies the inputs in, then yields each block's outputs once its
        graph has been replayed (on the current stream)."""
        for buf, t in zip(self.inputs, inputs):
            buf.copy_(t)
        for graph, out, launches in zip(self.graphs, self.outputs,
                                        self.launches):
            graph.replay()
            cuda_build.add_replays(launches, 1)
            self.counter.add(self.replayed)
            yield out


class GraphCache:
    """A module's ``BlockGraphs`` by key: None after a key's first (eager)
    call, then its graphs."""

    def __init__(self, counter, kind: str):
        self.counter, self.kind = counter, kind
        self.graphs: dict = {}

    def eager(self, blocks: Iterator) -> Iterator:
        """``blocks`` run eagerly on a card, counted."""
        for block in blocks:
            self.counter.add(self.kind + "_eager")
            yield block

    def run(self, key: Hashable, build: Callable[..., Iterator],
            n_blocks: int, inputs: Sequence[torch.Tensor]
            ) -> Tuple[Iterator, bool]:
        """The blocks of ``build(*inputs)`` for a call of ``key``, and
        whether they are graph replays."""
        if key not in self.graphs:
            self.graphs[key] = None
            return self.eager(build(*inputs)), False
        graphs = self.graphs[key]
        if graphs is None:
            graphs = self.graphs[key] = BlockGraphs(
                build, n_blocks, inputs, self.counter, self.kind)
        return graphs.replay(inputs), True

    def clear(self) -> None:
        self.graphs.clear()

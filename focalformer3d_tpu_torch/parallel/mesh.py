"""Data parallelism over processes, one card a process.

Port of ``focalformer3d_tpu/parallel/mesh.py``. The JAX package trains
data-parallel by making the batch axis global under ``jit`` over a 1-D
``data`` mesh: XLA inserts the gradient all-reduce, batch norm sees the
global batch and every loss normaliser is a sum over it. In PyTorch one
process drives one card and holds only its own shard of the batch, so the
port issues those collectives itself, through this module:

- SyncBN: ``models/layers.apply_bn`` sums its statistics over the ranks
  (``all_reduce_sum``, differentiable: its backward sums the cotangents);
- the loss normalisers: ``training/losses.detection_loss`` sums its raw
  counts over the ranks in one collective (``all_reduce_``);
- the gradients: ``training/train_step.make_train_step`` sums them over the
  ranks in one flat buffer (``all_reduce_flat_``) before the update; the
  step takes its gradients with ``torch.autograd.grad``, which a
  ``DistributedDataParallel`` wrapper would not see;
- the logged metrics (``train_step.global_metrics``), at the log interval.

Every rank must issue the same collectives in the same order, or the job
hangs: no collective may depend on a rank's data. They run whenever the
process has joined a group (``active``), a group of one rank included (a
one-card ``torchrun``), and never outside one, where they leave their
inputs as they are.

No counterpart, by design: ``make_mesh``, ``make_global_mesh``,
``shard_batch``, ``shard_global_batch`` and ``replicate``. A process holds
its shard and nothing more; ``broadcast_module`` (rank 0's parameters and
buffers to every rank, once at the start) does ``replicate``'s job.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Sequence

import numpy as np
import torch
import torch.distributed as dist

# collectives issued since ``reset_collectives``, by the caller's kind
# ("bn", "loss", "grad", "metrics"); a differentiable one runs once more in
# the backward, which this does not count
_COUNTS: Dict[str, int] = {}


def init_distributed(backend: str, init_method: str = "env://") -> bool:
    """Join the process group that the environment describes, as torchrun
    sets it up (``WORLD_SIZE``, ``RANK``; ``MASTER_ADDR`` and
    ``MASTER_PORT`` for the default ``env://`` rendezvous). Returns False,
    and joins nothing, where ``WORLD_SIZE`` is unset (the JAX function's
    ``False`` without a coordinator). A failure to join raises: no caller
    goes on at world size 1."""
    if "WORLD_SIZE" not in os.environ:
        return False
    dist.init_process_group(backend, init_method=init_method,
                            world_size=int(os.environ["WORLD_SIZE"]),
                            rank=int(os.environ["RANK"]))
    return True


def shutdown() -> None:
    """Leave the process group (after a barrier, so that no rank leaves
    while another still waits in a collective); nothing outside one."""
    if active():
        dist.barrier()
        dist.destroy_process_group()


def active() -> bool:
    """Whether this process has joined a process group."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def rank() -> int:
    return dist.get_rank() if active() else 0


def is_main_process() -> bool:
    return rank() == 0


def shard(indices: Sequence[int]) -> Sequence[int]:
    """This rank's shard of a dataset's indices: ``indices[rank::world]``,
    as the JAX CLI takes ``[process_index::process_count]``."""
    return indices[rank()::world_size()]


def _count(kind: str) -> None:
    _COUNTS[kind] = _COUNTS.get(kind, 0) + 1


def collectives() -> Dict[str, int]:
    return dict(_COUNTS)


def reset_collectives() -> None:
    _COUNTS.clear()


def all_reduce_sum(t: torch.Tensor, kind: str) -> torch.Tensor:
    """The sum of ``t`` over the ranks, differentiable (the backward sums
    the cotangents over the ranks); ``t`` itself outside a group."""
    if not active():
        return t
    import torch.distributed.nn.functional as dist_fn

    _count(kind)
    return dist_fn.all_reduce(t)


def all_reduce_(t: torch.Tensor, kind: str,
                op: dist.ReduceOp = dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over the ranks in place (no autograd); returns it."""
    if active():
        _count(kind)
        dist.all_reduce(t, op=op)
    return t


def all_reduce_flat_(tensors: List[torch.Tensor], kind: str) -> None:
    """Sum every tensor of the list over the ranks in place, through one
    flat buffer (one collective; the tensors share a device and dtype)."""
    if not active() or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce_(flat, kind)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Every parameter and buffer of ``module`` from rank ``src`` to every
    rank, in place: the counterpart of the JAX ``replicate``."""
    if not active():
        return
    for t in module.state_dict().values():
        dist.broadcast(t, src)


def gather_to_host(tree: Any) -> Any:
    """Every rank's tensors of ``tree`` (nested dicts, lists and tuples),
    concatenated over the ranks along the first axis (0-d tensors
    stacked), as numpy on every rank: the multi-process gather of the JAX
    function, which fetches the global array. Shapes must agree across
    ranks. gloo gathers only tensors on the host, so under gloo they move
    to the CPU first; under NCCL they gather on the card."""
    if isinstance(tree, dict):
        return {k: gather_to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_to_host(v) for v in tree)
    x = torch.as_tensor(tree).detach()
    if not active():
        parts = [x]
    else:
        if dist.get_backend() == "gloo":
            x = x.cpu()
        parts = [torch.empty_like(x) for _ in range(world_size())]
        dist.all_gather(parts, x.contiguous())
    out = torch.stack(parts) if x.dim() == 0 else torch.cat(parts)
    return np.asarray(out.cpu())

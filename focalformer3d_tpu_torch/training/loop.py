"""Epoch-based training loop: data feeding, logging, checkpointing.

Port of ``focalformer3d_tpu/training/loop.run_training``, the runtime
counterpart of mmcv's EpochBasedRunner + hooks as the reference uses them
(tools/train.py:295-302; hooks configured at FocalFormer3D_L.py:344-369):

- per epoch, host batches from ``batch_iter_fn(epoch)`` through a
  prefetching thread (``data/prefetch.py``), moved to the device in the
  main thread;
- one ``train_step`` per batch (cyclic LR / momentum and the grad clip live
  in the optimizer, ``training/optim.py``);
- every ``log_interval`` steps the metrics are read to the host (the only
  sync the loop adds) and written as a text line and a JSON record with the
  JAX loop's keys, and to TensorBoard when ``torch.utils.tensorboard``
  imports;
- a checkpoint per epoch (``training/checkpoint.py``) with ``keep_last``
  pruning.

Randomness: JAX folds the step into one key per run
(``train_step.py:149-151``), so a resumed run draws what an unbroken run
would. Here the step's ``torch.Generator`` is re-seeded from ``(seed + 1,
step)`` before every step (``step_seed``) to the same end.

Hooks: before each epoch the loop calls ``h.before_train_epoch(epoch,
h.pipeline)`` of every hook, as the JAX loop does; ``Fading`` (the
reference's core/hook/fading.py:6-16) drops the ``ObjectSample`` GT-paste
stage from a dataset pipeline from ``fade_epoch`` on.
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ..data.prefetch import prefetch
from . import checkpoint as ckpt
from .optim import OptState

# metrics of the port's step with no counterpart in the JAX step's (the
# auction's loop count): kept out of the log records, whose keys are JAX's
NOT_LOGGED = ("assign_iterations",)


class Fading:
    """Removes the ObjectSample stage from a Compose at fade_epoch."""

    def __init__(self, fade_epoch: int):
        self.fade_epoch = fade_epoch

    def before_train_epoch(self, epoch: int, pipeline) -> None:
        if pipeline is None or epoch < self.fade_epoch:
            return
        from ..data.nuscenes import ObjectSample

        pipeline.transforms = [
            t for t in pipeline.transforms if not isinstance(t, ObjectSample)
        ]


def step_seed(seed: int, step: int) -> int:
    """The generator seed of training step ``step`` of a run seeded with
    ``seed``: a function of both alone, so a resumed run draws as an
    unbroken one."""
    return int(np.random.SeedSequence([seed + 1, step]).generate_state(
        1, np.uint64)[0])


def to_device(batch: Dict[str, np.ndarray], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items()}


def run_training(
    train_step: Callable,
    model: torch.nn.Module,
    opt_state: OptState,
    batch_iter_fn: Callable[[int], Iterable[Dict[str, np.ndarray]]],
    *,
    epochs: int,
    device: torch.device,
    start_epoch: int = 0,
    seed: int = 0,
    work_dir: Optional[str] = None,
    keep_last: Optional[int] = None,
    log_interval: int = 50,
    log_fn: Callable[[str], None] = print,
    hooks: Iterable = (),
    json_log_path: Optional[str] = None,
    save_checkpoints: bool = True,
    tensorboard_dir: Optional[str] = None,
) -> None:
    """Train ``model`` and ``opt_state`` in place from ``start_epoch`` to
    ``epochs``. ``train_step(model, opt_state, batch, generator)`` is
    ``train_step.make_train_step``'s; ``batch_iter_fn(epoch)`` yields host
    (numpy) batches; each of ``hooks`` is called before every epoch
    (``Fading``)."""
    gen = torch.Generator(device=device)
    jlog = None
    if json_log_path:
        os.makedirs(os.path.dirname(json_log_path) or ".", exist_ok=True)
        jlog = open(json_log_path, "a")
    tb = None
    if tensorboard_dir:
        # reference parity: TensorboardLoggerHook (FocalFormer3D_L.py:
        # 356-359); optional, as in the JAX loop
        try:
            from torch.utils.tensorboard import SummaryWriter

            tb = SummaryWriter(tensorboard_dir)
        except ImportError as e:
            log_fn(f"tensorboard unavailable: {e}")

    def jwrite(rec):
        if jlog is not None:
            jlog.write(json.dumps(rec) + "\n")
            jlog.flush()
        if tb is not None and rec.get("mode") == "train":
            gstep = rec["epoch"] * 1000000 + rec["iter"]
            for k, v in rec.items():
                if isinstance(v, float):
                    tb.add_scalar(f"train/{k}", v, gstep)

    try:
        for epoch in range(start_epoch, epochs):
            for h in hooks:
                h.before_train_epoch(epoch, getattr(h, "pipeline", None))
            t_ep = time.time()
            n_iter = 0
            t_it = time.time()
            for host_batch in prefetch(batch_iter_fn(epoch)):
                batch = to_device(host_batch, device)
                gen.manual_seed(step_seed(seed, opt_state.count))
                metrics = train_step(model, opt_state, batch, gen)
                n_iter += 1
                if n_iter % log_interval == 0:
                    metrics = {k: float(v) for k, v in metrics.items()
                               if k not in NOT_LOGGED}
                    dt = (time.time() - t_it) / log_interval
                    t_it = time.time()
                    msg = " ".join(f"{k}={v:.4f}"
                                   for k, v in sorted(metrics.items()))
                    log_fn(f"epoch {epoch} iter {n_iter} ({dt:.2f}s/it) "
                           f"{msg}")
                    jwrite({"mode": "train", "epoch": epoch, "iter": n_iter,
                            "time": dt, **metrics})
            log_fn(f"epoch {epoch} done in {(time.time() - t_ep) / 60:.1f} "
                   f"min ({n_iter} iters)")
            jwrite({"mode": "epoch", "epoch": epoch, "iters": n_iter,
                    "minutes": (time.time() - t_ep) / 60})
            if work_dir and save_checkpoints:
                path = ckpt.save_checkpoint(work_dir, model, opt_state,
                                            epoch + 1, keep_last=keep_last)
                log_fn(f"saved {path}")
    finally:
        if jlog is not None:
            jlog.close()
        if tb is not None:
            tb.close()

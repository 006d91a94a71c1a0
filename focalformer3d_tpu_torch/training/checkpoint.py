"""Checkpoints: save / restore with epoch retention, auto-resume and partial
loads.

Port of ``focalformer3d_tpu/training/checkpoint.py`` with ``torch.save`` in
place of orbax. The layout on disk is the same: one directory
``work_dir/epoch_{N}/`` per saved epoch (the reference's CheckpointHook +
auto-resume glob, tools/train.py:156-166), holding ``state.pt``:

- ``state_dict``: the model's reference-keyed state dict (parameters and
  batch-norm buffers), on the CPU;
- ``opt_state``: the AdamW moments keyed by parameter name (``mu``, ``nu``)
  and the update ``count``;
- ``step``: the training step (the update count);
- ``meta``: the caller's dict, if any.

Only tensors, dicts, lists, numbers and strings are saved, so
``torch.load(..., weights_only=True)`` reads it. ``load_partial_params``
and ``img_branch_filter`` (the reference's ``load_from`` / ``load_img_from``,
tools/train.py:268-293) work on state dicts keyed by reference names.
"""
from __future__ import annotations

import os
import re
import shutil
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence

import torch

from .optim import OptState

STATE_FILE = "state.pt"


def _cpu(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def _opt_names(model: torch.nn.Module, opt_state: OptState):
    if opt_state.names is not None:
        return opt_state.names
    return [n for n, _ in model.named_parameters()]


def save_checkpoint(work_dir: str, model: torch.nn.Module,
                    opt_state: OptState, epoch: int,
                    keep_last: Optional[int] = None,
                    meta: Optional[dict] = None) -> str:
    """Write ``work_dir/epoch_{epoch}/state.pt`` (through a temporary file,
    then renamed); with ``keep_last``, remove all but the newest
    ``keep_last`` epochs. Returns the epoch directory."""
    work = Path(work_dir).absolute()
    path = work / f"epoch_{epoch}"
    path.mkdir(parents=True, exist_ok=True)
    names = _opt_names(model, opt_state)
    payload = {
        "state_dict": {k: _cpu(v) for k, v in model.state_dict().items()},
        "opt_state": {"mu": {n: _cpu(t) for n, t in zip(names,
                                                        opt_state.mu)},
                      "nu": {n: _cpu(t) for n, t in zip(names,
                                                        opt_state.nu)},
                      "count": int(opt_state.count)},
        "step": int(opt_state.count),
        "meta": dict(meta or {}),
    }
    tmp = path / f"{STATE_FILE}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path / STATE_FILE)
    if keep_last is not None:
        for e in list_epochs(work_dir)[:-keep_last]:
            shutil.rmtree(work / f"epoch_{e}", ignore_errors=True)
    return str(path)


def list_epochs(work_dir: str) -> Sequence[int]:
    work = Path(work_dir)
    if not work.exists():
        return []
    out = []
    for p in work.iterdir():
        m = re.fullmatch(r"epoch_(\d+)", p.name)
        if m and p.is_dir():
            out.append(int(m.group(1)))
    return sorted(out)


def load_payload(path: str) -> dict:
    """The saved dict of an ``epoch_{N}`` directory, tensors on the CPU."""
    return torch.load(Path(path) / STATE_FILE, map_location="cpu",
                      weights_only=True)


def restore_checkpoint(path: str, model: torch.nn.Module,
                       opt_state: Optional[OptState] = None) -> dict:
    """Load an ``epoch_{N}`` directory into ``model`` (strict) and, if
    given, into ``opt_state`` (in place, matched by parameter name; its
    count becomes the saved one). Returns the payload."""
    payload = load_payload(path)
    model.load_state_dict(payload["state_dict"], strict=True)
    if opt_state is not None:
        saved = payload["opt_state"]
        names = _opt_names(model, opt_state)
        missing = [n for n in names if n not in saved["mu"]]
        if missing:
            raise KeyError(f"checkpoint {path} has no optimizer state for "
                           f"{missing[:5]}")
        with torch.no_grad():
            for n, mu, nu in zip(names, opt_state.mu, opt_state.nu):
                mu.copy_(saved["mu"][n])
                nu.copy_(saved["nu"][n])
        opt_state.count = int(saved["count"])
    return payload


def auto_resume(work_dir: str, model: torch.nn.Module,
                opt_state: Optional[OptState] = None) -> int:
    """Restore the newest ``epoch_*`` of ``work_dir`` into ``model`` and
    ``opt_state``, if there is one; returns its epoch, else 0. Mirrors the
    reference auto-resume glob (tools/train.py:156-166)."""
    epochs = list_epochs(work_dir)
    if not epochs:
        return 0
    restore_checkpoint(str(Path(work_dir) / f"epoch_{epochs[-1]}"), model,
                       opt_state)
    return epochs[-1]


def load_partial_params(params: Dict[str, torch.Tensor],
                        source: Dict[str, torch.Tensor],
                        key_filter: Optional[Callable[[str], bool]] = None
                        ) -> Dict[str, torch.Tensor]:
    """Non-strict partial load: a copy of ``params`` where every key that
    ``source`` also has with the same shape (and that passes
    ``key_filter(key)``) takes the source's value, in the target's dtype
    and device; the rest stay."""
    out = dict(params)
    for k, v in params.items():
        src = source.get(k)
        if src is None or (key_filter is not None and not key_filter(k)):
            continue
        if tuple(src.shape) == tuple(v.shape):
            out[k] = src.to(dtype=v.dtype, device=v.device)
    return out


def img_branch_filter(key: str) -> bool:
    """Selects the image branch (``load_img_from`` semantics)."""
    return key.startswith(("img_backbone", "img_neck", "imgpts_neck.cam_lss"))

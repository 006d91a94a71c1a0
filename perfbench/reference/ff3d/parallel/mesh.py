"""No process group in the reference: every collective is the identity."""
from __future__ import annotations

import torch


def active() -> bool:
    return False


def all_reduce_sum(t: torch.Tensor, kind: str) -> torch.Tensor:
    return t


def all_reduce_(t: torch.Tensor, kind: str, op=None) -> torch.Tensor:
    return t

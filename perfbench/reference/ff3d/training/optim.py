"""Optimizer: global-norm clip + AdamW with cyclic LR and cyclic beta1.

Port of ``focalformer3d_tpu/training/optim.py``, which chains optax's
``clip_by_global_norm`` and ``adamw`` under ``inject_hyperparams``. The
transformation here does the same arithmetic on a list of parameters:

- clip: ``g / |g| * max_norm`` only where the global norm is not below
  ``max_norm`` (optax's trigger ``norm < max_norm`` keeps g as it is; no
  epsilon is added, unlike ``torch.nn.utils.clip_grad_norm_``); reading
  the trigger is one host sync per step;
- AdamW: ``mu = b1 mu + (1 - b1) g``, ``nu = b2 nu + (1 - b2) g^2``,
  bias corrections with the step's own b1 (as ``inject_hyperparams`` feeds
  it), ``p -= lr (mu_hat / (sqrt(nu_hat) + eps) + wd p)``; weight decay
  on every parameter, as optax's ``adamw`` without a mask;
- LR and b1 of update i from ``cyclic_schedule`` at count i, or held at
  their base values (``cyclic=False``).

Frozen parameters (``requires_grad=False``, which the detector sets from
the config's freeze flags; ``optax.masked`` around the whole chain in JAX)
are left out of the transformation altogether: ``init`` of named
parameters keeps only those that require a gradient (the train step
refuses a state that holds a frozen one), so the frozen ones get no
update, no weight decay and no moments, and their gradients take no share
of the clip's global norm. Unlike ``optax.masked``, which passes a masked-out
leaf's gradient through as its update (so ``apply_updates`` adds it to a
frozen parameter that still gets one), nothing here touches them.

The moments live in an ``OptState`` updated in place; the updates run as
multi-tensor (``torch._foreach_*``) ops.
"""
from __future__ import annotations

import dataclasses
import math
from typing import (Callable, Iterable, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch


def cyclic_schedule(base: float, total_steps: int,
                    target_ratio: Tuple[float, float] = (10.0, 1e-4),
                    step_ratio_up: float = 0.4) -> Callable[[int], float]:
    """mmcv cyclic updater with cosine annealing: up from ``base`` to
    ``base * target_ratio[0]`` over the first ``step_ratio_up`` of the
    steps, then down to ``base * target_ratio[1]``. Evaluated in float32,
    as the JAX schedule."""
    f32 = np.float32
    up_steps = int(total_steps * step_ratio_up)
    down_steps = max(total_steps - up_steps, 1)

    def cos_anneal(start, end, pct):
        return f32(end) + f32(start - end) * (
            np.cos(f32(math.pi) * pct) + f32(1)) / f32(2)

    def schedule(step: int) -> float:
        step = min(step, total_steps)
        pct_up = f32(np.clip(f32(step) / f32(max(up_steps, 1)), 0, 1))
        pct_down = f32(np.clip(f32(step - up_steps) / f32(down_steps), 0, 1))
        if step < up_steps:
            return float(cos_anneal(base, base * target_ratio[0], pct_up))
        return float(cos_anneal(base * target_ratio[0],
                                base * target_ratio[1], pct_down))

    return schedule


@dataclasses.dataclass
class OptState:
    """AdamW moments per updated parameter and the update count. ``names``
    are the updated parameters' names in order when the state was made from
    named parameters (``ClipAdamW.init``), else None (every parameter, in
    the model's order)."""

    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    count: int = 0
    names: Optional[List[str]] = None

    def params(self, model: torch.nn.Module) -> List[torch.Tensor]:
        """The parameters of ``model`` this state updates, in its order."""
        if self.names is None:
            return list(model.parameters())
        named = dict(model.named_parameters())
        return [named[n] for n in self.names]


Params = Union[Iterable[torch.Tensor], Iterable[Tuple[str, torch.Tensor]]]


@dataclasses.dataclass(frozen=True)
class ClipAdamW:
    """``clip_by_global_norm(grad_clip)`` then AdamW, with scheduled LR and
    b1 (callables of the update count)."""

    lr: Callable[[int], float]
    b1: Callable[[int], float]
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 0.1

    def init(self, params: Params) -> OptState:
        """Zero moments for ``params``: tensors (every one is updated), or
        (name, tensor) pairs such as ``model.named_parameters()``, of which
        those that require a gradient are kept and named in the state."""
        params = list(params)
        names = None
        if params and isinstance(params[0], tuple):
            names = [n for n, p in params if p.requires_grad]
            params = [p for _, p in params if p.requires_grad]
        return OptState([torch.zeros_like(p) for p in params],
                        [torch.zeros_like(p) for p in params], names=names)

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: OptState,
               params: Sequence[torch.Tensor]) -> torch.Tensor:
        """Update ``state`` and ``params`` in place from the clipped
        ``grads`` (which are left as they are); returns the global norm
        before clipping."""
        params = list(params)
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        if not bool(norm < self.grad_clip):  # optax: g / norm * max_norm
            grads = torch._foreach_div(grads, norm)
            torch._foreach_mul_(grads, self.grad_clip)
        lr, b1 = self.lr(state.count), self.b1(state.count)
        b2 = self.b2
        torch._foreach_mul_(state.mu, b1)
        torch._foreach_add_(state.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_addcmul_(state.nu, grads, grads, value=1.0 - b2)
        state.count += 1
        denom = torch._foreach_div(state.nu, 1.0 - b2 ** state.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(state.mu, 1.0 - b1 ** state.count)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(upd, params, alpha=self.weight_decay)
        torch._foreach_add_(params, upd, alpha=-lr)
        return norm


def make_optimizer(base_lr: float = 1e-4, weight_decay: float = 0.01,
                   total_steps: int = 10000, grad_clip: float = 0.1,
                   lr_target_ratio: Tuple[float, float] = (10.0, 1e-4),
                   momentum_target_ratio: Tuple[float, float] = (
                       0.8947368421052632, 1.0),
                   step_ratio_up: float = 0.4,
                   base_b1: float = 0.9, cyclic: bool = True
                   ) -> ClipAdamW:
    """The reference recipe (FocalFormer3D_L: AdamW lr 1e-4, wd 0.01, clip
    0.1, one-cycle LR (10, 1e-4) with the matching cyclic momentum on
    beta1), as the JAX ``make_optimizer``. ``cyclic=False`` holds LR and b1
    at ``base_lr`` and ``base_b1``. Frozen parameters are left out by
    ``init`` (see the module's docstring)."""
    if cyclic:
        lr = cyclic_schedule(base_lr, total_steps, lr_target_ratio,
                             step_ratio_up)
        b1 = cyclic_schedule(base_b1, total_steps, momentum_target_ratio,
                             step_ratio_up)
    else:
        def lr(_step):
            return base_lr

        def b1(_step):
            return base_b1
    return ClipAdamW(lr=lr, b1=b1, weight_decay=weight_decay,
                     grad_clip=grad_clip)

"""One training step of the detector.

Port of ``focalformer3d_tpu/training/train_step.make_train_step``: the
training voxelization (``preprocess_points(train=True)``), the forward in
training mode (batch statistics, running averages updated as flax does,
the head's denoising GT groups and dropouts), the Hungarian-matched
``detection_loss``, the backward (on engine ``cuda``: K1 on the transposed
rulebooks for dx and the dW kernel on the sparse levels), and the
clipped, scheduled AdamW update (``training/optim.py``).

Branch freezing, the training loop and checkpoints are not ported yet.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..configs import DetectorConfig
from ..models.detector import FocalFormer3D, preprocess_points
from .losses import LossConfig, detection_loss
from .optim import ClipAdamW, OptState

PHASES = ("voxelize", "forward", "loss", "backward", "optimizer")


def make_train_step(cfg: DetectorConfig, lcfg: LossConfig, tx: ClipAdamW):
    """Returns ``train_step(model, opt_state, batch, generator, mark=None)
    -> metrics``.

    ``model`` is a ``FocalFormer3D`` of ``cfg`` whose parameters, in
    ``model.parameters()`` order, ``opt_state`` (``tx.init``) was made for;
    both are updated in place. ``batch`` holds points (B, N, 5),
    points_mask (B, N), gt_boxes (B, G, 9), gt_labels (B, G) int32 and
    gt_valid (B, G) on the model's device; ``generator`` (on that device)
    draws the dropouts and the GT-group noise. ``mark(name)``, if given,
    is called after each phase of ``PHASES``. Metrics are the loss terms
    of ``detection_loss`` (detached), ``grad_norm`` (the global norm before
    clipping, as the JAX step reports it) and ``assign_iterations``."""

    def train_step(model: FocalFormer3D, opt_state: OptState,
                   batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator],
                   mark: Optional[Callable[[str], None]] = None
                   ) -> Dict[str, torch.Tensor]:
        mark = mark or (lambda _: None)
        model.train()
        with torch.no_grad():
            vox = preprocess_points(cfg, batch["points"],
                                    batch["points_mask"], train=True)
        mark("voxelize")
        with torch.enable_grad():  # whatever the caller's grad mode
            out = model(vox, batch["gt_boxes"], batch["gt_labels"],
                        batch["gt_valid"], generator)
            mark("forward")
            loss, metrics = detection_loss(cfg.decoder, lcfg, out,
                                           batch["gt_boxes"],
                                           batch["gt_labels"],
                                           batch["gt_valid"])
            mark("loss")
            params = list(model.parameters())
            for p in params:
                p.grad = None
            loss.backward()
        mark("backward")
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        grad_norm = tx.update(grads, opt_state, params)
        mark("optimizer")
        metrics = {k: v.detach() if torch.is_tensor(v) else v
                   for k, v in metrics.items()}
        metrics["grad_norm"] = grad_norm
        return metrics

    return train_step

"""The reference training step: the port's ``make_train_step`` on the
plain path, written against the frozen copy.

The training voxelization, the forward in training mode (batch statistics,
the head's denoising groups and dropouts from ``generator``), the
Hungarian-matched detection loss, the gradient of every parameter that
requires one, and the clipped, scheduled AdamW update, all in the dtype
the model computes in.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .ff3d.models import grid_mask as gm
from .ff3d.models.detector import FocalFormer3D, preprocess_points
from .ff3d.training.losses import detection_loss
from .ff3d.training.optim import ClipAdamW, OptState

IMG_KEYS = ("imgs", "lidar2img", "img_aug", "bev_aug")


def train_step(model: FocalFormer3D, lcfg, tx: ClipAdamW, state: OptState,
               batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator],
               select_heatmaps: Optional[torch.Tensor] = None
               ) -> Dict[str, object]:
    """One step in place; returns the loss, its heatmap term, the forward's
    dense heatmap logits, the clipped gradient the
    optimizer took (by parameter name) and the global norm.
    ``select_heatmaps``: the heatmap logits the head picks its queries
    from (``FocalDecoder.forward``), else its own."""
    cfg = model.cfg
    model.train()
    vox = None
    if cfg.input_pts:
        with torch.no_grad():
            vox = preprocess_points(cfg, batch["points"],
                                    batch["points_mask"], train=True)
    img = ({k: batch[k] for k in IMG_KEYS if k in batch}
           if cfg.input_img else None)
    if img is not None and cfg.use_grid_mask:
        img["imgs"] = gm.grid_mask(generator, img["imgs"])
    params = state.params(model)
    with torch.enable_grad():
        out = model(vox, batch["gt_boxes"], batch["gt_labels"],
                    batch["gt_valid"], generator, img_data=img,
                    select_heatmaps=select_heatmaps)
        loss, terms = detection_loss(cfg.decoder, lcfg, out,
                                     batch["gt_boxes"], batch["gt_labels"],
                                     batch["gt_valid"])
        grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [g if g is not None else torch.zeros_like(p)
             for p, g in zip(params, grads)]
    norm = tx.update(grads, state, params)
    clip = min(1.0, tx.grad_clip / float(norm))
    return {"loss": float(loss.detach()),
            "loss_heatmap": float(terms["loss_heatmap"].detach()),
            "dense_heatmap": out["dense_heatmap"].detach().float(),
            "grad": {n: g * clip for n, g in zip(state.names, grads)},
            "norm": float(norm)}

"""Training and eval steps of the detector.

Port of ``focalformer3d_tpu/training/train_step.py``: ``make_train_step``
(the training voxelization ``preprocess_points(train=True)``, the forward
in training mode (batch statistics, running averages updated as flax does,
the head's denoising GT groups and dropouts), the Hungarian-matched
``detection_loss``, the backward, and the clipped, scheduled AdamW update
of ``training/optim.py``), ``make_eval_step`` and the branch-freeze masks.

The sparse encoder's engine decides which kernels a step launches
(``models/sparse_encoder.py``; ``kernel_launches`` counts them). Per
FocalFormer3D_L step (21 sparse convs: conv_input, per level L0-L2 four
submanifold convs and the strided one, L3's four and conv_out; conv_input's
voxel features need no dx), in the keys of ``kernel_launches``:

- ``cuda`` (dense from L3): K1 ``forward`` 16, ``dx`` 15 (K1 on the
  transposed rulebooks), ``wgrad`` 16 (the dW kernel); the index build's
  ``index_table`` 1, ``index_downsample`` 3 and ``plan`` 6 (K2, one per
  conv geometry of the batch);
- ``cuda_zrun`` (dense from L3): ``zrun`` 16 (K3), ``dx`` 15 and ``wgrad``
  16 on the rulebooks its codes encode; ``index_table`` 1,
  ``index_downsample`` 3;
- ``cuda_mxu`` (all-sparse): ``plan`` 8, ``index_table`` 1, K1 ``forward``
  21, ``dx`` 20, ``wgrad`` 21;
- a frozen point branch (``freeze_pts``) runs at eval: one eval scan's
  forward launches (on ``cuda`` ``forward`` 11, ``plan`` 4,
  ``index_table`` 1, ``index_downsample`` 2), no ``dx``, no ``wgrad``;
- ``plain``: none.

A camera config's batch also carries ``imgs``, ``lidar2img``, ``img_aug``
and ``bev_aug`` (``_img_data_from_batch``); with ``use_grid_mask`` the
step masks the images with ``models/grid_mask``, drawn from the step's
generator; without the point branch there is no voxelization.

Branch freezing follows the reference's ``requires_grad=False`` +
``.eval()`` on the img / cam_lss / pts branches (detectors/
focalformer3d.py:80-131): the detector runs a frozen point branch in
inference mode and without autograd and builds its frozen parameters with
``requires_grad=False`` (``models/detector.py``, whose ``trainable_mask``
this module re-exports, as the JAX module has it); the optimizer state
holds only the parameters that require a gradient, and the step refuses
one that holds a frozen parameter, so none of them changes. The mask works
on the reference state-dict keys (the port's parameter names), where the
JAX mask works on flax paths; the two agree leaf for leaf through the
weight bridge (``utils/jax_keys``).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..configs import DetectorConfig
from ..models import grid_mask as gm
from ..models.detector import (FocalFormer3D, preprocess_points,
                               trainable_mask)
from ..models.focal_decoder import DECODER_BLOCKS
from ..models.sparse_encoder import INDEX_BLOCKS
from ..ops import plan_builder_cuda, sparse_conv_cuda, sparse_conv_zrun_cuda
from ..parallel import mesh
from ..utils.profiler import span
from .losses import LossConfig, detection_loss
from .optim import ClipAdamW, OptState

__all__ = ["DP_PHASE", "PHASES", "global_metrics", "kernel_launches",
           "make_eval_step", "make_train_step", "reset_kernel_launches",
           "trainable_mask"]

PHASES = ("voxelize", "forward", "loss", "backward", "optimizer")
# the phase a step marks after "backward" under a process group: the
# gradient all-reduce
DP_PHASE = "gradient all-reduce"
# metrics that are already global on every rank (``global_metrics``)
_GLOBAL = ("num_pos", "grad_norm")
_IMG_KEYS = ("imgs", "lidar2img", "img_aug", "bev_aug")


def kernel_launches() -> Dict[str, int]:
    """Launches of the model-path kernels since ``reset_kernel_launches``:
    K1 ``forward``, ``dx`` and ``wgrad`` (``ops/sparse_conv_cuda``), K2
    ``plan`` (``ops/plan_builder_cuda``) and K3 ``zrun``
    (``ops/sparse_conv_zrun_cuda``); the index build's batched
    ``index_table`` and ``index_downsample`` calls (``ops/plan_builder_cuda``,
    a memset and three kernels each); then the sparse encoder's index-build
    blocks on a card (``sparse_encoder.INDEX_BLOCKS``):
    ``index_graph_replay``, ``index_graph_capture`` and ``index_eager``;
    then the head's blocks on a card (``focal_decoder.DECODER_BLOCKS``):
    ``decoder_graph_replay``, ``decoder_graph_capture`` and
    ``decoder_eager``."""
    out = {k: sparse_conv_cuda.launch_count(k)
           for k in ("forward", "dx", "wgrad")}
    out["plan"] = plan_builder_cuda.launch_count()
    out["zrun"] = sparse_conv_zrun_cuda.launch_count()
    out["index_table"] = plan_builder_cuda.launch_count("table")
    out["index_downsample"] = plan_builder_cuda.launch_count("downsample")
    out.update(INDEX_BLOCKS.counts)
    out.update(DECODER_BLOCKS.counts)
    return out


def reset_kernel_launches() -> None:
    for mod in (plan_builder_cuda, sparse_conv_cuda, sparse_conv_zrun_cuda):
        mod.reset_launch_count()
    INDEX_BLOCKS.reset()
    DECODER_BLOCKS.reset()


def _img_data_from_batch(batch: Dict[str, torch.Tensor]
                         ) -> Optional[Dict[str, torch.Tensor]]:
    if "imgs" not in batch:
        return None
    return {k: batch[k] for k in _IMG_KEYS if k in batch}


def _inputs(cfg: DetectorConfig, batch: Dict[str, torch.Tensor],
            train: bool):
    """(voxel data or None, camera data or None) of a batch."""
    vox = None
    if cfg.input_pts:
        with torch.no_grad():
            vox = preprocess_points(cfg, batch["points"],
                                    batch["points_mask"], train=train)
    img_data = _img_data_from_batch(batch) if cfg.input_img else None
    return vox, img_data


def make_train_step(cfg: DetectorConfig, lcfg: LossConfig, tx: ClipAdamW):
    """Returns ``train_step(model, opt_state, batch, generator, mark=None)
    -> metrics``.

    ``model`` is a ``FocalFormer3D`` of ``cfg``; ``opt_state`` (``tx.init``
    of its parameters or named parameters, which keeps those that require
    a gradient) names the parameters it updates: a frozen one among them
    raises. Both are updated in place. ``batch`` holds points (B, N, 5),
    points_mask (B, N), gt_boxes (B, G, 9), gt_labels (B, G) int32 and
    gt_valid (B, G) on the model's device (and, for a camera config, the
    camera arrays of ``_img_data_from_batch``); ``generator`` (on that
    device) draws the dropouts, the GT-group noise and the grid mask.
    ``mark(name)``, if given, is called after each phase of ``PHASES``
    (and after ``DP_PHASE``, between "backward" and "optimizer", under a
    process group). Each phase runs in a ``utils/profiler`` span, which
    calls ``mark``: "inputs" (phase "voxelize": the voxelization and the
    grid mask), "forward", "loss", "backward", "allreduce" (``DP_PHASE``)
    and "optimizer". Metrics are the loss terms of ``detection_loss``
    (detached), ``grad_norm`` (the global norm of the updated parameters'
    gradients before clipping; the JAX step's metric also counts frozen
    leaves' gradients) and ``assign_iterations``.

    Data parallel: under a process group (``parallel/mesh.active``) each
    rank passes its shard of the global batch; batch norm and the loss
    normalisers see the global batch (``parallel/mesh.py``), and the step
    sums the gradients over the ranks before the update, so every rank
    takes the world-size-1 step on the global batch. The loss terms it
    returns are the rank's own shares (``global_metrics`` sums them)."""

    def train_step(model: FocalFormer3D, opt_state: OptState,
                   batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator],
                   mark: Optional[Callable[[str], None]] = None
                   ) -> Dict[str, torch.Tensor]:
        model.train()
        with span("inputs", mark, "voxelize"):
            vox, img_data = _inputs(cfg, batch, True)
            if img_data is not None and cfg.use_grid_mask:
                img_data = dict(img_data)
                img_data["imgs"] = gm.grid_mask(generator, img_data["imgs"])
        with span("forward", mark):
            params = opt_state.params(model)
            if not all(p.requires_grad for p in params):
                raise ValueError("the optimizer state holds a parameter "
                                 "that the config's freeze flags freeze; "
                                 "make it with tx.init of this model's "
                                 "parameters")
            with torch.enable_grad():  # whatever the caller's grad mode
                out = model(vox, batch["gt_boxes"], batch["gt_labels"],
                            batch["gt_valid"], generator, img_data=img_data)
        with span("loss", mark), torch.enable_grad():
            loss, metrics = detection_loss(cfg.decoder, lcfg, out,
                                           batch["gt_boxes"],
                                           batch["gt_labels"],
                                           batch["gt_valid"])
        with span("backward", mark):
            for p in model.parameters():
                p.grad = None
            # only the updated parameters' gradients: a frozen parameter
            # outside the no-grad branch (shared_conv_pts) requires none
            with torch.enable_grad():
                grads = torch.autograd.grad(loss, params, allow_unused=True)
            used = [g is not None for g in grads]
            grads = [g if g is not None else torch.zeros_like(p)
                     for p, g in zip(params, grads)]
        if mesh.active():
            # the sum of the ranks' losses is the objective: sum the
            # gradients, unused ones' zeros too (the reference's
            # find_unused_parameters), so every rank updates alike
            with span("allreduce", mark, DP_PHASE):
                mesh.all_reduce_flat_(grads, "grad")
        with span("optimizer", mark):
            for p, g, u in zip(params, grads, used):
                p.grad = g if u else None
            grad_norm = tx.update(grads, opt_state, params)
        metrics = {k: v.detach() if torch.is_tensor(v) else v
                   for k, v in metrics.items()}
        metrics["grad_norm"] = grad_norm
        return metrics

    return train_step


def global_metrics(metrics: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """A step's metrics over every rank of the process group: the loss
    terms and ``matched_ious`` (each rank's numerators over the global
    normalisers) summed, ``assign_iterations`` the largest; ``num_pos``
    and ``grad_norm`` are global already. Two collectives; outside a
    group the metrics themselves. Every rank must call it at the same
    step."""
    if not mesh.active():
        return metrics
    dev = metrics["loss"].device
    summed = sorted(k for k in metrics
                    if k not in _GLOBAL and k != "assign_iterations")
    vec = mesh.all_reduce_(torch.stack([
        torch.as_tensor(metrics[k], dtype=torch.float32, device=dev)
        for k in summed]), "metrics")
    out = dict(metrics)
    out.update(zip(summed, vec.unbind()))
    if "assign_iterations" in metrics:
        it = torch.as_tensor(metrics["assign_iterations"],
                             dtype=torch.float32, device=dev).reshape(1)
        out["assign_iterations"] = mesh.all_reduce_(
            it, "metrics", torch.distributed.ReduceOp.MAX)[0]
    return out


def make_eval_step(cfg: DetectorConfig, max_out: int = 200):
    """Returns ``eval_step(model, batch) -> boxes``: the inference
    voxelization, the forward in eval mode (with the batch's camera arrays
    for a camera config) and ``get_bboxes``, without autograd."""

    @torch.no_grad()
    def eval_step(model: FocalFormer3D, batch: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        model.eval()
        vox, img_data = _inputs(cfg, batch, False)
        return model.get_bboxes(model(vox, img_data=img_data), max_out)

    return eval_step

"""The system under test: the port's inference entry and training step.

This is all the benchmark takes from the port (``focalformer3d_tpu_torch``):
its kernels' build, its detector built from the stated configuration, the
inference entry ``preprocess_points`` -> ``FocalFormer3D.forward`` ->
``get_bboxes``, the training step of ``training/train_step``, the
forward's and the step's ``mark`` hooks (the stages that the traced runs
split), and its kernel-launch counters.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from .spec import as_run

IMG_KEYS = ("imgs", "lidar2img", "img_aug", "bev_aug")
MAX_OUT = 200


def build_kernels() -> Dict[str, float]:
    """Build the port's model-path CUDA kernels (into its ``_build/``
    directory; a library already built is reused). Seconds per library."""
    from focalformer3d_tpu_torch.ops import (cuda_build, plan_builder_cuda,
                                             sparse_conv_cuda,
                                             sparse_conv_zrun_cuda)

    return cuda_build.build(sparse_conv_cuda.SOURCE,
                            sparse_conv_cuda.WGRAD_SOURCE,
                            plan_builder_cuda.SOURCE,
                            sparse_conv_zrun_cuda.SOURCE)


def kernel_launches() -> Dict[str, int]:
    from focalformer3d_tpu_torch.training.train_step import kernel_launches

    return kernel_launches()


class Program:
    """The port's detector for a stated configuration, on ``device``; at
    inference in the stated inference dtype, in training as the port's
    config computes."""

    def __init__(self, config: dict, device: torch.device, train: bool,
                 engine: Optional[str] = None):
        from focalformer3d_tpu_torch.configs import (get_config,
                                                     with_compute_dtype)
        from focalformer3d_tpu_torch.models.detector import FocalFormer3D

        full = get_config(config["model"])
        cfg = as_run(full["model"], config)
        if not train:
            cfg = with_compute_dtype(cfg, config["precision"]["infer_dtype"])
        if engine:  # another engine than the config's (calibrate --look)
            cfg = dataclasses.replace(cfg, sparse_engine=engine)
        self.cfg, self.lcfg, self.recipe = cfg, full["loss"], full["train"]
        self.device = device
        with torch.device(device):
            self.model = FocalFormer3D(cfg)
        self.model.train(train)

    def state_shapes(self) -> Dict[str, torch.Size]:
        return {k: v.shape for k, v in self.model.state_dict().items()}

    def load(self, state: Dict[str, torch.Tensor]) -> None:
        self.model.load_state_dict(state, strict=True)

    @torch.no_grad()
    def infer(self, scan: Dict[str, torch.Tensor],
              mark: Optional[Callable[[str], None]] = None):
        """The inference entry on a batch of scans: (voxel data, the head's
        outputs, the boxes of ``get_bboxes``)."""
        from focalformer3d_tpu_torch.models.detector import preprocess_points

        mark = mark or (lambda _: None)
        cfg = self.cfg
        vox = preprocess_points(cfg, scan["points"], scan["points_mask"])
        mark("voxelize")
        img = ({k: scan[k] for k in IMG_KEYS} if cfg.input_img else None)
        out = self.model(vox, mark=mark, img_data=img)
        dec = self.model.get_bboxes(out, MAX_OUT)
        mark("get_bboxes")
        return vox, out, dec

    def make_train(self, schedule_steps: int):
        """(optimizer state, step function) of the recipe's optimizer."""
        from focalformer3d_tpu_torch.training import optim
        from focalformer3d_tpu_torch.training.train_step import \
            make_train_step

        r = self.recipe
        self.tx = optim.make_optimizer(
            base_lr=r.base_lr, weight_decay=r.weight_decay,
            total_steps=schedule_steps, grad_clip=r.grad_clip,
            lr_target_ratio=r.lr_target_ratio,
            momentum_target_ratio=r.momentum_target_ratio,
            step_ratio_up=r.step_ratio_up)
        state = self.tx.init(self.model.named_parameters())
        return state, make_train_step(self.cfg, self.lcfg, self.tx)

"""Training CLI.

Port of ``tools/train.py``: builds a named config, a synthetic scene stream
(``--synthetic``), the model with random weights from ``--seed`` (or warm
starts from a checkpoint), the optimizer over the parameters the config
leaves trainable, and runs the epoch loop with per-epoch checkpoints and auto-resume, on one
card:

    python -m focalformer3d_tpu_torch.tools.train FocalFormer3D_L \\
        --synthetic --iters-per-epoch 20 --epochs 2 --work-dir /tmp/smoke

It runs on the card unless ``--device cpu`` is given, and raises where
there is none. The dataset layer (nuScenes / Waymo infos, pipelines, the
GT-paste sampler and the ``Fading`` hook) is not ported yet: without
``--synthetic``, or with ``--data-root``, it raises. One card: the JAX CLI's data-parallel mesh has
no counterpart yet.
"""
from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="Train a FocalFormer3D model")
    p.add_argument("config", help="config name, e.g. FocalFormer3D_L")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--data-root", default=None,
                   help="dataset root: raises, the dataset layer is not "
                        "ported yet")
    p.add_argument("--synthetic", action="store_true",
                   help="train on the synthetic scene generator")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--iters-per-epoch", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None,
                   help="batch (default: the recipe's samples_per_device)")
    p.add_argument("--load-from", default=None,
                   help="checkpoint dir to warm-start the model from")
    p.add_argument("--load-img-from", default=None,
                   help="checkpoint dir for the image branch only")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-interval", type=int, default=50)
    p.add_argument("--keep-last", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default: the card, raises without one) "
                        "or 'cpu'")
    p.add_argument("--no-tensorboard", action="store_true",
                   help="disable the TensorBoard writer (on by default "
                        "when torch.utils.tensorboard imports)")
    return p.parse_args(argv)


def resolve_device(name: str) -> torch.device:
    """The device a CLI runs on: the card unless 'cpu' is asked for; no
    fallback from one to the other. Also sets the CLIs' precision: float32
    matmuls and convolutions stay float32 (PyTorch lets cuDNN round them
    to TF32 by default), as the configs' float32 means and as the tests
    hold the port to."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (torch.cuda.is_available() is "
                         "false); pass --device cpu to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise SystemExit(f"unsupported device {name!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


@dataclasses.dataclass
class TrainRun:
    """What ``main`` leaves: the trained model and optimizer state, the
    epoch it resumed from (0 for a fresh run) and its work dir."""

    model: torch.nn.Module
    opt_state: object
    start_epoch: int
    work_dir: str


def main(argv: Optional[List[str]] = None) -> TrainRun:
    args = parse_args(argv)
    if args.data_root or not args.synthetic:
        raise NotImplementedError(
            "the dataset layer is not ported yet; train with --synthetic "
            "and without --data-root")
    device = resolve_device(args.device)

    from ..configs import get_config
    from ..data import synthetic
    from ..models.detector import FocalFormer3D
    from ..training import checkpoint as ckpt
    from ..training import optim
    from ..training.loop import run_training
    from ..training.train_step import make_train_step
    from ..utils.ref_keys import make_fake_state_dict

    cfg_all = get_config(args.config)
    cfg, lcfg, recipe = cfg_all["model"], cfg_all["loss"], cfg_all["train"]
    batch_size = args.batch_size or recipe.samples_per_device
    epochs = args.epochs or recipe.total_epochs
    work_dir = args.work_dir or f"work_dirs/{args.config}"

    rng_np = np.random.RandomState(args.seed)
    iters = args.iters_per_epoch or 100

    def batch_iter(epoch):
        for _ in range(iters):
            yield synthetic.make_batch(
                rng_np, batch_size=batch_size, n_points=30000,
                n_boxes=min(16, cfg.decoder.max_gts // 4),
                max_gts=cfg.decoder.max_gts // 4,
                num_classes=cfg.decoder.num_classes,
                pc_range=cfg.voxel.point_cloud_range)

    tx = optim.make_optimizer(
        base_lr=recipe.base_lr, weight_decay=recipe.weight_decay,
        total_steps=epochs * iters, grad_clip=recipe.grad_clip,
        lr_target_ratio=recipe.lr_target_ratio,
        momentum_target_ratio=recipe.momentum_target_ratio,
        step_ratio_up=recipe.step_ratio_up,
    )
    print(f"device: {device}, batch {batch_size}, {iters} iters/epoch, "
          f"{epochs} epochs", flush=True)
    # the JAX CLI initialises from the first batch of the same stream, so
    # the run trains on the batches after it: draw it here too
    next(iter(batch_iter(0)))
    model = FocalFormer3D(cfg)
    model.load_state_dict(make_fake_state_dict(model, seed=args.seed),
                          strict=True)
    model = model.to(device)
    # the config's frozen parameters do not require a gradient: no state
    opt_state = tx.init(model.named_parameters())
    n_params = sum(p.numel() for p in model.parameters())
    print(f"params: {n_params / 1e6:.2f}M", flush=True)

    if args.load_from:
        src = ckpt.load_payload(args.load_from)["state_dict"]
        model.load_state_dict(ckpt.load_partial_params(model.state_dict(),
                                                       src))
        print(f"warm-started from {args.load_from}", flush=True)
    if args.load_img_from:
        src = ckpt.load_payload(args.load_img_from)["state_dict"]
        own = model.state_dict()
        params = {n: own[n] for n, _ in model.named_parameters()}
        model.load_state_dict(ckpt.load_partial_params(
            params, src, ckpt.img_branch_filter), strict=False)
        print(f"loaded image branch from {args.load_img_from}", flush=True)

    start_epoch = ckpt.auto_resume(work_dir, model, opt_state)
    if start_epoch:
        print(f"auto-resumed from epoch {start_epoch} (step "
              f"{opt_state.count})", flush=True)

    run_training(
        make_train_step(cfg, lcfg, tx), model, opt_state, batch_iter,
        epochs=epochs, device=device, start_epoch=start_epoch,
        seed=args.seed, work_dir=work_dir, keep_last=args.keep_last,
        log_interval=args.log_interval,
        json_log_path=str(Path(work_dir) / "train_log.jsonl"),
        tensorboard_dir=(None if args.no_tensorboard
                         else str(Path(work_dir) / "tf_logs")),
    )
    print("training complete", flush=True)
    return TrainRun(model, opt_state, start_epoch, work_dir)


if __name__ == "__main__":
    main()

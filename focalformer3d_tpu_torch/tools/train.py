"""Training CLI.

Port of ``tools/train.py``: builds a named config, a nuScenes or Waymo
dataset (or a synthetic scene stream with ``--synthetic``), the model with
random weights
from ``--seed`` (or warm starts from a checkpoint), the optimizer over the
parameters the config leaves trainable, and runs the epoch loop with
Fading, per-epoch checkpoints and auto-resume, on one card:

    python -m focalformer3d_tpu_torch.tools.train FocalFormer3D_L \\
        --data-root data/nuscenes --work-dir work_dirs/ff3d_l
    python -m focalformer3d_tpu_torch.tools.train FocalFormer3D_L \\
        --synthetic --iters-per-epoch 20 --epochs 2 --work-dir /tmp/smoke

A camera config's synthetic stream carries six cameras per scene, rendered
at the config's image size (``data/synthetic.make_batch(with_images=True)``,
as the JAX CLI draws it); ``--load-img-from`` loads the image branch
(``img_backbone``, ``img_neck``, ``imgpts_neck.cam_lss``) of another
checkpoint. A camera config on a nuScenes directory reads each sample's
six cameras (``NuScenesDataset(with_images=True)``, the port's JPEG decoder)
and augments them with ``ImageAug3D`` at the config's image size.

The dataset branches are JAX's. nuScenes: the GT-paste sampler where
``nuscenes_dbinfos_train.pkl`` exists in ``--data-root`` (not for a camera
config), the train pipeline, CBGS resampling unless ``--no-cbgs``, one
``rng_np.permutation`` of the indices per epoch and ``Fading`` at the
recipe's ``fade_epoch``. Waymo (a config whose ``dataset`` is "waymo";
``waymo_infos_train.pkl`` in the KITTI layout of ``data/waymo.py``): the
train pipeline without GT-paste, every ``load_interval``-th frame of the
config (1 unless it sets one), no CBGS, one permutation per epoch.
The CLI draws from its ``numpy.random.RandomState(--seed)`` in the order the
JAX CLI does (the first batch, which JAX draws to initialise its state,
included), so one seed gives the same batches in both packages.

It runs on the card unless ``--device cpu`` is given, and raises where
there is none.

Data parallel (the JAX CLI's multi-process start): under ``torchrun``
(``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``) each process joins the group over ``--dist-backend``
(``nccl`` on a card, ``gloo`` on the CPU, by default) and trains on
``cuda:LOCAL_RANK`` unless ``--device`` names a card:

    torchrun --nproc_per_node 8 -m focalformer3d_tpu_torch.tools.train \
        FocalFormer3D_L --data-root data/nuscenes --work-dir work_dirs/ff3d_l

The global batch (``--batch-size``, or the recipe's ``samples_per_device``
times the world size) is split into per-rank batches of ``global //
world``; each rank reads its shard ``[rank::world]`` of the indices (after
the CBGS draw on nuScenes, over the frames on Waymo), and every rank takes
the steps that the shortest shard fills, so that no rank waits in a
collective for a step the others do not take (the JAX CLI counts its own
shard's steps). ``--synthetic`` draws from ``RandomState(--seed)`` on every
rank, so the ranks train on the same scenes, as the JAX CLI's do. Every
rank starts from rank 0's weights (one broadcast) and auto-resumes from
the same work dir; only rank 0 prints, logs and saves checkpoints.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from pathlib import Path
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np
import torch


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="Train a FocalFormer3D model")
    p.add_argument("config", help="config name, e.g. FocalFormer3D_L")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--data-root", default="data/nuscenes")
    p.add_argument("--ann-file", default=None,
                   help="infos pkl (default: nuscenes_infos_train.pkl, or "
                        "waymo_infos_train.pkl for a Waymo config, in "
                        "--data-root)")
    p.add_argument("--synthetic", action="store_true",
                   help="train on the synthetic scene generator")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--iters-per-epoch", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None,
                   help="global batch (default: the recipe's "
                        "samples_per_device times the world size)")
    p.add_argument("--max-points", type=int, default=300000)
    p.add_argument("--no-cbgs", action="store_true")
    p.add_argument("--load-from", default=None,
                   help="checkpoint dir to warm-start the model from")
    p.add_argument("--load-img-from", default=None,
                   help="checkpoint dir for the image branch only")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-interval", type=int, default=50)
    p.add_argument("--keep-last", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default: the card of LOCAL_RANK, raises "
                        "without one), 'cuda:N' or 'cpu'")
    p.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                   help="the process group's backend under torchrun "
                        "(default: nccl on a card, gloo on the CPU)")
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


# GT-paste groups and point floors of the JAX CLI's nuScenes branch (the
# reference's db_sampler in FocalFormer3D_L.py)
SAMPLE_GROUPS = dict(car=2, truck=3, construction_vehicle=7, bus=4,
                     trailer=6, barrier=2, motorcycle=6, bicycle=6,
                     pedestrian=2, traffic_cone=2)
MIN_POINTS = 5


def load_config(name: str) -> dict:
    """``configs.get_config(name)``: the one place both CLIs read a config
    from (the tests inject one here)."""
    from ..configs import get_config

    return get_config(name)


def shard_steps(indices: np.ndarray, batch_size: int,
                iters: Optional[int]) -> Tuple[np.ndarray, int]:
    """This rank's shard ``indices[rank::world]`` and the steps an epoch
    takes: ``iters`` (``--iters-per-epoch``) or the batches the shortest
    shard fills, and under a process group never more than that, so that
    every rank takes the same steps."""
    from ..parallel import mesh

    world = mesh.world_size()
    fill = len(indices) // world // batch_size
    if world > 1 and fill == 0:
        raise ValueError(f"{len(indices)} samples cannot give each of "
                         f"{world} ranks a batch of {batch_size}")
    steps = iters or max(1, fill)
    if world > 1:
        steps = min(steps, fill)
    return mesh.shard(indices), steps


@dataclasses.dataclass
class TrainRun:
    """What ``main`` leaves: the trained model and optimizer state, the
    epoch it resumed from (0 for a fresh run), its work dir and the
    dataset's pipeline as training left it (None on ``--synthetic``)."""

    model: torch.nn.Module
    opt_state: object
    start_epoch: int
    work_dir: str
    pipeline: object = None


def nuscenes_batches(args, cfg_all: dict, batch_size: int,
                     rng_np: np.random.RandomState
                     ) -> Tuple[Callable[[int], Iterator[dict]], int, object]:
    """The JAX CLI's nuScenes branch (``tools/train.py:151-200``):
    ``(batch_iter(epoch), steps_per_epoch, dataset)``. Builds the dataset
    and draws the CBGS indices from ``rng_np``; each epoch of
    ``batch_iter`` draws a permutation of this rank's shard of them
    (``shard_steps``), then the samples' own draws, from the same
    ``rng_np``."""
    from ..data import nuscenes as nusc
    from ..data import pipelines as pl

    cfg, classes = cfg_all["model"], cfg_all["class_names"]
    ann = args.ann_file or str(
        Path(args.data_root) / "nuscenes_infos_train.pkl")
    db_sampler = None
    db_path = Path(args.data_root) / "nuscenes_dbinfos_train.pkl"
    if db_path.exists() and not cfg.input_img:
        db_sampler = nusc.DBSampler(
            str(db_path), args.data_root, classes,
            sample_groups=SAMPLE_GROUPS,
            min_points={c: MIN_POINTS for c in classes})
    pipe = pl.train_pipeline(cfg.voxel.point_cloud_range, classes,
                             db_sampler=db_sampler,
                             with_images=cfg.input_img,
                             img_scale=cfg.lss.img_scale)
    ds = nusc.NuScenesDataset(ann, data_root=args.data_root,
                              classes=classes, pipeline=pipe,
                              with_images=cfg.input_img)
    indices, steps_per_epoch = shard_steps(
        np.arange(len(ds)) if args.no_cbgs else ds.cbgs_indices(rng_np),
        batch_size, args.iters_per_epoch)

    def batch_iter(epoch):
        order = rng_np.permutation(indices)
        for it in range(steps_per_epoch):
            sel = order[it * batch_size: (it + 1) * batch_size]
            if len(sel) < batch_size:
                return
            samples = [ds.get_sample(int(i), rng_np) for i in sel]
            b = nusc.collate(samples, classes, max_points=args.max_points,
                             max_gts=cfg.decoder.max_gts // 4)
            b.pop("tokens", None)
            yield b

    return batch_iter, steps_per_epoch, ds


def waymo_batches(args, cfg_all: dict, batch_size: int,
                  rng_np: np.random.RandomState
                  ) -> Tuple[Callable[[int], Iterator[dict]], int, object]:
    """The JAX CLI's Waymo branch (``tools/train.py:112-150``):
    ``(batch_iter(epoch), steps_per_epoch, dataset)`` over this rank's
    shard (``shard_steps``) of every ``load_interval``-th frame, the train
    pipeline without GT-paste; each epoch draws a permutation of the
    shard, then the samples' own draws, from ``rng_np``."""
    from ..data import nuscenes as nusc  # collate
    from ..data import pipelines as pl
    from ..data import waymo as wds

    cfg, classes = cfg_all["model"], cfg_all["class_names"]
    ann = args.ann_file or str(Path(args.data_root) / "waymo_infos_train.pkl")
    pipe = pl.train_pipeline(cfg.voxel.point_cloud_range, classes,
                             db_sampler=None, with_images=False)
    ds = wds.WaymoDataset(ann, data_root=args.data_root, classes=classes,
                          pipeline=pipe,
                          load_interval=cfg_all.get("load_interval", 1))
    indices, steps_per_epoch = shard_steps(np.arange(len(ds)), batch_size,
                                           args.iters_per_epoch)

    def batch_iter(epoch):
        order = rng_np.permutation(indices)
        for it in range(steps_per_epoch):
            sel = order[it * batch_size: (it + 1) * batch_size]
            if len(sel) < batch_size:
                return
            samples = [ds.get_sample(int(i), rng_np) for i in sel]
            b = nusc.collate(samples, classes, max_points=args.max_points,
                             max_gts=cfg.decoder.max_gts // 4)
            b.pop("tokens", None)
            yield b

    return batch_iter, steps_per_epoch, ds


def main(argv: Optional[List[str]] = None) -> TrainRun:
    args = parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda",
                                  int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    from ..parallel import mesh

    joined = mesh.init_distributed(
        args.dist_backend or ("nccl" if device.type == "cuda" else "gloo"))
    try:
        return _train(args, device)
    finally:
        if joined:
            mesh.shutdown()


def _train(args, device: torch.device) -> TrainRun:
    from ..data import synthetic
    from ..models.detector import FocalFormer3D
    from ..parallel import mesh
    from ..training import checkpoint as ckpt
    from ..training import optim
    from ..training.loop import Fading, run_training
    from ..training.train_step import make_train_step
    from ..utils.ref_keys import make_fake_state_dict

    world, main_proc = mesh.world_size(), mesh.is_main_process()

    def say(msg):
        if main_proc:
            print(msg, flush=True)

    cfg_all = load_config(args.config)
    cfg, lcfg, recipe = cfg_all["model"], cfg_all["loss"], cfg_all["train"]
    global_batch = args.batch_size or recipe.samples_per_device * world
    batch_size = max(1, global_batch // world)
    epochs = args.epochs or recipe.total_epochs
    work_dir = args.work_dir or f"work_dirs/{args.config}"

    rng_np = np.random.RandomState(args.seed)
    if args.synthetic:
        steps_per_epoch = args.iters_per_epoch or 100
        pipeline = None

        def batch_iter(epoch):
            for _ in range(steps_per_epoch):
                yield synthetic.make_batch(
                    rng_np, batch_size=batch_size, n_points=30000,
                    n_boxes=min(16, cfg.decoder.max_gts // 4),
                    max_gts=cfg.decoder.max_gts // 4,
                    num_classes=cfg.decoder.num_classes,
                    pc_range=cfg.voxel.point_cloud_range,
                    with_images=cfg.input_img, img_hw=cfg.lss.img_scale)
    else:
        batches = (waymo_batches if cfg_all["dataset"] == "waymo"
                   else nuscenes_batches)
        batch_iter, steps_per_epoch, ds = batches(args, cfg_all, batch_size,
                                                  rng_np)
        pipeline = ds.pipeline

    tx = optim.make_optimizer(
        base_lr=recipe.base_lr, weight_decay=recipe.weight_decay,
        total_steps=epochs * steps_per_epoch, grad_clip=recipe.grad_clip,
        lr_target_ratio=recipe.lr_target_ratio,
        momentum_target_ratio=recipe.momentum_target_ratio,
        step_ratio_up=recipe.step_ratio_up,
    )
    dp = (f", world size {world}, global batch {batch_size * world}"
          if world > 1 else "")
    say(f"device: {device}, batch {batch_size}{dp}, {steps_per_epoch} "
        f"iters/epoch, {epochs} epochs")
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
    say(f"params: {n_params / 1e6:.2f}M")

    if args.load_from:
        src = ckpt.load_payload(args.load_from)["state_dict"]
        model.load_state_dict(ckpt.load_partial_params(model.state_dict(),
                                                       src))
        say(f"warm-started from {args.load_from}")
    if args.load_img_from:
        src = ckpt.load_payload(args.load_img_from)["state_dict"]
        own = model.state_dict()
        params = {n: own[n] for n, _ in model.named_parameters()}
        model.load_state_dict(ckpt.load_partial_params(
            params, src, ckpt.img_branch_filter), strict=False)
        say(f"loaded image branch from {args.load_img_from}")

    start_epoch = ckpt.auto_resume(work_dir, model, opt_state)
    if start_epoch:
        say(f"auto-resumed from epoch {start_epoch} (step "
            f"{opt_state.count})")
    mesh.broadcast_module(model)  # every rank from rank 0's weights

    fading = Fading(recipe.fade_epoch)
    fading.pipeline = pipeline
    run_training(
        make_train_step(cfg, lcfg, tx), model, opt_state, batch_iter,
        epochs=epochs, device=device, start_epoch=start_epoch,
        seed=args.seed, work_dir=work_dir, keep_last=args.keep_last,
        log_interval=args.log_interval, hooks=[fading],
        log_fn=print if main_proc else (lambda _msg: None),
        save_checkpoints=main_proc,
        json_log_path=(str(Path(work_dir) / "train_log.jsonl")
                       if main_proc else None),
        tensorboard_dir=(None if args.no_tensorboard or not main_proc
                         else str(Path(work_dir) / "tf_logs")),
    )
    say("training complete")
    return TrainRun(model, opt_state, start_epoch, work_dir, pipeline)


if __name__ == "__main__":
    main()

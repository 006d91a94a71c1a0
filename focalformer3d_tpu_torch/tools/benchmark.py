"""Inference and training benchmark of the port on one card.

Port of ``tools/benchmark.py`` with what ``bench.py`` measures:

    python -m focalformer3d_tpu_torch.tools.benchmark FocalFormer3D_L
    python -m focalformer3d_tpu_torch.tools.benchmark FocalFormer3D_L \\
        --train --batch-size 2

Inference: FocalFormer3D_L (random weights from seed 0) on ``bench.py``'s
radial 200 000-point scan, in bf16 by default, through
``preprocess_points`` -> model -> ``get_bboxes`` on each engine of
``--engines``. The engines share one model and take turns scan by scan, so
the numbers of one call compare. Per engine:

- synchronous ms/scan (host clock around one scan ending in a
  synchronise): median, p10, p90, min, max and the spread
  (p90 - p10) / median, over ``--samples`` scans after ``--warmup``;
- pipelined ms/scan (``--samples`` scans issued back to back, one
  synchronise at the end), the engines in turn and then in reverse;
- ms/scan at batch ``--big-batch`` (4; 0 skips it) beside ``--batch-size``.

A camera config (``FocalFormer3D_LC``, ``FocalFormer3D_LC_Proj``,
``DeformFormer3D_C_R50``) takes
each scan with its six synthetic cameras rendered at the config's image
size (``data/synthetic.make_batch(with_images=True)``, as the JAX
benchmark builds them); the camera-only config has no point branch, so it
runs once, under the engine name "none".

One JSON line with these numbers, the engines, the dtype, the peak device
memory of the timed scans and the card's name and power limit (as
``nvidia-smi`` gives them) is printed right after the timing, before any
diagnostic. Then, per engine, the stage split of one scan by CUDA events
(voxelize, index build, sparse convs, dense tail, SECOND + neck,
FocalEncoder, decoder, get_bboxes; a camera config adds image backbone +
FPN and LSS lift, LSS splat and BevEncode, or with I2P the stage I2P
(``shared_conv_img`` and the projection), and its FocalEncoder is the
fusion layers alone; the model's forward marks its stages) and each level's
active voxels against its capacity, with the voxels a capacity dropped (an
overflow is flagged).

``--train`` times the training step instead (``training/train_step``,
float32 as the config says and as the train CLI computes it, TF32 off) on
each engine of ``--engines``, each on its own model from the same weights,
the engines in turns step by step in one process: per engine ms/step over
``--samples`` steps (at least 3) with the first step apart, its split into
voxelize / forward / loss / backward / optimizer by the step's ``mark``,
peak memory and the kernel launches of a step, and, where the config
freezes a branch, the same with the freeze off. Its JSON line (one, with a
row per engine under ``engines``) comes right after that timing; then (for
a config with the point
branch) SECOND's first conv2d at
its training shape, float32, forward and backward (``aten``'s
``convolution_backward``, dx and dW), each timed by CUDA-graph replay
(``tools/_common.time_ms``) in six variants: (a) the model's
``conv2d_nhwc`` (an NCHW view of the NHWC map), (b) the same with
``cudnn.benchmark``, (c) the input copied to contiguous NCHW, (d) input
and weight in ``channels_last``, (e) (a) with TF32 allowed, which rounds
the operands to 10-bit mantissas, (f) (a) with cuDNN off (ATen's own
convolution, float32); each with the kernels ``torch.profiler`` sees and
its difference from (a). These are
measurements: the model's path is not changed by them.

It runs on the card unless ``--device cpu`` is given (the tests do, where
nothing is timed by the device: the stage split then reads the host clock
and the conv2d variants are not timed), and raises where there is none. A
failing engine raises; nothing falls back to another engine or device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.profiler import StageClock, T
from .train import resolve_device

CARD_ENGINES = "cuda,cuda_mxu,cuda_zrun"
STAGES = ("voxelize", "index build", "sparse convs", "dense tail",
          "SECOND + neck", "FocalEncoder", "decoder", "get_bboxes")
# a camera config's stages: the image branch before the point branch, the
# LSS inside the neck before its fusion layers ("FocalEncoder")
CAMERA_STAGES = ("voxelize", "image backbone + FPN", "index build",
                 "sparse convs", "dense tail", "SECOND + neck", "LSS lift",
                 "LSS splat", "BevEncode", "FocalEncoder", "decoder",
                 "get_bboxes")


def stages_of(cfg):
    """The stage names a config's forward marks, in the order it marks
    them: with I2P (``cam_proj="i2p"``) in place of the LSS, "I2P"
    (``shared_conv_img`` and the first fusion layer's projection) before
    the fusion layers; with the Waymo configs' PointNet VFE, "HardVFE"
    after "voxelize"."""
    if not cfg.input_img:
        return (STAGES[:1] + ("HardVFE",) + STAGES[1:]
                if cfg.vfe_type == "HardVFE" else STAGES)
    if cfg.cam_proj != "i2p":
        return CAMERA_STAGES
    i = CAMERA_STAGES.index("FocalEncoder")
    return CAMERA_STAGES[:6] + ("I2P",) + CAMERA_STAGES[i:]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("config", nargs="?", default="FocalFormer3D_L")
    p.add_argument("--samples", type=int, default=200)
    p.add_argument("--warmup", type=int, default=10)
    p.add_argument("--n-points", type=int, default=200000)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--big-batch", type=int, default=4,
                   help="also time this batch (bench.py's batch 4); 0 skips")
    p.add_argument("--engines", default=CARD_ENGINES,
                   help="comma-separated sparse engines, timed in turns")
    p.add_argument("--dtype", default="bfloat16",
                   help="inference compute dtype (bench.py's default bf16)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default: the card, raises without one) "
                        "or 'cpu'")
    p.add_argument("--train", action="store_true",
                   help="benchmark the train step instead of inference")
    return p.parse_args(argv)


def card_info(device: torch.device) -> Dict[str, Optional[str]]:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    if device.type != "cuda":
        return {"platform": "cpu", "name": None, "power_limit": None}
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name, limit = (x.strip() for x in line.split(",", 1))
    return {"platform": "gpu", "name": name, "power_limit": limit}


def summary(ms: List[float]) -> Dict[str, float]:
    """Median, p10, p90, min, max and spread (p90 - p10) / median."""
    a = np.asarray(ms, np.float64)
    med = float(np.median(a))
    p10, p90 = (float(x) for x in np.percentile(a, [10, 90]))
    return {"median": med, "p10": p10, "p90": p90, "min": float(a.min()),
            "max": float(a.max()), "spread": (p90 - p10) / med if med
            else 0.0, "n": len(ms)}


def voxelizer_drop(cfg, points, mask) -> List[int]:
    """Occupied voxels of each scan beyond the inference voxel cap."""
    from ..ops.voxelize import point_voxel_coords

    vcfg = cfg.voxel
    cap = vcfg.max_voxels_test or vcfg.max_voxels
    out = []
    for b in range(points.shape[0]):
        coords, valid = point_voxel_coords(vcfg, points[b], mask[b])
        n = torch.unique(coords[valid], dim=0).shape[0]
        out.append(max(n - cap, 0))
    return out


def _inference(args, device, card):
    from ..configs import get_config, with_compute_dtype
    from ..data import synthetic
    from ..models.detector import FocalFormer3D, preprocess_points
    from ..utils.ref_keys import make_fake_state_dict

    cfg = with_compute_dtype(get_config(args.config)["model"], args.dtype)
    # a camera-only config has no point branch, so no engine to choose
    engines = ([e for e in args.engines.split(",") if e] if cfg.input_pts
               else ["none"])
    model = FocalFormer3D(cfg).eval()
    model.load_state_dict(make_fake_state_dict(model, seed=0), strict=True)
    model = model.to(device)
    enc = model.pts_middle_encoder if cfg.input_pts else None
    rng = np.random.RandomState(0)

    def scans(batch_size):
        b = synthetic.make_batch(
            rng, batch_size=batch_size, n_points=args.n_points, n_boxes=24,
            max_gts=32, num_classes=cfg.decoder.num_classes,
            pc_range=cfg.voxel.point_cloud_range, mode="radial",
            with_images=cfg.input_img, img_hw=cfg.lss.img_scale)
        keys = ("points", "points_mask") + (
            ("imgs", "lidar2img", "img_aug", "bev_aug") if cfg.input_img
            else ())
        return {k: torch.from_numpy(b[k]).to(device) for k in keys}

    def inputs(engine, scan):
        if enc is not None:
            enc.engine = engine
        vox = (preprocess_points(cfg, scan["points"], scan["points_mask"])
               if cfg.input_pts else None)
        img = ({k: scan[k] for k in ("imgs", "lidar2img", "img_aug",
                                     "bev_aug")} if cfg.input_img else None)
        return vox, img

    def infer(engine, scan):
        vox, img = inputs(engine, scan)
        return model.get_bboxes(model(vox, img_data=img), 200)

    def sync_ms(engine, scan):
        with T(engine) as t:
            dec = t.sync(infer(engine, scan))
        if not all(bool(torch.isfinite(dec[k]).all())
                   for k in ("bboxes", "scores")):
            raise RuntimeError(f"{engine}: non-finite boxes or scores")
        return t.ms

    scan = scans(args.batch_size)
    for engine in engines:
        for _ in range(max(args.warmup, 1)):
            sync_ms(engine, scan)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    per_scan = {e: [] for e in engines}
    for _ in range(args.samples):  # engines in turn, scan by scan
        for engine in engines:
            per_scan[engine].append(sync_ms(engine, scan) / args.batch_size)
    peak = (torch.cuda.max_memory_allocated(device) / 2**30
            if device.type == "cuda" else None)
    pipelined = {e: [] for e in engines}
    for order in (engines, engines[::-1]):
        for engine in order:
            with T(engine) as t:
                for _ in range(args.samples):
                    dec = infer(engine, scan)
                t.sync(dec)
            pipelined[engine].append(t.ms / (args.samples * args.batch_size))
    big = {}
    if args.big_batch:
        scan_b = scans(args.big_batch)
        for engine in engines:
            sync_ms(engine, scan_b)
        big = {e: [] for e in engines}
        for _ in range(max(args.samples // args.big_batch, 3)):
            for engine in engines:
                big[engine].append(sync_ms(engine, scan_b) / args.big_batch)

    result = {"benchmark": "inference", "config": args.config,
              "dtype": args.dtype, "n_points": args.n_points,
              "batch_size": args.batch_size, "samples": args.samples,
              "cameras": (int(scan["imgs"].shape[1]) if cfg.input_img
                          else 0),
              "peak_memory_gib": peak, "device": card, "engines": {}}
    for engine in engines:
        row = {"ms_per_scan": summary(per_scan[engine]),
               "ms_per_scan_pipelined": statistics.mean(pipelined[engine]),
               "ms_per_scan_pipelined_runs": pipelined[engine]}
        if big:
            row[f"ms_per_scan_batch{args.big_batch}"] = summary(big[engine])
        result["engines"][engine] = row
    print(json.dumps(result), flush=True)

    # ---- diagnostics, after the JSON line ----
    stages = stages_of(cfg)
    clock_name = "CUDA events" if device.type == "cuda" else "host clock"
    n_stage = len(cfg.encoder_channels)
    for engine in engines:
        splits = []
        for _ in range(3):
            clock = StageClock(device, stages)
            clock.start()
            vox, img = inputs(engine, scan)
            clock.mark("voxelize")
            out = model(vox, mark=clock.mark, img_data=img)
            model.get_bboxes(out, 200)
            clock.mark("get_bboxes")
            splits.append(clock.split())
        split = {s: statistics.median(x[s] for x in splits) for s in stages}
        print(f"stage split {engine} ({clock_name}, median of 3 scans, ms): "
              + ", ".join(f"{s} {split[s]:.3f}" for s in stages)
              + f"; total {sum(split.values()):.3f}", flush=True)
        if enc is None:
            continue
        pts, mask = scan["points"], scan["points_mask"]
        drop0 = voxelizer_drop(cfg, pts, mask)
        levels = []
        vox = preprocess_points(cfg, pts, mask)
        feats = (model.pts_voxel_encoder(vox["voxels"], vox["num_points"])
                 if cfg.vfe_type == "HardVFE" else vox["features"])
        enc(feats, vox["coords"], vox["voxel_mask"], levels=levels)
        parts = []
        for i, lvl in enumerate(levels):
            active = lvl.valid.sum(1).tolist()
            # a level's column meta counts its outputs before the capacity
            total = (lvl.meta[:, -2, 2].long() + lvl.meta[:, -2, 3]).tolist()
            dropped = drop0 if i == 0 else [max(t - lvl.capacity, 0)
                                            for t in total]
            name = f"L{i}" if i < n_stage else "conv_out"
            flag = " OVERFLOW" if any(dropped) else ""
            parts.append(f"{name} {'/'.join(map(str, active))} of "
                         f"{lvl.capacity} (dropped "
                         f"{'/'.join(map(str, dropped))}){flag}")
        print(f"occupancy {engine} (active per sample of capacity; "
              f"dropped: voxels beyond it): " + "; ".join(parts), flush=True)
    return result


def _train_step_times(args, device, cfg, lcfg, batch, engines, tag):
    """``1 + max(3, --samples)`` steps on each engine, the engines in turns
    step by step, each on its own model from the seed-0 weights. Per
    engine: the first step apart, then the median and spread, the split
    by phase, the peak device memory of its steps and its kernel launches
    per step (``train_step.kernel_launches``)."""
    from ..models.detector import FocalFormer3D
    from ..training import optim
    from ..training.train_step import PHASES, kernel_launches, \
        make_train_step
    from ..utils.ref_keys import make_fake_state_dict

    tx = optim.make_optimizer(total_steps=1000)
    runs = {}
    for engine in engines:
        ecfg = (dataclasses.replace(cfg, sparse_engine=engine)
                if cfg.input_pts else cfg)
        model = FocalFormer3D(ecfg)
        model.load_state_dict(make_fake_state_dict(model, seed=0),
                              strict=True)
        model = model.to(device)
        gen = torch.Generator(device=device)
        gen.manual_seed(1)
        runs[engine] = (model, tx.init(model.named_parameters()),
                        make_train_step(ecfg, lcfg, tx), gen)
    wall = {e: [] for e in engines}
    splits = {e: [] for e in engines}
    peak = dict.fromkeys(engines, 0)
    launches, loss = {e: [] for e in engines}, {}
    for _ in range(1 + max(3, args.samples)):
        for engine in engines:
            model, opt_state, step, gen = runs[engine]
            clock = StageClock(device, PHASES)
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            before = kernel_launches()  # the caller's counts run on
            with T("train step") as t:
                clock.start()
                metrics = t.sync(step(model, opt_state, batch, gen,
                                      clock.mark))
            launches[engine].append({k: n - before[k] for k, n in
                                     kernel_launches().items()})
            if device.type == "cuda":
                peak[engine] = max(peak[engine],
                                   torch.cuda.max_memory_allocated(device))
            wall[engine].append(t.ms)
            splits[engine].append(clock.split())
            if not np.isfinite(float(metrics["loss"])):
                raise RuntimeError(f"{tag} {engine}: non-finite loss")
            loss[engine] = float(metrics["loss"])
    out = {}
    for engine in engines:
        rest = splits[engine][1:]
        w = wall[engine]
        row = {"ms_per_step_first": w[0], "ms_per_step": summary(w[1:]),
               "split_ms": {p: statistics.median(s[p] for s in rest)
                            for p in PHASES},
               "split_ms_first": {p: splits[engine][0][p] for p in PHASES},
               "loss": loss[engine],
               "peak_memory_gib": (peak[engine] / 2**30
                                   if device.type == "cuda" else None),
               "launches_per_step": launches[engine][-1]}
        out[engine] = row
        print(f"{tag} {engine}: ms/step first {w[0]:.1f}, then median "
              f"{row['ms_per_step']['median']:.1f} (p90 "
              f"{row['ms_per_step']['p90']:.1f}); split median ms "
              + ", ".join(f"{p} {t:.1f}" for p, t in row["split_ms"].items())
              + f"; peak memory {row['peak_memory_gib'] or 0:.2f} GiB; "
              f"launches per step {row['launches_per_step']}", flush=True)
    return out


def _train(args, device, card):
    from ..configs import get_config
    from ..data import synthetic

    cfg_all = get_config(args.config)
    cfg, lcfg = cfg_all["model"], cfg_all["loss"]
    engines = ([e for e in args.engines.split(",") if e] if cfg.input_pts
               else ["none"])
    b = synthetic.make_batch(
        np.random.RandomState(0), batch_size=args.batch_size,
        n_points=args.n_points, n_boxes=24, max_gts=32,
        num_classes=cfg.decoder.num_classes,
        pc_range=cfg.voxel.point_cloud_range, mode="radial",
        with_images=cfg.input_img, img_hw=cfg.lss.img_scale)
    batch = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
    result = {"benchmark": "train", "config": args.config,
              "dtype": cfg.compute_dtype, "n_points": args.n_points,
              "batch_size": args.batch_size, "samples": args.samples,
              "device": card,
              "engines": _train_step_times(args, device, cfg, lcfg, batch,
                                           engines,
                                           f"train step [{args.config}]")}
    if cfg.freeze_img or cfg.freeze_camlss or cfg.freeze_pts:
        cfg_nf = dataclasses.replace(cfg, freeze_img=False,
                                     freeze_camlss=False, freeze_pts=False)
        result["freeze_disabled"] = _train_step_times(
            args, device, cfg_nf, lcfg, batch, engines,
            "train step [freeze disabled]")
    print(json.dumps(result), flush=True)

    # ---- diagnostics, after the JSON line ----
    if cfg.input_pts:
        conv2d_variants(cfg, batch, device)
    return result


def _first_conv_operands(cfg, batch_size, device, gen):
    """SECOND's first conv2d at its training shape: the NHWC BEV map it
    reads (as ``SparseEncoder._collapse`` leaves it), its weight, and an
    NHWC cotangent of its output."""
    from ..models.detector import _sparse_out_z

    H, W = cfg.sparse_shape[1:]
    for pad in cfg.down_paddings:  # the strided convs' BEV extent
        H, W = ((n + 2 * p - 3) // 2 + 1 for n, p in zip((H, W), pad[1:]))
    cin = cfg.sparse_out_channels * _sparse_out_z(cfg)
    cout = cfg.second_channels[0]
    x = torch.randn(batch_size, H, W, cin, device=device, generator=gen)
    w = torch.randn(cout, cin, 3, 3, device=device, generator=gen) \
        * (2.0 / (9 * cin)) ** 0.5
    g = torch.randn(batch_size, H, W, cout, device=device, generator=gen)
    return x, w, g


def conv2d_variants(cfg, batch, device) -> Dict[str, dict]:
    """SECOND's first conv2d, float32, forward and backward in the six
    variants of the module's docstring: per variant the forward and
    backward ms (CUDA-graph replay; None on the CPU), the kernels the
    profiler sees, and the largest difference from variant (a)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..models.layers import conv2d_nhwc
    from . import _common

    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    x, w, g = _first_conv_operands(cfg, batch["points"].shape[0], device,
                                   gen)
    cl = torch.channels_last
    nchw = (x.permute(0, 3, 1, 2), w, g.permute(0, 3, 1, 2))
    variants = {  # name -> (x NCHW, w, g NCHW, cuDNN enabled / benchmark /
        #                   TF32)
        "a conv2d_nhwc": (*nchw, (True, False, False)),
        "b cudnn.benchmark": (*nchw, (True, True, False)),
        "c contiguous NCHW": (*(t.contiguous() for t in nchw),
                              (True, False, False)),
        "d channels_last": (*(t.contiguous(memory_format=cl) for t in nchw),
                            (True, False, False)),
        "e TF32 (rounds operands)": (*nchw, (True, False, True)),
        "f cuDNN off (ATen's own conv)": (*nchw, (False, False, False)),
    }
    # variant (a) is the model's own call
    ref_y = conv2d_nhwc(x, w, None, 1, 1).permute(0, 3, 1, 2)
    ref = None
    out = {}
    for name, (xv, wv, gv, (enabled, bench, tf32)) in variants.items():
        with torch.backends.cudnn.flags(enabled=enabled, benchmark=bench,
                                        deterministic=False,
                                        allow_tf32=tf32):

            def fwd():
                return F.conv2d(xv, wv, None, 1, 1)

            def bwd():
                return torch.ops.aten.convolution_backward(
                    gv, xv, wv, None, [1, 1], [1, 1], [1, 1], False, [0, 0],
                    1, [True, True, False])[:2]

            fwd_ms, y = _common.time_ms(device, fwd)
            bwd_ms, (dx, dw) = _common.time_ms(device, bwd)
            if ref is None:
                rel = float((y - ref_y).abs().max() / ref_y.abs().max())
                if not rel <= 1e-5:
                    raise RuntimeError(f"conv2d variant (a) differs from "
                                       f"the model's conv2d_nhwc: "
                                       f"{rel:.3g}")
                ref = (y, dx, dw)
            err = [float((a - b).abs().max() / b.abs().max())
                   for a, b in zip((y, dx, dw), ref)]
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if device.type == "cuda" else [])
            with profile(activities=acts) as prof:
                fwd()
                bwd()
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
            kern = {}
            for e in prof.events():
                if e.device_type == DeviceType.CUDA:
                    n, ms = kern.get(e.name, (0, 0.0))
                    kern[e.name] = (n + 1,
                                    ms + e.time_range.elapsed_us() / 1e3)
            out[name] = {"forward_ms": fwd_ms, "backward_ms": bwd_ms,
                         "rel_diff_vs_a": dict(zip(("y", "dx", "dW"),
                                                   err)),
                         "kernels": kern}
            t = ("not measured (no card)" if fwd_ms is None else
                 f"forward {fwd_ms:.3f} ms, backward (dx + dW) "
                 f"{bwd_ms:.3f} ms")
            print(f"SECOND conv2d 0 {tuple(xv.shape)} -> {wv.shape[0]} "
                  f"[{name}]: {t}; rel diff vs (a) y/dx/dW "
                  + "/".join(f"{e:.2e}" for e in err) + "; kernels: "
                  + ("; ".join(f"{k[:70]} x{n} {ms:.3f} ms"
                               for k, (n, ms) in sorted(
                                   kern.items(), key=lambda kv: -kv[1][1]))
                     or ("none on a card" if device.type != "cuda" else
                     "the profiler recorded no device kernel")), flush=True)
    return out


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        from ..ops import cuda_build, plan_builder_cuda, sparse_conv_cuda, \
            sparse_conv_zrun_cuda

        cuda_build.build(sparse_conv_cuda.SOURCE,
                         sparse_conv_cuda.WGRAD_SOURCE,
                         plan_builder_cuda.SOURCE,
                         sparse_conv_zrun_cuda.SOURCE)
    card = card_info(device)
    print(f"device: {card['name'] or device}, power limit "
          f"{card['power_limit']}", flush=True)
    torch.manual_seed(0)
    if args.train:
        return _train(args, device, card)
    with torch.no_grad():
        return _inference(args, device, card)


if __name__ == "__main__":
    main()

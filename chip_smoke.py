"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, drive.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit as ``nvidia-smi`` reports them.
2. build: compiles the seven kernel sources of
   ``focalformer3d_tpu_torch/csrc/`` (K1 and kernel A share the header
   ``mma_sm90.cuh``) with one nvcc each, all started
   together (K1 sparse-conv apply, which also runs dx and the phase probe;
   the dW kernel; K2 rulebook builder; K3 z-run sparse-conv apply; the
   probes' kernels A ``micro_dot``, B ``micro_gather``, C
   ``micro_widen``); prints the seconds of each.
3. kernels vs plain, on one radial 200k-point scan (the scan ``bench.py``
   builds), at the shapes the encoder engines give them:
   - index builds: the torch-op build of engine ``cuda``, the meta chain of
     ``cuda_mxu`` (K2 + ``downsample_meta`` + ``colz_from_meta``) and the
     z-run plans of ``cuda_zrun``, timed on the same scan;
   - K2: the 8 rulebooks of the ``cuda_mxu`` path equal ``decode_rules``
     (its plain version) and ``build_conv_rules`` exactly;
   - K1: the 5 conv geometries of ``cuda`` and the 4 more of ``cuda_mxu``
     (L2, L3, conv_out), same bf16 inputs as the plain gather + matmul:
     max |diff| / max |plain| <= 1e-3, and two runs equal bit for bit. Per
     geometry one line with the share of (128-site tile, tap), (64-row
     group, tap), (16-row strip, tap) and (site, tap) pairs that hold a hit
     (what skipping at each granularity leaves of the product), the
     launch's plan (route, persistent grid, stages, W resident or
     streamed), and its time on the route production takes and on the
     other one;
   - K3: the 5 conv geometries of ``cuda_zrun`` against its plain version,
     <= 1e-3, and two runs equal bit for bit. Per geometry one line with
     the hit shares of its codes ((tile, BEV tap), (64-row group, BEV tap),
     (16-row strip, BEV tap), (site, BEV tap) pairs with a z tap), the
     launch's plan (route, grid, stages, W resident or streamed, z taps per
     stage) and its time on the route production takes and on the other
     one (also held to 1e-3).
   Every kernel time (here and in phase 6) is per call from calls replayed
   in a CUDA graph (``tools/_common.time_ms``: the device's time, since a
   short launch runs at the host's pace under CUDA events), and so are the
   plain versions' and K2's torch-op comparators'.
4. slices: FocalFormer3D_L (full width, random weights from a seed, bf16
   compute) answers three radial scans (seeds 0-2) through
   ``preprocess_points`` -> model -> ``get_bboxes`` on each engine: finite
   boxes and scores, 200 kept boxes per scan, and exact launch counts per
   scan (K1, K2, K3): ``cuda`` 11, 0, 0; ``cuda_mxu`` 21, 8, 0;
   ``cuda_zrun`` 0, 0, 11.
5. engine parity: the encoder's BEV for scan 0 on ``cuda`` and
   ``cuda_zrun`` against the plain engine (dense from L2, the eval path),
   and on the all-sparse ``cuda_mxu`` against the plain engine with
   ``dense_from=4``: max |diff| / max |plain| <= 1e-2.
6. K1's backward, at every conv of one training batch (two radial scans,
   the training voxel cap, engine ``cuda`` with the training dense boundary
   L3): ``sparse_conv_train`` (K1 forward; dx by K1 on the transposed
   rulebook; dW by the dW kernel) on random bf16-valued features and
   weights and a random f32 cotangent, against autograd through its plain
   version with the same rounding (``apply_conv_bf16_plain``): forward, dx
   and dW each within 1e-3 of the plain result's scale (the two differ in
   the order of f32 sums and, for dW, by the kernel's split of the
   cotangent into two bf16 parts, 2^-16 of it). Then each kernel alone,
   timed against its plain version by CUDA-graph replay (K1 forward and dx
   with the hit shares of their rulebooks and both routes; dW with its
   route, chunk and slices, and two runs equal bit for bit).
7. training: FocalFormer3D_L at full width and depth in float32, batch 2,
   engine ``cuda``, ``TRAIN_STEPS`` steps of ``training.train_step`` on the
   same two scans with their GT boxes: every loss term and ``grad_norm``
   finite on every step, every parameter and every batch-norm running mean
   moved, K1 forward / dx / dW launches per step exactly 16 / 15 / 16; ms
   per step by host clock around a synchronise (the first step apart, the
   median of the rest), its split into voxelize / forward / loss /
   backward / optimizer by CUDA events, and peak memory per phase.
8. one more training step under ``torch.profiler``: kernels launched,
   device busy share, the largest kernels with their launches, and the
   aten ops that launched the top three.
9. entry points: the port's train CLI (``tools.train.main``, in-process)
   on FocalFormer3D_L, ``--synthetic``, 2 epochs of 2 steps at batch 2,
   ``--keep-last 1``, in a temporary work dir: finite losses in its JSON
   log, ``epoch_2`` saved and ``epoch_1`` pruned; a second call
   auto-resumes at epoch 2 with the saved step and the parameters, buffers
   and moments bit for bit. Then 2 steps with ``freeze_pts`` (the masked
   optimizer): every point-branch parameter and batch-norm statistic and
   ``imgpts_neck.shared_conv_pts`` bit-identical, the head moved, per step
   0 dx and 0 dW launches and as many K1 forward launches as an eval scan
   on ``cuda`` (the eval dense boundary). Then the benchmark CLI
   (``tools.benchmark.main``): inference on the three engines (3 scans
   each, batch 4 beside batch 1, the stage split and occupancy) and
   ``--train`` (2 steps at batch 2, SECOND's first conv2d in its six
   variants); each prints one JSON line, which must parse. K1 (forward,
   dx, dW), K2 and K3 launches are counted from zero before the phase and
   must all be non-zero after it. Prints its seconds.
10. dataset: ``write_nuscenes`` writes a nuScenes-format directory (6
   samples, each a 30k-point key frame of ``data/synthetic`` and 9 sweeps
   of ~29k points seen from a moved sensor, ~290k points a sample, the
   size of a real 10-sweep sample; the infos of mmdet3d v0.17 with the
   calibration of a submission), the port's ``create_gt_database`` its
   GT database. The host ms per sample of ``get_sample`` (train pipeline
   with GT-paste) and ``collate``. Then the train CLI on FocalFormer3D_L,
   batch 2, 2 epochs of 2 steps, with GT-paste and ``Fading`` (which takes
   ``ObjectSample`` out before the second epoch): finite losses, s/it per
   step, ``epoch_2`` saved, K1 forward / dx / dW 64 / 60 / 64 launches, 10
   native point loads (the first batch, drawn as the JAX CLI draws it, and
   four steps). Then the test CLI on that checkpoint over the 6 samples on
   ``cuda``, ``cuda_mxu`` and ``cuda_zrun``: samples/s, the metric keys,
   6 tokens in the submission with at most 500 finite boxes each, and
   exactly the launches of 6 scans (K1 66; K1 126 + K2 48; K3 66).
11. probes: the nine TPU probes P1-P9 of ``tools/micro_*.py`` as their
   ports in ``focalformer3d_tpu_torch/tools/`` (``run(device, "full")``,
   the originals' shapes, each once), one line per probe. Every kernel
   case is held against its plain version: kernel A (``micro_dot``) and
   B's ``gather_taps`` within 1e-3 of the output's scale (sums in another
   order), B's ``gather_rows`` and C (``micro_widen``) bit for bit, K1's
   phase probe in full mode bit for bit against production K1 and within
   1e-3 of the plain conv (its other modes compute zeros, held exactly);
   launches of the five probe kernels are counted from zero just before
   the phase and must all be non-zero. Each kernel case beside a PyTorch
   call prints the ratio of their times; P7's width sweep so shows, per
   row width, ``gather_rows`` against ``x[idx]``, and each P6 and P7 case
   names the route its kernel took. One line per P9 level gives C's time,
   the strided view copy's, their ratio, C's route and tile, and C's share
   of its byte bound.

The ``kernels`` line carries, per kernel, its launches on the main paths
(``launches_by_path``; ``entry_points`` is phase 9's, ``dataset``
phase 10's),
its time and its plain version's (per eval scan for K1 forward, K2 and K3;
per training step for dx and dW, and in ``train`` for K1 forward), and its
bound: the larger of the bytes it must move (each input read once, each
output written once) over 3.35 TB/s and its multiply-adds over the peak of
their type (989 TFLOP/s bf16 for K1 and K3, whose operands are bf16; for
dW, whose f32 cotangent is split into two bf16 parts, two bf16 products
per multiply-add, i.e. half that peak), counted from this run's rulebooks
(rules that hit, at valid output sites). No single PyTorch
call computes a sparse conv or a rulebook, so ``library_ms`` is null. The
five probe kernels carry their headline case (``case``): ``micro_dot`` P1a's
``gk`` beside one ``torch.matmul`` over the same operand;
``micro_gather_taps`` P6 at pack 1 (where the three TPU kernels are one
function) beside ``embedding_bag(mode="sum")``, and its W 512 cases with
their times and routes (``w512``); ``micro_gather_rows`` P7's 4 MiB table
beside ``torch.index_select``, and the row width of the sweep where it
does worst against ``x[idx]`` with that ratio (``worst_vs_x_idx``);
``micro_widen`` P9 at L0 beside one copy of a strided view of the padded
meta; ``sparse_conv_probe`` P1b's L0 in full mode (no library call). Their times are per call, from calls replayed in
a CUDA graph (``tools/_common.time_ms``: the device's time, without the
host's); their launches count each replay's launches; ``max_abs_err`` is
the largest over all their cases.

Imports nothing of JAX and nothing of the JAX package
(``focalformer3d_tpu``): weights and scans come from the port's own numpy
generators. Prints the card line, one ``{"kernels": [...]}`` line, and as
its last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N_POINTS = 200_000
SCAN_SEEDS = (0, 1, 2)
TRAIN_SEED = 10
TRAIN_BATCH = 2
TRAIN_STEPS = 4
KERNEL_TOL = 1e-3
ENGINE_TOL = 1e-2
REPS = 10  # CUDA-event repetitions of a host-issued index build
ENGINES = ("cuda", "cuda_mxu", "cuda_zrun")
# (K1, K2, K3) launches per scan on each engine
LAUNCHES_PER_SCAN = {"cuda": (11, 0, 0), "cuda_mxu": (21, 8, 0),
                     "cuda_zrun": (0, 0, 11)}
# K1 forward / dx / dW launches per training step on ``cuda`` (dense from
# L3): 16 sparse convs (conv_input; per level L0-L2 four subm convs and the
# strided one); conv_input's voxel features need no dx
TRAIN_LAUNCHES_PER_STEP = {"forward": 16, "dx": 15, "wgrad": 16}
# phase 10: a written nuScenes directory of samples the size of a real
# 10-sweep one (a 30k-point key frame + 9 sweeps, ~290k points)
DATASET_SEED = 20
DATASET_SAMPLES = 6
DATASET_POINTS = 30_000
DATASET_SWEEPS = 9
# model-path kernel launches of the test CLI over the samples, per engine
DATASET_TEST_LAUNCHES = {
    engine: {k: n * DATASET_SAMPLES for k, n in zip(
        ("sparse_conv", "plan_rules", "sparse_conv_zrun"), counts) if n}
    for engine, counts in LAUNCHES_PER_SCAN.items()}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
# dense, published; "bf16 split": an f32 operand split into two bf16
# parts, two bf16 products per multiply-add (the dW kernel)
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12, "bf16 split": 989e12 / 2}
CSRC = "focalformer3d_tpu_torch/csrc/"
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "sparse_conv": (CSRC + "sparse_conv.cu",
                    "focalformer3d_tpu/ops/sparse_conv_pallas.py:357"),
    "sparse_conv_dx": (CSRC + "sparse_conv.cu",
                       "focalformer3d_tpu/ops/sparse_conv_pallas.py:715"),
    "sparse_conv_wgrad": (CSRC + "sparse_conv_wgrad.cu",
                          "focalformer3d_tpu/ops/sparse_conv_pallas.py:726"),
    "plan_rules": (CSRC + "plan_builder.cu",
                   "focalformer3d_tpu/ops/plan_builder.py:129"),
    "sparse_conv_zrun": (CSRC + "sparse_conv_zrun.cu",
                         "focalformer3d_tpu/ops/sparse_conv_zrun.py:312"),
    "micro_dot": (CSRC + "micro_dot.cu", "tools/micro_mxu_probe.py:85"),
    "micro_gather_taps": (CSRC + "micro_gather.cu",
                          "tools/micro_gather_kernel.py:46"),
    "micro_gather_rows": (CSRC + "micro_gather.cu",
                          "tools/micro_gather2.py:98"),
    "micro_widen": (CSRC + "micro_widen.cu", "tools/micro_meta9.py:88"),
    "sparse_conv_probe": (CSRC + "sparse_conv.cu",
                          "tools/micro_mxu_probe.py:115"),
}
# the other Pallas functions each probe kernel stands for
ALSO_REPLACES = {
    "micro_dot": ["tools/micro_dotshape.py:38", "tools/micro_dotshape.py:50",
                  "tools/micro_dotshape2.py:29"],
    "micro_gather_taps": ["tools/micro_gather_kernel.py:61",
                          "tools/micro_gather_kernel.py:73"],
    "micro_gather_rows": ["tools/micro_gather2.py:131"],
    "micro_widen": [],
    "sparse_conv_probe": ["tools/micro_kernel_v2.py:54",
                          "tools/micro_pallas_attr.py:37",
                          "tools/micro_batch_grid.py:45"],
}
PROBES = ("micro_mxu_probe", "micro_dotshape", "micro_dotshape2",
          "micro_kernel_v2", "micro_pallas_attr", "micro_gather_kernel",
          "micro_gather2", "micro_batch_grid", "micro_meta9")


class Bound:
    """Least time of a run of launches: per launch the larger of bytes over
    the memory rate and operations over the peak of their type, summed;
    ``keys()`` names the side that bounds most of the sum."""

    def __init__(self):
        self.ms = 0.0
        self.parts = {"bytes": 0.0, "operations": 0.0}

    def add(self, nbytes, flops, peak, times=1):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[peak] * 1e3
        side = "bytes" if t_bytes >= t_ops else "operations"
        self.ms += times * max(t_bytes, t_ops)
        self.parts[side] += times * max(t_bytes, t_ops)

    def keys(self):
        return {"bound_ms": self.ms,
                "bound_by": max(self.parts, key=self.parts.get)}


def _hits(rules, v_in, out_valid):
    """Rules that read an input row, at valid output sites."""
    return int(((rules < v_in) & out_valid[:, None]).sum())


def _wrappers():
    from focalformer3d_tpu_torch.ops import plan_builder_cuda as k2
    from focalformer3d_tpu_torch.ops import sparse_conv_cuda as k1
    from focalformer3d_tpu_torch.ops import sparse_conv_zrun_cuda as k3

    return k1, k2, k3


def _probe_wrappers():
    from focalformer3d_tpu_torch.ops import micro_dot, micro_gather, \
        micro_widen

    return micro_dot, micro_gather, micro_widen


def _scan(cfg, seed, device):
    from focalformer3d_tpu_torch.data import synthetic

    batch = synthetic.make_batch(
        np.random.RandomState(seed), batch_size=1, n_points=N_POINTS,
        n_boxes=24, max_gts=32, num_classes=cfg.decoder.num_classes,
        pc_range=cfg.voxel.point_cloud_range, mode="radial",
    )
    return (torch.from_numpy(batch["points"]).to(device),
            torch.from_numpy(batch["points_mask"]).to(device))


def _quat_z(yaw):
    """(w, x, y, z) of a rotation by ``yaw`` about z."""
    return [math.cos(yaw / 2), 0.0, 0.0, math.sin(yaw / 2)]


def write_nuscenes(root, *, seed, samples, points, sweeps, pc_range,
                   classes, boxes=12):
    """Write a nuScenes-format directory (mmdet3d v0.17 infos) from the
    port's synthetic scenes: per sample a radial key frame of ``points``
    points (``data/synthetic.make_scene``) and ``sweeps`` sweeps, each
    about 97% of the key frame's points, jittered and seen from a sensor
    that moved (a small yaw and a shift, given as ``sensor2lidar_*``).
    The infos carry ``gt_boxes`` (bottom-centred, 7 values),
    ``gt_names``, ``gt_velocity``, ``num_lidar_pts`` (key-frame points in
    the box), ``valid_flag``, ``timestamp`` (us), ``sweeps`` and the
    ``lidar2ego_*`` / ``ego2global_*`` calibration of a submission; one
    pickle is written as both ``nuscenes_infos_train.pkl`` and
    ``nuscenes_infos_val.pkl``. Returns the train infos' path."""
    import pathlib
    import pickle

    from focalformer3d_tpu_torch.data import synthetic

    root = pathlib.Path(root)
    (root / "samples").mkdir(parents=True, exist_ok=True)
    (root / "sweeps").mkdir(exist_ok=True)
    rng = np.random.RandomState(seed)
    infos = []
    for i in range(samples):
        pts, gt, labels = synthetic.make_scene(
            rng, n_points=points, n_boxes=boxes, num_classes=len(classes),
            pc_range=pc_range, mode="radial")
        ts = 1_600_000_000_000_000 + i * 500_000
        lidar_path = root / "samples" / f"lidar_{i:04d}.bin"
        pts.tofile(lidar_path)
        sweep_infos = []
        for j in range(sweeps):
            yaw = rng.uniform(-0.02, 0.02)
            c, s = math.cos(yaw), math.sin(yaw)
            rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
            shift = rng.uniform(-0.25, 0.25, 3) * (j + 1)
            sp = pts[rng.uniform(size=len(pts)) < 0.97].copy()
            sp[:, :3] += rng.normal(0.0, 0.02, (len(sp), 3))
            # lidar = rot @ sensor + shift  =>  sensor = rot^T (lidar - shift)
            sp[:, :3] = (sp[:, :3] - shift) @ rot
            path = root / "sweeps" / f"lidar_{i:04d}_{j}.bin"
            sp.astype(np.float32).tofile(path)
            sweep_infos.append({
                "data_path": str(path), "sensor2lidar_rotation": rot,
                "sensor2lidar_translation": shift,
                "timestamp": ts - (j + 1) * 50_000})
        # key-frame points inside each bottom-centred box
        d = pts[:, None, :2] - gt[None, :, :2]
        cy, sy = np.cos(gt[:, 6]), np.sin(gt[:, 6])
        lx = d[..., 0] * cy + d[..., 1] * sy
        ly = -d[..., 0] * sy + d[..., 1] * cy
        dz = pts[:, None, 2] - gt[None, :, 2]
        inside = ((np.abs(lx) <= gt[:, 3] / 2) & (np.abs(ly) <= gt[:, 4] / 2)
                  & (dz >= 0) & (dz <= gt[:, 5]))
        n_in = inside.sum(0).astype(np.int64)
        infos.append({
            "token": f"sample_{i:04d}", "lidar_path": str(lidar_path),
            "timestamp": ts, "sweeps": sweep_infos,
            "gt_boxes": gt[:, :7].copy(),
            "gt_names": np.array([classes[k] for k in labels], object),
            "gt_velocity": gt[:, 7:9].astype(np.float64),
            "num_lidar_pts": n_in, "valid_flag": n_in > 0,
            "lidar2ego_rotation": _quat_z(0.01),
            "lidar2ego_translation": [0.94, 0.0, 1.84],
            "ego2global_rotation": _quat_z(0.3 + 0.05 * i),
            "ego2global_translation": [600.0 + 2.0 * i, 1600.0, 0.0]})
    ann = root / "nuscenes_infos_train.pkl"
    for name in ("nuscenes_infos_train.pkl", "nuscenes_infos_val.pkl"):
        with open(root / name, "wb") as f:
            pickle.dump({"infos": infos, "metadata": {"version": "synthetic"}},
                        f)
    return str(ann)


def _median_ms(fn, reps=REPS):
    fn()  # warm-up
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    return torch.device("cuda", 0), smi


def phase_build():
    from focalformer3d_tpu_torch.ops import cuda_build

    k1, k2, k3 = _wrappers()
    dot, gather, widen = _probe_wrappers()
    t0 = time.perf_counter()
    secs = cuda_build.build(k1.SOURCE, k1.WGRAD_SOURCE, k2.SOURCE,
                            k3.SOURCE, dot.SOURCE, gather.SOURCE,
                            widen.SOURCE)
    for k in (k1, k2, k3, dot, widen):
        k._load()
    k3._load_grid()
    k1._load_wgrad()
    k1._load_probe()
    k1._load_grid()
    gather._load("taps")
    gather._load("rows")
    print("build: " + ", ".join(f"{stem} {s:.2f} s" for stem, s in
                                secs.items())
          + f" (in parallel; all loaded after "
          f"{time.perf_counter() - t0:.2f} s)", flush=True)
    return secs


def _walk(cfg, vox, meta_chain, n_levels, batch=1):
    """The encoder's index chain on the first ``batch`` samples of a scan
    batch, levels 0 .. n_levels - 1: [(name, src level, dst level, kernel,
    stride, padding)], subm then down per level, conv_out after the last
    stage."""
    from focalformer3d_tpu_torch.models.sparse_encoder import Level

    lvl = Level.from_voxels(vox["coords"][:batch],
                            vox["voxel_mask"][:batch],
                            tuple(cfg.sparse_shape), meta_chain)
    geoms = []
    for i in range(n_levels):
        geoms.append((f"L{i} subm", lvl, lvl, 3, 1, 1))
        if i == len(cfg.encoder_channels) - 1:
            nxt = lvl.downsample((3, 1, 1), (2, 1, 1), 0, cfg.out_capacity)
            geoms.append(("conv_out", lvl, nxt, (3, 1, 1), (2, 1, 1), 0))
        else:
            pad = cfg.down_paddings[i]
            nxt = lvl.downsample(3, 2, pad, cfg.capacities[i + 1])
            geoms.append((f"down{i}", lvl, nxt, 3, 2, pad))
        lvl = nxt
    return geoms


def _convs(cfg, geoms):
    """[(name, geometry index, C, Cout, convs per scan)] of a chain."""
    ch, n_stage = cfg.encoder_channels, len(cfg.encoder_channels)
    convs = []
    for g, (name, *_rest) in enumerate(geoms):
        if name.endswith("subm"):
            i = int(name[1])
            n_basic = len(ch[i]) - (i < n_stage - 1)
            if i == 0:
                convs.append(("conv_input", g, cfg.point_dim, ch[0][0], 1))
            convs.append((name, g, ch[i][0], ch[i][0], 2 * n_basic))
        elif name == "conv_out":
            convs.append((name, g, ch[-1][-1], cfg.sparse_out_channels, 1))
        else:
            i = int(name[4])
            convs.append((name, g, ch[i][-2], ch[i][-1], 1))
    return convs


def _index_build(cfg, vox, engine, n_levels):
    from focalformer3d_tpu_torch.models.sparse_encoder import conv_index

    return [conv_index(src, dst, ks, st, pad, engine) for _, src, dst, ks,
            st, pad in _walk(cfg, vox, engine == "cuda_mxu", n_levels)]


def phase_index_builds(cfg, vox):
    """The three engines' index builds on one scan, end to end (CUDA events
    around host-issued work that ends on the device)."""
    n_stage = len(cfg.encoder_channels)
    rows = [("cuda (torch ops), L0-L1: 4 rulebooks", "cuda", 2),
            ("cuda_mxu (meta chain + K2), L0-L1: 4 rulebooks", "cuda_mxu",
             2),
            ("cuda_mxu (meta chain + K2), all levels: 8 rulebooks",
             "cuda_mxu", n_stage),
            ("cuda_zrun (torch ops + z-run plans), L0-L1: 4 plans",
             "cuda_zrun", 2)]
    for label, engine, n in rows:
        ms = _median_ms(lambda: _index_build(cfg, vox, engine, n))
        print(f"index build {label}: {ms:.3f} ms", flush=True)


def _rand_conv(gen, device, v_in, c, k, cout):
    feats = torch.randn(1, v_in, c, device=device, generator=gen)
    w = (torch.randn(k, c, cout, device=device, generator=gen)
         * (2.0 / (k * c)) ** 0.5)
    bias = torch.randn(cout, device=device, generator=gen)
    return feats.to(torch.bfloat16), w.to(torch.bfloat16), bias


def phase_k2(cfg, vox, mxu_geoms, device):
    from focalformer3d_tpu_torch.ops import plan_builder as tpb
    from focalformer3d_tpu_torch.ops import sparse_conv as sc
    from focalformer3d_tpu_torch.tools import _common

    _, k2, _ = _wrappers()
    k2_ms = plain_ms = torch_ms = 0.0
    bound = Bound()  # meta rows and sites read, rules written; no FLOPs
    rules_by_geom = []
    for name, src, dst, ks, st, pad in mxu_geoms:
        args = (src.meta, dst.colz, src.capacity, ks, st, pad, src.shape,
                dst.shape[2])
        got = k2.plan_rules(*args)
        table = sc.VoxelTable(src.sites()[0], src.valid[0], src.meta[0])
        dst_sites = dst.sites()[0]

        def plain():
            return tpb.decode_rules(dst.colz[0], src.capacity, src.meta[0],
                                    *args[3:])

        def torch_op():
            return sc.build_conv_rules(table, src.shape, dst_sites,
                                       dst.valid[0], ks, st, pad)

        torch.cuda.synchronize()
        if not (torch.equal(got[0], plain()) and torch.equal(got[0],
                                                             torch_op())):
            raise RuntimeError(f"K2 {name}: rulebook differs from "
                               "decode_rules / build_conv_rules")
        ms = _common.time_ms(device, lambda: k2.plan_rules(*args))[0]
        p_ms = _common.time_ms(device, plain, _common.PLAIN_REPS)[0]
        t_ms = _common.time_ms(device, torch_op, _common.PLAIN_REPS)[0]
        print(f"K2 {name}: K {got.shape[1]}, V_in {src.capacity}, V_out "
              f"{dst.capacity} ({int(dst.valid.sum())} active), equal to "
              f"decode_rules and build_conv_rules; kernel {ms:.4f} ms, "
              f"decode_rules {p_ms:.4f} ms, build_conv_rules {t_ms:.4f} ms",
              flush=True)
        k2_ms, plain_ms, torch_ms = (k2_ms + ms, plain_ms + p_ms,
                                     torch_ms + t_ms)
        bound.add(src.meta.numel() * src.meta.element_size()
                  + dst.colz.numel() * dst.colz.element_size()
                  + got.numel() * got.element_size(), 0, "bf16")
        rules_by_geom.append(got)
    print(f"K2 per scan (8 rulebooks): kernel {k2_ms:.3f} ms, decode_rules "
          f"{plain_ms:.3f} ms, build_conv_rules {torch_ms:.3f} ms, bound "
          f"{bound.ms:.4f} ms", flush=True)
    return rules_by_geom, {"max_abs_err": 0, "ms": k2_ms,
                           "plain_ms": plain_ms, "torch_op_ms": torch_ms,
                           **bound.keys()}


def _k1_geometry(tag, name, k1, args, plain, device):
    """K1 (``args`` of ``sparse_conv``) at one geometry: against ``plain``
    within ``KERNEL_TOL`` of its scale, two runs equal bit for bit, the hit
    shares of its rulebook, the launch's plan, and per-call times from
    CUDA-graph replay of production's route, the other route and the plain
    version. Returns (max abs err, ms, plain ms)."""
    from focalformer3d_tpu_torch.tools import _common

    feats, rules, w = args[:3]
    got, ref = k1.sparse_conv(*args), plain()
    again = k1.sparse_conv(*args)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    rel = err / float(ref.abs().max())
    if not rel <= KERNEL_TOL:
        raise RuntimeError(f"{tag} {name}: rel err {rel:.3g} > {KERNEL_TOL}")
    if not torch.equal(got, again):
        raise RuntimeError(f"{tag} {name}: two runs differ")
    c, cout = k1.kernel_widths(feats.shape[2], w.shape[2])
    plan = k1.launch_plan(feats.shape[0], rules.shape[2], rules.shape[1],
                          c, cout)
    other = 1 - k1.route_for(c, cout)
    ms = _common.time_ms(device, lambda: k1.sparse_conv(*args))[0]
    other_ms, alt = _common.time_ms(
        device, lambda: k1.sparse_conv_probe(*args, route=other))
    if not float((alt - ref).abs().max()) <= KERNEL_TOL * float(ref.abs().max()):
        raise RuntimeError(f"{tag} {name}: route {k1.ROUTE_NAMES[other]} "
                           f"differs from plain")
    p_ms = _common.time_ms(device, plain, _common.PLAIN_REPS)[0]
    sh = k1.hit_shares(rules, feats.shape[1])
    print(f"{tag} {name}: C {feats.shape[2]} -> {w.shape[2]}, K "
          f"{rules.shape[1]}, B {feats.shape[0]}, V_in {feats.shape[1]} -> "
          f"V_out {rules.shape[2]}; hit share tile128/group64/strip16/site "
          f"{sh['tile']:.4f}/{sh['group64']:.4f}/{sh['strip16']:.4f}/"
          f"{sh['site']:.4f}; {plan['route']}, grid {plan['grid']}, "
          f"{plan['stages']} stages, W "
          f"{'resident' if plan['w_resident'] else 'streamed'}, "
          f"{plan['smem_bytes']} B shared; rel {rel:.3g}, two runs equal; "
          f"kernel {ms:.4f} ms ({k1.ROUTE_NAMES[other]} {other_ms:.4f}), "
          f"plain {p_ms:.4f} ms", flush=True)
    return err, ms, p_ms


def phase_k1(cfg, coord_geoms, coord_rules, mxu_geoms, mxu_rules, device):
    """K1 at the 5 conv geometries of ``cuda`` (torch-op rulebooks) and the
    4 more that ``cuda_mxu`` runs (K2's rulebooks)."""
    k1, _, _ = _wrappers()
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    n_coord = len(coord_geoms)
    jobs = [(c, coord_geoms, coord_rules) for c in _convs(cfg, coord_geoms)]
    jobs += [(c, mxu_geoms, mxu_rules) for c in _convs(cfg, mxu_geoms)
             if c[1] >= n_coord]
    max_err, per_scan = 0.0, {}
    bound = Bound()  # the 11 convs of a ``cuda`` scan
    for (name, g, c, cout, n), geoms, rules_by_geom in jobs:
        _, src, dst, *_rest = geoms[g]
        rules = rules_by_geom[g]
        feats, w, bias = _rand_conv(gen, device, src.capacity, c,
                                    rules.shape[1], cout)
        args = (feats, rules, w, dst.valid, bias)
        err, ms, p_ms = _k1_geometry(
            "K1", f"{name} ({int(dst.valid.sum())} active)", k1, args,
            lambda: k1.apply_conv_plain(feats.float(), rules, w.float(),
                                        dst.valid, bias, torch.float32),
            device)
        max_err = max(max_err, err)
        per_scan[name] = (n, ms, p_ms)
        if geoms is coord_geoms:
            _conv_bound(bound, rules, src.capacity, dst.valid, c, cout,
                        times=n)

    def total(names):
        return (sum(per_scan[x][0] * per_scan[x][1] for x in names),
                sum(per_scan[x][0] * per_scan[x][2] for x in names))

    cuda_names = [c[0] for c in _convs(cfg, coord_geoms)]
    ms, plain_ms = total(cuda_names)
    mxu_ms, mxu_plain = total(list(per_scan))
    print(f"K1 per scan: cuda (11 convs) kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bound.ms:.4f} ms; cuda_mxu (21 convs) "
          f"kernel {mxu_ms:.3f} ms, plain {mxu_plain:.3f} ms", flush=True)
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            **bound.keys(), "ms_cuda_mxu": mxu_ms,
            "plain_ms_cuda_mxu": mxu_plain}


def _conv_bound(bound, rules, v_in, out_valid, c, cout, index_numel=None,
                times=1):
    """A forward conv (K1, K3): bf16 features and weights, the int32 index,
    bias and out_valid read once, the f32 output written once; 2 FLOPs per
    hit and (c, cout) pair, at the bf16 peak."""
    B, v_out = out_valid.shape
    K = rules.shape[1]
    nbytes = (B * v_in * c * 2 + (index_numel or rules.numel()) * 4
              + K * c * cout * 2 + cout * 4 + B * v_out
              + B * v_out * cout * 4)
    bound.add(nbytes, 2 * _hits(rules, v_in, out_valid) * c * cout, "bf16",
              times)


def phase_k3(cfg, vox, device):
    """K3 at the 5 conv geometries of ``cuda_zrun``: against its plain
    version within ``KERNEL_TOL`` of its scale on both routes, two runs
    equal bit for bit, the hit shares of its codes, the launch's plan, and
    per-call times from CUDA-graph replay."""
    from focalformer3d_tpu_torch.models.sparse_encoder import conv_index
    from focalformer3d_tpu_torch.ops.sparse_conv_zrun import (
        apply_conv_zrun_plain, zrun_rules)
    from focalformer3d_tpu_torch.tools import _common

    k1, _, k3 = _wrappers()
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    geoms = _walk(cfg, vox, False, 2)
    codes = [conv_index(src, dst, ks, st, pad, "cuda_zrun")
             for _, src, dst, ks, st, pad in geoms]
    max_err = k3_ms = plain_ms = 0.0
    bound = Bound()  # hits counted on the rulebook the codes encode
    for name, g, c, cout, n in _convs(cfg, geoms):
        _, src, dst, *_rest = geoms[g]
        cd = codes[g]
        feats, w, bias = _rand_conv(gen, device, src.capacity, c,
                                    3 * cd.shape[1], cout)
        args = (feats, cd, w, dst.valid, bias)

        def plain():
            return apply_conv_zrun_plain(feats.float(), cd, w.float(),
                                         dst.valid, bias, torch.float32)

        got, ref = k3.zrun_conv(*args), plain()
        again = k3.zrun_conv(*args)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        if not err <= KERNEL_TOL * scale:
            raise RuntimeError(f"K3 {name}: rel err {err / scale:.3g} > "
                               f"{KERNEL_TOL}")
        if not torch.equal(got, again):
            raise RuntimeError(f"K3 {name}: two runs differ")
        kc, kcout = k1.kernel_widths(c, cout)
        other = 1 - k3.route_for(kc, kcout)
        plan = k3.launch_plan(1, cd.shape[2], cd.shape[1], kc, kcout)
        ms = _common.time_ms(device, lambda: k3.zrun_conv(*args))[0]
        other_ms, alt = _common.time_ms(
            device, lambda: k3.zrun_conv(*args, route=other))
        if not float((alt - ref).abs().max()) <= KERNEL_TOL * scale:
            raise RuntimeError(f"K3 {name}: route {k1.ROUTE_NAMES[other]} "
                               "differs from plain")
        p_ms = _common.time_ms(device, plain, _common.PLAIN_REPS)[0]
        sh = k3.zrun_hit_shares(cd)
        print(f"K3 {name}: C {c} -> {cout}, {cd.shape[1]} BEV taps, V_in "
              f"{src.capacity} -> V_out {dst.capacity}; hit share "
              f"tile128/group64/strip16/site {sh['tile']:.4f}/"
              f"{sh['group64']:.4f}/{sh['strip16']:.4f}/{sh['site']:.4f}; "
              f"{plan['route']}, grid {plan['grid']}, {plan['stages']} "
              f"stages of {plan['z_per_stage']} z taps, W "
              f"{'resident' if plan['w_resident'] else 'streamed'}, "
              f"{plan['smem_bytes']} B shared; rel {err / scale:.3g}, two "
              f"runs equal; kernel {ms:.4f} ms ({k1.ROUTE_NAMES[other]} "
              f"{other_ms:.4f}), plain {p_ms:.4f} ms", flush=True)
        max_err = max(max_err, err)
        k3_ms, plain_ms = k3_ms + n * ms, plain_ms + n * p_ms
        _conv_bound(bound, zrun_rules(cd, src.capacity), src.capacity,
                    dst.valid, c, cout, index_numel=cd.numel(), times=n)
    print(f"K3 per scan (11 convs): kernel {k3_ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bound.ms:.4f} ms", flush=True)
    return {"max_abs_err": max_err, "ms": k3_ms, "plain_ms": plain_ms,
            **bound.keys()}


def _model(cfg, device):
    from focalformer3d_tpu_torch.models.detector import FocalFormer3D
    from focalformer3d_tpu_torch.utils.ref_keys import make_fake_state_dict

    model = FocalFormer3D(cfg).eval()
    model.load_state_dict(make_fake_state_dict(model, seed=0), strict=True)
    return model.to(device)


def phase_slice(cfg, model, engine, scans):
    """Three scans on one engine; returns the (K1, K2, K3) launches, counted
    from zero just before the first scan and read just after the last."""
    from focalformer3d_tpu_torch.models.detector import preprocess_points

    kernels = _wrappers()
    enc = model.pts_middle_encoder
    enc.engine = engine
    enc_events = []

    def mark(*_):  # CUDA event at the encoder's entry and exit
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        enc_events.append(ev)

    hooks = [enc.register_forward_pre_hook(mark),
             enc.register_forward_hook(mark)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wall, split = [], []
    for k in kernels:
        k.reset_launch_count()
    try:
        for pts, mask in scans:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            t0 = time.perf_counter()
            ev[0].record()
            vox = preprocess_points(cfg, pts, mask)
            ev[1].record()
            dec = model.get_bboxes(model(vox), 200)
            ev[2].record()
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
            e_in, e_out = enc_events[-2], enc_events[-1]
            t_vox = ev[0].elapsed_time(ev[1])
            t_enc = e_in.elapsed_time(e_out)
            split.append((t_vox, t_enc, ev[1].elapsed_time(ev[2]) - t_enc))
            for k in ("bboxes", "scores"):
                if not torch.isfinite(dec[k]).all():
                    raise RuntimeError(f"{engine}: non-finite {k}")
            kept = int(dec["mask"].sum())
            if dec["bboxes"].shape[-1] != 9 or kept != 200:
                raise RuntimeError(f"{engine}: expected 200 kept 9-dim "
                                   f"boxes, got {kept} of "
                                   f"{tuple(dec['bboxes'].shape)}")
    finally:
        for h in hooks:
            h.remove()
    launches = tuple(k.launch_count() for k in kernels)
    want = tuple(n * len(scans) for n in LAUNCHES_PER_SCAN[engine])
    if launches != want:
        raise RuntimeError(f"{engine}: (K1, K2, K3) launched {launches} "
                           f"times for {len(scans)} scans, expected {want}")
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(wall)
    print(f"slice {engine}: ms/scan " + ", ".join(f"{t:.1f}" for t in wall)
          + f" (median {med:.1f}); voxelize/encoder/rest ms "
          + "; ".join("/".join(f"{x:.1f}" for x in s) for s in split)
          + f"; peak memory {peak / 2**30:.2f} GiB; (K1, K2, K3) launches "
          f"{launches}", flush=True)
    return launches


def phase_engine_parity(cfg, model, device):
    from focalformer3d_tpu_torch.models.detector import preprocess_points
    from focalformer3d_tpu_torch.models.sparse_encoder import SparseEncoder

    pts, mask = _scan(cfg, 0, device)
    vox = preprocess_points(cfg, pts, mask)
    enc = model.pts_middle_encoder
    plain = SparseEncoder(
        in_channels=cfg.point_dim, sparse_shape=cfg.sparse_shape,
        output_channels=cfg.sparse_out_channels,
        encoder_channels=cfg.encoder_channels,
        down_paddings=cfg.down_paddings, capacities=cfg.capacities,
        out_capacity=cfg.out_capacity, engine="plain",
    ).to(device).eval()
    plain.load_state_dict(enc.state_dict(), strict=True)
    args = (vox["features"], vox["coords"], vox["voxel_mask"])
    ref = {}
    for engine in ENGINES:
        enc.engine = engine
        dense_from = 4 if engine == "cuda_mxu" else cfg.sparse_dense_from_eval
        if dense_from not in ref:
            plain.dense_from = dense_from
            ref[dense_from] = plain(*args)
        got = enc(*args)
        torch.cuda.synchronize()
        r = ref[dense_from]
        rel = float((got - r).abs().max() / r.abs().max())
        if not rel <= ENGINE_TOL:
            raise RuntimeError(f"BEV {engine} vs plain engine rel {rel:.3g}")
        print(f"engine parity: BEV {tuple(got.shape)} {engine} vs plain "
              f"engine (dense_from={dense_from}) max rel diff {rel:.3g} "
              f"(limit {ENGINE_TOL})", flush=True)


def _train_batch(cfg, device):
    from focalformer3d_tpu_torch.data import synthetic

    batch = synthetic.make_batch(
        np.random.RandomState(TRAIN_SEED), batch_size=TRAIN_BATCH,
        n_points=N_POINTS, n_boxes=24, max_gts=32,
        num_classes=cfg.decoder.num_classes,
        pc_range=cfg.voxel.point_cloud_range, mode="radial",
    )
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def phase_k1_grad(cfg, batch, device):
    """K1's differentiable conv at each conv of a training batch (engine
    ``cuda``, dense from L3), against autograd through its plain version;
    then each kernel alone against its plain version. Returns per kernel
    use (forward, dx, wgrad) the max error, per-step ms and bound."""
    from focalformer3d_tpu_torch.models.detector import preprocess_points
    from focalformer3d_tpu_torch.models.sparse_encoder import conv_index
    from focalformer3d_tpu_torch.ops import sparse_conv as sc
    from focalformer3d_tpu_torch.tools import _common

    k1, _, _ = _wrappers()
    bf16 = torch.bfloat16
    vox = preprocess_points(cfg, batch["points"], batch["points_mask"],
                            train=True)
    B = vox["coords"].shape[0]
    geoms = _walk(cfg, vox, False, cfg.sparse_dense_from, batch=B)
    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    stats = {kind: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                    "bound": Bound()}
             for kind in ("forward", "dx", "wgrad")}
    for name, g, c, cout, n in _convs(cfg, geoms):
        _, src, dst, ks, st, pad = geoms[g]
        rules = conv_index(src, dst, ks, st, pad, "cuda")
        rules_t = rules if st == 1 else torch.stack([
            sc.transpose_rules(rules[b], src.capacity) for b in range(B)])
        K = rules.shape[1]
        x = torch.where(src.valid[..., None], torch.randn(
            B, src.capacity, c, device=device, generator=gen), 0.0)
        w = (torch.randn(K, c, cout, device=device, generator=gen)
             * (2.0 / (K * c)) ** 0.5)
        cot = torch.where(dst.valid[..., None], torch.randn(
            B, dst.capacity, cout, device=device, generator=gen), 0.0)
        need_dx = name != "conv_input"  # as on the main path
        res = {}
        for tag in ("kernel", "plain"):
            xx = x.clone().requires_grad_(need_dx)
            ww = w.clone().requires_grad_(True)
            with torch.enable_grad():
                if tag == "kernel":
                    y = k1.sparse_conv_train(xx, rules, rules_t, ww,
                                             dst.valid)
                else:
                    y = k1.apply_conv_bf16_plain(xx, rules, ww, dst.valid)
                y.backward(cot)
            res[tag] = {"forward": y.detach(), "dx": xx.grad,
                        "wgrad": ww.grad}
        torch.cuda.synchronize()

        xb, wb = x.to(bf16), w.to(bf16)
        w_tb = wb.flip(0).transpose(1, 2).contiguous()
        w_t = w_tb.float()
        every = torch.ones(B, src.capacity, dtype=torch.bool, device=device)
        runs = {
            "forward": (lambda: k1.sparse_conv(xb, rules, wb, dst.valid),
                        lambda: k1.apply_conv_plain(
                            xb.float(), rules, wb.float(), dst.valid)),
            "dx": (lambda: k1.conv_dx(cot, rules_t, wb),
                   lambda: k1.apply_conv_plain(
                       cot.to(bf16).float(), rules_t, w_t, every)),
            "wgrad": (lambda: k1.conv_wgrad(xb, cot, rules),
                      lambda: k1.wgrad_plain(xb, cot, rules)),
        }
        # K1's operands per use, for the route production does not take
        k1_args = {"forward": (xb, rules, wb, dst.valid),
                   "dx": (cot.to(bf16), rules_t, w_tb, every)}
        hits = _hits(rules, src.capacity, dst.valid)
        flops = 2 * hits * c * cout
        w_elems = K * c * cout
        nbytes = {  # each input read once, each output written once
            "dx": (B * dst.capacity * cout * 4 + rules_t.numel() * 4
                   + w_elems * 2 + B * src.capacity * c * 4),
            "wgrad": (B * src.capacity * c * 2 + B * dst.capacity * cout * 4
                      + rules.numel() * 4 + w_elems * 4),
        }
        line = []
        for kind, (run, plain) in runs.items():
            if kind == "dx" and not need_dx:
                continue
            got, ref = res["kernel"][kind], res["plain"][kind]
            err = float((got - ref).abs().max())
            rel = err / float(ref.abs().max())
            if not rel <= KERNEL_TOL:
                raise RuntimeError(f"K1 {kind} {name}: rel err {rel:.3g} > "
                                   f"{KERNEL_TOL}")
            ms = _common.time_ms(device, run)[0]  # the device's time
            p_ms = _common.time_ms(device, plain, _common.PLAIN_REPS)[0]
            if kind == "wgrad":
                if not torch.equal(run(), run()):
                    raise RuntimeError(f"K1 wgrad {name}: two runs differ")
                chunk = k1.wgrad_chunk(*(next(n for n in k1.COUTS if n >= w)
                                         for w in (c, cout)))
                slices, per = k1.wgrad_slices(B * dst.capacity, K)
                note = (f" [{k1.ROUTE_NAMES[k1.WGRAD_ROUTE]}, chunk {chunk} "
                        f"hits, {slices} slices of {per} sites, two runs "
                        "equal]")
            else:
                a = k1_args[kind]
                kc, kcout = k1.kernel_widths(a[0].shape[2], a[2].shape[2])
                plan = k1.launch_plan(B, a[1].shape[2], K, kc, kcout)
                # the kernel alone on prepared operands, on each route (the
                # wrapper's time above includes dx's casts and transposes)
                alone = {name: _common.time_ms(
                    device, lambda r=r: k1.sparse_conv_probe(*a, route=r))[0]
                    for r, name in k1.ROUTE_NAMES.items()}
                sh = k1.hit_shares(a[1], a[0].shape[1])
                note = (f" [{plan['route']}, grid {plan['grid']}, W "
                        f"{'resident' if plan['w_resident'] else 'streamed'}"
                        f"; kernel alone " + ", ".join(
                            f"{n} {t:.4f}" for n, t in alone.items())
                        + " ms; hit share "
                        f"tile128/group64/strip16/site {sh['tile']:.4f}/"
                        f"{sh['group64']:.4f}/{sh['strip16']:.4f}/"
                        f"{sh['site']:.4f}]")
            s = stats[kind]
            s["max_abs_err"] = max(s["max_abs_err"], err)
            s["ms"] += n * ms
            s["plain_ms"] += n * p_ms
            if kind == "forward":
                _conv_bound(s["bound"], rules, src.capacity, dst.valid, c,
                            cout, times=n)
            else:
                s["bound"].add(nbytes[kind], flops,
                               "bf16 split" if kind == "wgrad" else "bf16",
                               times=n)
            line.append(f"{kind} rel {rel:.3g}, {ms:.4f} / {p_ms:.4f} ms"
                        + note)
        print(f"K1 train {name} x{n}: C {c} -> {cout}, K {K}, V_in "
              f"{src.capacity} -> V_out {dst.capacity} (B {B}, "
              f"{int(dst.valid.sum())} active, {hits} hits); kernel / plain: "
              + "; ".join(line), flush=True)
    out = {}
    for kind, s in stats.items():
        bound = s.pop("bound")
        out[kind] = {**s, **bound.keys()}
        print(f"K1 {kind} per training step ({TRAIN_LAUNCHES_PER_STEP[kind]}"
              f" launches): kernel {s['ms']:.3f} ms, plain "
              f"{s['plain_ms']:.3f} ms, bound {bound.ms:.4f} ms "
              f"({out[kind]['bound_by']})", flush=True)
    return out


def phase_train(cfg, batch, device):
    """``TRAIN_STEPS`` training steps of FocalFormer3D_L on engine ``cuda``;
    returns the K1 forward / dx / dW launches, counted from zero just
    before the first step and read just after the last."""
    from focalformer3d_tpu_torch.configs import get_config
    from focalformer3d_tpu_torch.models.detector import FocalFormer3D
    from focalformer3d_tpu_torch.training import optim, train_step
    from focalformer3d_tpu_torch.training.train_step import PHASES
    from focalformer3d_tpu_torch.utils.ref_keys import make_fake_state_dict

    k1, _, _ = _wrappers()
    model = FocalFormer3D(cfg)
    model.load_state_dict(make_fake_state_dict(model, seed=0), strict=True)
    model = model.to(device)
    tx = optim.make_optimizer(total_steps=100)
    opt_state = tx.init(list(model.parameters()))
    step = train_step.make_train_step(
        cfg, get_config("FocalFormer3D_L")["loss"], tx)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wall, split, peaks = [], [], []
    k1.reset_launch_count()
    for i in range(TRAIN_STEPS):
        events, mem = [], []

        def mark(_name):  # no synchronise: an event and the allocator
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
            mem.append(torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()

        t0 = time.perf_counter()
        mark("start")
        metrics = step(model, opt_state, batch, gen, mark)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        split.append([a.elapsed_time(b)
                      for a, b in zip(events[:-1], events[1:])])
        peaks.append(mem[1:])
        vals = {k: float(v) for k, v in metrics.items()}
        bad = [k for k, v in vals.items() if not math.isfinite(v)]
        if bad:
            raise RuntimeError(f"train step {i}: non-finite {bad}")
        print(f"train step {i}: {wall[-1]:.1f} ms; " + ", ".join(
            f"{k} {vals[k]:.5g}" for k in sorted(vals)), flush=True)
    launches = {kind: k1.launch_count(kind)
                for kind in TRAIN_LAUNCHES_PER_STEP}
    want = {kind: n * TRAIN_STEPS
            for kind, n in TRAIN_LAUNCHES_PER_STEP.items()}
    if launches != want:
        raise RuntimeError(f"train: K1 forward/dx/dW launched {launches} "
                           f"times in {TRAIN_STEPS} steps, expected {want}")
    peak = max(max(p) for p in peaks)
    phase_peak = [max(p[j] for p in peaks) for j in range(len(peaks[0]))]
    after = model.state_dict()
    params = [k for k, _ in model.named_parameters()]
    still = [k for k in params if torch.equal(after[k], before[k])]
    stats = [k for k in after if k.endswith("running_mean")]
    still_bn = [k for k in stats if torch.equal(after[k], before[k])]
    if still or still_bn:
        raise RuntimeError(f"train: unchanged after {TRAIN_STEPS} steps: "
                           f"{(still + still_bn)[:8]}")
    rest = split[1:]
    med = [statistics.median(s[j] for s in rest) for j in range(len(PHASES))]
    print(f"train: FocalFormer3D_L float32, batch {TRAIN_BATCH}, engine "
          f"cuda: ms/step first {wall[0]:.1f}, then "
          + ", ".join(f"{t:.1f}" for t in wall[1:])
          + f" (median {statistics.median(wall[1:]):.1f}); split median ms "
          + ", ".join(f"{p} {t:.1f}" for p, t in zip(PHASES, med))
          + f" (first step: " + ", ".join(f"{t:.1f}" for t in split[0])
          + f"); peak memory {peak / 2**30:.2f} GiB (by phase, GiB: "
          + ", ".join(f"{p} {m / 2**30:.2f}"
                      for p, m in zip(PHASES, phase_peak))
          + f"); {len(params)} "
          f"parameters and {len(stats)} running means all moved; K1 "
          f"launches {launches}", flush=True)
    _profile_step(lambda: step(model, opt_state, batch, gen))
    return launches


def _profile_step(run):
    """One more step under ``torch.profiler`` (after the counted, timed
    ones): kernels launched, device busy time (union of kernel intervals)
    against the step's host time, and the kernels that take the most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, -math.inf
    for s, e in spans:  # union of intervals, us
        if e > end:
            busy += e - max(s, end)
            end = e
    by_name, count = {}, {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        count[e.name] = count.get(e.name, 0) + 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    print(f"train profile (one step, profiler on): {len(kernels)} kernels, "
          f"device busy {busy / 1e3:.1f} ms of {wall:.1f} ms host time "
          f"(share {busy / 1e3 / wall:.2f}); top kernels ms (launches): "
          + "; ".join(f"{n[:60]} {t / 1e3:.2f} ({count[n]})" for n, t in top),
          flush=True)
    # who launched the three largest: the outermost aten op above each
    # launch, with its input shapes, most time first (the profiler can list
    # one kernel under several ops, so only the order is printed)
    owners = {}
    for e in prof.events():
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        op, p = e, e.cpu_parent
        while p is not None:
            if p.name.startswith("aten::"):
                op = p
            p = p.cpu_parent
        label = f"{op.name} {op.input_shapes}"[:110]
        for k in e.kernels:
            d = owners.setdefault(k.name, {})
            d[label] = d.get(label, 0.0) + k.duration
    for name, _ in top[:3]:
        ops = sorted(owners.get(name, {}).items(), key=lambda kv: -kv[1])
        print(f"train profile: {name[:60]} launched by: "
              + "; ".join(lab for lab, _ in ops[:3]), flush=True)


def _run_cli(main, argv):
    """``main(argv)`` with its standard output captured, then echoed;
    returns (its result, its one JSON line parsed, if it prints one)."""
    import contextlib
    import io

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            result = main(argv)
    finally:
        print(buf.getvalue(), end="", flush=True)
    text = buf.getvalue()
    found = [json.loads(x) for x in text.splitlines() if x.startswith("{")]
    if len(found) > 1:
        raise RuntimeError(f"{argv[:2]}: {len(found)} JSON lines")
    return result, (found[0] if found else None)


def _model_path_launches():
    k1, k2, k3 = _wrappers()
    return {"sparse_conv": k1.launch_count("forward"),
            "sparse_conv_dx": k1.launch_count("dx"),
            "sparse_conv_wgrad": k1.launch_count("wgrad"),
            "plan_rules": k2.launch_count(),
            "sparse_conv_zrun": k3.launch_count()}


def _phase_train_cli(work, card):
    from focalformer3d_tpu_torch.tools import train as train_cli
    from focalformer3d_tpu_torch.training import checkpoint as ckpt

    argv = ["FocalFormer3D_L", "--synthetic", "--epochs", "2",
            "--iters-per-epoch", "2", "--keep-last", "1", "--log-interval",
            "1", "--batch-size", str(TRAIN_BATCH), "--work-dir", work,
            "--no-tensorboard"]
    # as a process of its own starts (cuDNN may round float32 to TF32):
    # the CLI must set its own precision
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    for f in flags:
        f.allow_tf32 = True
    run, _ = _run_cli(train_cli.main, argv)
    if any(f.allow_tf32 for f in flags):
        raise RuntimeError("train CLI: TF32 left allowed")
    with open(f"{work}/train_log.jsonl") as fh:
        recs = [json.loads(x) for x in fh]
    losses = [r["loss"] for r in recs if r["mode"] == "train"]
    secs = [r["time"] for r in recs if r["mode"] == "train"]
    if len(losses) != 4 or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"train CLI: losses {losses}")
    if ckpt.list_epochs(work) != [2] or run.opt_state.count != 4:
        raise RuntimeError(f"train CLI: epochs {ckpt.list_epochs(work)} "
                           f"saved, step {run.opt_state.count}")
    again, _ = _run_cli(train_cli.main, argv)
    if again.start_epoch != 2 or again.opt_state.count != 4:
        raise RuntimeError(f"train CLI: resumed at epoch "
                           f"{again.start_epoch}, step "
                           f"{again.opt_state.count}")
    ref, got = run.model.state_dict(), again.model.state_dict()
    diff = [k for k in ref if not torch.equal(ref[k], got[k])]
    diff += [n for n, a, b in zip(run.opt_state.names,
                                  run.opt_state.mu + run.opt_state.nu,
                                  again.opt_state.mu + again.opt_state.nu)
             if not torch.equal(a, b)]
    if diff:
        raise RuntimeError(f"train CLI: resumed state differs: {diff[:5]}")
    print(f"entry points ({card}): train CLI losses " + ", ".join(
        f"{x:.4f}" for x in losses) + "; s/it (synthetic) " + ", ".join(
        f"{x:.3f}" for x in secs) + "; epoch_2 kept, epoch_1 pruned; "
        f"resumed at epoch 2, step 4, {len(ref)} tensors and the moments "
        "bit for bit; TF32 off after the CLI set its precision",
        flush=True)


def _phase_freeze(cfg, batch, device):
    """Two steps of FocalFormer3D_L with ``freeze_pts``."""
    from focalformer3d_tpu_torch.configs import get_config
    from focalformer3d_tpu_torch.models.detector import FocalFormer3D
    from focalformer3d_tpu_torch.training import optim, train_step
    from focalformer3d_tpu_torch.utils.ref_keys import make_fake_state_dict

    k1, _, _ = _wrappers()
    fcfg = dataclasses.replace(cfg, freeze_pts=True)
    model = FocalFormer3D(fcfg)
    model.load_state_dict(make_fake_state_dict(model, seed=0), strict=True)
    model = model.to(device)
    tx = optim.make_optimizer(total_steps=100)
    opt_state = tx.init(model.named_parameters())
    step = train_step.make_train_step(
        fcfg, get_config("FocalFormer3D_L")["loss"], tx)
    gen = torch.Generator(device=device)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    before_k1 = {k: k1.launch_count(k) for k in ("forward", "dx", "wgrad")}
    for i in range(2):
        gen.manual_seed(i)
        metrics = step(model, opt_state, batch, gen)
        if not all(math.isfinite(float(v)) for v in metrics.values()):
            raise RuntimeError(f"freeze_pts step {i}: non-finite metrics")
    per_step = {k: (k1.launch_count(k) - n) / 2
                for k, n in before_k1.items()}
    want = {"forward": LAUNCHES_PER_SCAN["cuda"][0], "dx": 0, "wgrad": 0}
    if per_step != want:
        raise RuntimeError(f"freeze_pts: K1 launches per step {per_step}, "
                           f"expected {want}")
    after = model.state_dict()
    pts = ("pts_middle_encoder.", "pts_backbone.", "pts_neck.",
           "imgpts_neck.shared_conv_pts.")
    frozen = [k for k in after if k.startswith(pts)]
    changed = [k for k in frozen if not torch.equal(after[k], before[k])]
    head = [k for k in after if k.startswith("pts_bbox_head.")]
    moved = [k for k in head if not torch.equal(after[k], before[k])]
    if changed or len(moved) < len(head) // 2:
        raise RuntimeError(f"freeze_pts: frozen tensors changed "
                           f"{changed[:5]}; head moved {len(moved)} of "
                           f"{len(head)}")
    print(f"entry points: freeze_pts, 2 steps: {len(frozen)} point-branch "
          f"tensors (parameters, batch-norm statistics, shared_conv_pts) "
          f"bit-identical, {len(moved)} of {len(head)} head tensors moved; "
          f"K1 forward / dx / dW per step {per_step}", flush=True)


def phase_entry_points(cfg, batch, device, card):
    """The train and benchmark CLIs and a frozen-branch run; returns the
    model-path kernels' launches, counted from zero just before the phase
    and read just after."""
    import tempfile

    from focalformer3d_tpu_torch.tools import benchmark

    t0 = time.perf_counter()
    for k in _wrappers():
        k.reset_launch_count()
    with tempfile.TemporaryDirectory() as work:
        _phase_train_cli(work, card)
    torch.cuda.empty_cache()
    _phase_freeze(cfg, batch, device)
    torch.cuda.empty_cache()
    _, rec = _run_cli(benchmark.main, [
        "FocalFormer3D_L", "--engines", ",".join(ENGINES), "--samples", "3",
        "--warmup", "1"])
    if rec is None or sorted(rec["engines"]) != sorted(ENGINES):
        raise RuntimeError(f"benchmark: no JSON line for {ENGINES}")
    torch.cuda.empty_cache()
    _, rec = _run_cli(benchmark.main, [
        "FocalFormer3D_L", "--train", "--samples", "2", "--batch-size",
        str(TRAIN_BATCH)])
    if rec is None or not math.isfinite(rec["ms_per_step"]["median"]):
        raise RuntimeError("benchmark --train: no JSON line")
    torch.cuda.empty_cache()
    launches = _model_path_launches()
    if not all(launches.values()):
        raise RuntimeError(f"entry points: a kernel was not launched: "
                           f"{launches}")
    print(f"entry points: {time.perf_counter() - t0:.1f} s; launches "
          f"{launches}", flush=True)
    return launches


def _host_ms(cfg_all, root):
    """Host ms per sample of the train CLI's data path
    (``tools.train.nuscenes_batches``: ``get_sample`` through the train
    pipeline with GT-paste, then ``collate`` at batch 2), over every sample
    of the written directory."""
    from focalformer3d_tpu_torch.data import nuscenes as nusc
    from focalformer3d_tpu_torch.tools import train as train_cli

    classes = cfg_all["class_names"]
    cfg = cfg_all["model"]
    rng = np.random.RandomState(0)
    _, _, ds = train_cli.nuscenes_batches(
        train_cli.parse_args(["FocalFormer3D_L", "--data-root", root]),
        cfg_all, 2, rng)
    get_ms, collate_ms, n_pts, n_gts = [], [], [], []
    for i in range(0, len(ds), 2):
        t0 = time.perf_counter()
        samples = [ds.get_sample(j, rng) for j in (i, i + 1)]
        t1 = time.perf_counter()
        nusc.collate(samples, classes, max_points=300000,
                     max_gts=cfg.decoder.max_gts // 4)
        t2 = time.perf_counter()
        get_ms.append((t1 - t0) * 1e3 / 2)
        collate_ms.append((t2 - t1) * 1e3 / 2)
        n_pts += [len(s["points"]) for s in samples]
        n_gts += [len(s["gt_boxes"]) for s in samples]
    return get_ms, collate_ms, n_pts, n_gts


def _check_submission(path, n_samples, engine):
    with open(path) as fh:
        sub = json.load(fh)["results"]
    if len(sub) != n_samples:
        raise RuntimeError(f"test CLI {engine}: {len(sub)} tokens in the "
                           f"submission, expected {n_samples}")
    for token, anns in sub.items():
        vals = [x for a in anns for k in ("translation", "size", "rotation",
                                          "velocity") for x in a[k]]
        vals += [a["detection_score"] for a in anns]
        if len(anns) > 500 or not all(math.isfinite(x) for x in vals):
            raise RuntimeError(f"test CLI {engine}: {token}: {len(anns)} "
                               "boxes or non-finite values")
    return sum(len(a) for a in sub.values())


def phase_dataset(card):
    """The train and test CLIs on a written nuScenes-format directory;
    returns the model-path kernels' launches, counted from zero just
    before the train CLI and read just after the last test CLI."""
    import tempfile

    from focalformer3d_tpu_torch.configs import get_config
    from focalformer3d_tpu_torch.data import native
    from focalformer3d_tpu_torch.tools import create_data
    from focalformer3d_tpu_torch.tools import test as test_cli
    from focalformer3d_tpu_torch.tools import train as train_cli
    from focalformer3d_tpu_torch.training import checkpoint as ckpt

    t_phase = time.perf_counter()
    cfg_all = get_config("FocalFormer3D_L")
    k1, _, _ = _wrappers()
    with tempfile.TemporaryDirectory() as tmp:
        root = f"{tmp}/nuscenes"
        t0 = time.perf_counter()
        ann = write_nuscenes(
            root, seed=DATASET_SEED, samples=DATASET_SAMPLES,
            points=DATASET_POINTS, sweeps=DATASET_SWEEPS,
            pc_range=cfg_all["model"].voxel.point_cloud_range,
            classes=cfg_all["class_names"])
        t1 = time.perf_counter()
        create_data.create_gt_database(ann, root, root)
        print(f"dataset ({card}): wrote {DATASET_SAMPLES} samples of a "
              f"{DATASET_POINTS}-point key frame and {DATASET_SWEEPS} sweeps "
              f"in {t1 - t0:.1f} s, GT database in "
              f"{time.perf_counter() - t1:.1f} s", flush=True)
        get_ms, collate_ms, n_pts, n_gts = _host_ms(cfg_all, root)
        print(f"dataset host ms per sample ({card}; train pipeline with "
              f"GT-paste, batch 2): get_sample " + ", ".join(
                  f"{x:.1f}" for x in get_ms) + "; collate " + ", ".join(
                  f"{x:.1f}" for x in collate_ms) + f"; points per sample "
              f"{min(n_pts)}-{max(n_pts)}, GT boxes {min(n_gts)}-"
              f"{max(n_gts)}", flush=True)

        work = f"{tmp}/work"
        for k in _wrappers():
            k.reset_launch_count()
        native.reset_call_count()
        run, _ = _run_cli(train_cli.main, [
            "FocalFormer3D_L", "--data-root", root, "--epochs", "2",
            "--iters-per-epoch", "2", "--batch-size", str(TRAIN_BATCH),
            "--log-interval", "1", "--work-dir", work, "--no-tensorboard"])
        with open(f"{work}/train_log.jsonl") as fh:
            recs = [r for r in map(json.loads, fh) if r["mode"] == "train"]
        losses = [r["loss"] for r in recs]
        if len(losses) != 4 or not all(math.isfinite(x) for x in losses):
            raise RuntimeError(f"dataset train CLI: losses {losses}")
        if 2 not in ckpt.list_epochs(work):
            raise RuntimeError(f"dataset train CLI: epochs "
                               f"{ckpt.list_epochs(work)} saved")
        launches = {kind: k1.launch_count(kind)
                    for kind in TRAIN_LAUNCHES_PER_STEP}
        want = {kind: 4 * n for kind, n in TRAIN_LAUNCHES_PER_STEP.items()}
        if launches != want:
            raise RuntimeError(f"dataset train CLI: K1 forward/dx/dW "
                               f"{launches}, expected {want}")
        # the first batch (drawn as JAX draws it to initialise) + 4 steps
        loads = native.call_count()
        if loads != 5 * TRAIN_BATCH:
            raise RuntimeError(f"dataset train CLI: {loads} native loads, "
                               f"expected {5 * TRAIN_BATCH}")
        if any(type(t).__name__ == "ObjectSample"
               for t in run.pipeline.transforms):
            raise RuntimeError("dataset train CLI: Fading left ObjectSample")
        print(f"dataset train CLI ({card}; FocalFormer3D_L float32, batch "
              f"{TRAIN_BATCH}, GT-paste, Fading at epoch 1): losses "
              + ", ".join(f"{x:.4f}" for x in losses) + "; s/it "
              + ", ".join(f"{r['time']:.3f}" for r in recs)
              + f"; epoch_2 saved; K1 forward/dx/dW {launches}; {loads} "
              "native loads; ObjectSample gone after Fading", flush=True)
        torch.cuda.empty_cache()

        for engine, want in DATASET_TEST_LAUNCHES.items():
            before = _model_path_launches()
            out = f"{tmp}/sub_{engine}.json"
            res, rec = _run_cli(test_cli.main, [
                "FocalFormer3D_L", "--data-root", root, "--checkpoint",
                f"{work}/epoch_2", "--limit", str(DATASET_SAMPLES),
                "--engine", engine, "--out", out, "--tracking-out",
                f"{tmp}/trk_{engine}.json"])
            got = {k: n - before[k] for k, n in _model_path_launches().items()}
            full = {k: want.get(k, 0) for k in got}
            if got != full:
                raise RuntimeError(f"dataset test CLI {engine}: launches "
                                   f"{got}, expected {full}")
            keys = {"mAP", "mATE", "mASE", "mAOE", "mAVE", "nds_no_attr"}
            keys |= {f"AP_{c}" for c in cfg_all["class_names"]}
            if rec is None or set(rec) != keys:
                raise RuntimeError(f"dataset test CLI {engine}: metrics "
                                   f"{rec}")
            n_boxes = _check_submission(out, DATASET_SAMPLES, engine)
            steady = (res.samples - 1) / (res.seconds - res.seconds_first)
            print(f"dataset test CLI {engine} ({card}): "
                  f"{res.samples / res.seconds:.3f} samples/s ("
                  f"{res.samples} samples in {res.seconds:.2f} s, the first "
                  f"in {res.seconds_first:.2f} s; after it {steady:.3f} "
                  f"samples/s); {n_boxes} boxes in the submission, all "
                  f"finite; mAP {rec['mAP']}, nds_no_attr "
                  f"{rec['nds_no_attr']}; launches {got}", flush=True)
            torch.cuda.empty_cache()
    launches = _model_path_launches()
    print(f"dataset ({card}): {time.perf_counter() - t_phase:.1f} s; launches "
          f"{launches}", flush=True)
    return launches


def _probe_launches():
    k1, _, _ = _wrappers()
    dot, gather, widen = _probe_wrappers()
    return {"micro_dot": dot.launch_count(),
            "micro_gather_taps": gather.launch_count("taps"),
            "micro_gather_rows": gather.launch_count("rows"),
            "micro_widen": widen.launch_count(),
            "sparse_conv_probe": k1.launch_count("probe")}


def _probe_line(name, rows, secs, launches):
    def case(r):
        if r["kernel"] is None:
            return f"{r['case']}: {r['op']} {r['library_ms']:.4f}"
        tag = f"[{r['route']}]" if r.get("route") else ""
        route = f" {tag}" if tag and tag not in r["case"] else ""
        text = (f"{r['case']}{route}: {r['ms']:.4f} (plain "
                f"{r['plain_ms']:.3f}")
        if r["library_ms"] is not None:
            text += (f", {r['op']} {r['library_ms']:.4f}, ratio "
                     f"{r['ms'] / r['library_ms']:.3f}")
        return text + ")"

    probes = ", ".join(sorted({r["probe"] for r in rows}))
    launched = ", ".join(f"{k} {n}" for k, n in launches.items() if n)
    return (f"probe {name} ({probes}, {len(rows)} cases, all "
            f"checks passed, {secs:.1f} s; launches: {launched}; kernel ms"
            f"): " + "; ".join(case(r) for r in rows))


def phase_probes(device):
    """Every probe module at its full size; returns the headline row and
    the largest error of each probe kernel, and the launches of the five
    probe kernels, counted from zero just before the first probe and read
    just after the last."""
    import importlib

    k1, _, _ = _wrappers()
    for k in (k1, *_probe_wrappers()):
        k.reset_launch_count()
    rows = []
    t_all = time.perf_counter()
    for name in PROBES:
        mod = importlib.import_module(f"focalformer3d_tpu_torch.tools.{name}")
        before = _probe_launches()
        t0 = time.perf_counter()
        got = mod.run(device, "full")
        torch.cuda.synchronize()
        bad = [r["case"] for r in got if not r["ok"]]
        if bad:
            raise RuntimeError(f"probe {name}: checks failed: {bad}")
        mine = {k: n - before[k] for k, n in _probe_launches().items()}
        print(_probe_line(name, got, time.perf_counter() - t0, mine),
              flush=True)
        rows += got
        torch.cuda.empty_cache()
    launches = _probe_launches()
    if not all(launches.values()):
        raise RuntimeError(f"probes: a kernel was not launched: {launches}")
    print(f"probes: {len(rows)} cases in {time.perf_counter() - t_all:.1f} "
          f"s; launches {launches}", flush=True)
    for r in rows:
        if r["kernel"] == "micro_widen":
            print(f"P9 {r['case']}: micro_widen {r['ms']:.4f} ms [route "
                  f"{r['route']}, tile {r['tile_rows']} rows], strided view "
                  f"copy {r['library_ms']:.4f} ms, ratio "
                  f"{r['ms'] / r['library_ms']:.3f}, "
                  f"{r['bound_ms'] / r['ms']:.3f} of its byte bound "
                  f"({r['bound_ms']:.4f} ms)", flush=True)
    out = {}
    for name in launches:
        mine = [r for r in rows if r["kernel"] == name]
        head = [r for r in mine if r["headline"]]
        if len(head) != 1:
            raise RuntimeError(f"probes: {len(head)} headline cases of {name}")
        h = head[0]
        out[name] = {
            "case": f"{h['probe']} {h['case']}",
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": h["ms"], "plain_ms": h["plain_ms"], "library_ms": h["library_ms"],
            "library": h["op"], "bound_ms": h["bound_ms"],
            "bound_by": h["bound_by"]}
    out["micro_gather_taps"]["w512"] = [
        {"case": r["case"], "ms": r["ms"], "route": r["route"]}
        for r in rows if r["kernel"] == "micro_gather_taps"
        and r["case"].startswith("W=512")]
    sweep = [r for r in rows
             if r["kernel"] == "micro_gather_rows" and r["op"] == "x[idx]"]
    worst = max(sweep, key=lambda r: r["ms"] / r["library_ms"])
    out["micro_gather_rows"]["worst_vs_x_idx"] = {
        "case": worst["case"], "ms": worst["ms"],
        "x_idx_ms": worst["library_ms"],
        "ratio": worst["ms"] / worst["library_ms"]}
    return out, launches


def main():
    device, card = phase_device()
    from focalformer3d_tpu_torch.configs import get_config, with_compute_dtype
    from focalformer3d_tpu_torch.models.detector import preprocess_points
    from focalformer3d_tpu_torch.models.sparse_encoder import conv_index

    torch.set_grad_enabled(False)
    cfg = get_config("FocalFormer3D_L")["model"]
    cfg = with_compute_dtype(dataclasses.replace(cfg, sparse_engine="cuda"),
                             "bfloat16")
    phase_build()

    vox = preprocess_points(cfg, *_scan(cfg, 0, device))
    phase_index_builds(cfg, vox)
    coord_geoms = _walk(cfg, vox, False, 2)
    mxu_geoms = _walk(cfg, vox, True, len(cfg.encoder_channels))
    coord_rules = [conv_index(src, dst, ks, st, pad, "cuda")
                   for _, src, dst, ks, st, pad in coord_geoms]
    mxu_rules, k2 = phase_k2(cfg, vox, mxu_geoms, device)
    k1 = phase_k1(cfg, coord_geoms, coord_rules, mxu_geoms, mxu_rules,
                  device)
    k3 = phase_k3(cfg, vox, device)
    del vox, coord_geoms, mxu_geoms, coord_rules, mxu_rules  # free the card

    model = _model(cfg, device)
    scans = [_scan(cfg, s, device) for s in SCAN_SEEDS]
    by_path = {engine: phase_slice(cfg, model, engine, scans)
               for engine in ENGINES}
    phase_engine_parity(cfg, model, device)
    del model, scans
    torch.cuda.empty_cache()

    # training: float32 (FocalFormer3D_L's compute dtype), engine cuda
    tcfg = dataclasses.replace(get_config("FocalFormer3D_L")["model"],
                               sparse_engine="cuda")
    batch = _train_batch(tcfg, device)
    grad = phase_k1_grad(tcfg, batch, device)
    train = phase_train(tcfg, batch, device)
    torch.cuda.empty_cache()
    entry = phase_entry_points(tcfg, batch, device, card)
    del batch
    torch.cuda.empty_cache()
    dataset = phase_dataset(card)
    torch.cuda.empty_cache()
    probes, probe_launches = phase_probes(device)
    jaxy = [m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "optax", "orbax", "focalformer3d_tpu")]
    if jaxy:
        raise RuntimeError(f"JAX or the JAX package was imported: {jaxy[:5]}")
    eval_paths = {f"eval_{e}": n for e, n in by_path.items()}
    rows = [  # (name, stats, launches by path)
        ("sparse_conv", {**k1, "train": grad["forward"]},
         {**{p: n[0] for p, n in eval_paths.items()},
          "train_cuda": train["forward"]}),
        ("sparse_conv_dx", grad["dx"], {"train_cuda": train["dx"]}),
        ("sparse_conv_wgrad", grad["wgrad"],
         {"train_cuda": train["wgrad"]}),
        ("plan_rules", k2, {p: n[1] for p, n in eval_paths.items()}),
        ("sparse_conv_zrun", k3, {p: n[2] for p, n in eval_paths.items()}),
    ]
    for name, _stats, by in rows:
        by["entry_points"] = entry[name]
        by["dataset"] = dataset[name]
    kernels = []
    for name, stats, by in rows:
        source, replaces = KERNELS[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by.values()),
            "launches_by_path": by, "library_ms": None, **stats})
    for name, stats in probes.items():
        source, replaces = KERNELS[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "also_replaces": ALSO_REPLACES[name],
            "launches": probe_launches[name],
            "launches_by_path": {"probes": probe_launches[name]}, **stats})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, drive.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit as ``nvidia-smi`` reports them.
2. build: compiles the sparse-conv kernel (K1) from
   ``focalformer3d_tpu_torch/csrc/`` with nvcc; prints the seconds.
3. kernel vs plain: on one radial 200k-point scan (the scan ``bench.py``
   builds), builds the rulebooks of the five sparse-conv geometries of the
   main path and runs K1 and its plain PyTorch version on the same bf16
   inputs: max |diff| / max |plain| <= 1e-3, median times by CUDA events.
4. slice: FocalFormer3D_L (full width, random weights from a seed, bf16
   compute) answers three radial scans (seeds 0-2) through
   ``preprocess_points`` -> model -> ``get_bboxes``: finite boxes and scores,
   200 kept boxes per scan, and exactly 11 K1 launches per scan.
5. engine parity: the encoder's BEV on the kernel engine against the plain
   engine for scan 0: max |diff| / max |plain| <= 1e-2.

Imports nothing of JAX and nothing of the JAX package
(``focalformer3d_tpu``): weights and scans come from the port's own numpy
generators. Prints the card line, one ``{"kernels": [...]}`` line, and as
its last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N_POINTS = 200_000
SCAN_SEEDS = (0, 1, 2)
KERNEL_TOL = 1e-3
ENGINE_TOL = 1e-2
REPS = 20
CONVS_PER_SCAN = 11
REPLACES = "focalformer3d_tpu/ops/sparse_conv_pallas.py:357"
SOURCE = "focalformer3d_tpu_torch/csrc/sparse_conv.cu"


def _scan(cfg, seed, device):
    from focalformer3d_tpu_torch.data import synthetic

    batch = synthetic.make_batch(
        np.random.RandomState(seed), batch_size=1, n_points=N_POINTS,
        n_boxes=24, max_gts=32, num_classes=cfg.decoder.num_classes,
        pc_range=cfg.voxel.point_cloud_range, mode="radial",
    )
    return (torch.from_numpy(batch["points"]).to(device),
            torch.from_numpy(batch["points_mask"]).to(device))


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
    return torch.device("cuda", 0)


def phase_build():
    from focalformer3d_tpu_torch.ops import sparse_conv_cuda as k1

    secs = k1.build_seconds()
    print(f"build: K1 compiled and loaded in {secs:.2f} s", flush=True)
    return secs


def _geometries(cfg, vox):
    """Rulebooks and shapes of the five sparse-conv geometries of the main
    path (eval: levels 0 and 1 sparse), for sample 0."""
    from focalformer3d_tpu_torch.ops import sparse_conv as sc

    ch = cfg.encoder_channels
    coords, valid = vox["coords"][0], vox["voxel_mask"][0]
    v0, v1 = coords.shape[0], cfg.capacities[1]
    shape = tuple(cfg.sparse_shape)
    table = sc.build_table_csr(coords, valid, shape)
    subm0 = sc.build_subm_rules(table, shape, 3)
    pad0 = cfg.down_paddings[0]
    oc1, ov1, shape1, _, meta1 = sc.build_downsample(
        coords, valid, shape, 3, 2, pad0, v1)
    down0 = sc.build_conv_rules(table, shape, oc1, ov1, 3, 2, pad0)
    table1 = sc.table_from_meta(oc1, ov1, meta1)
    subm1 = sc.build_subm_rules(table1, shape1, 3)
    pad1 = cfg.down_paddings[1]
    oc2, ov2 = sc.build_downsample(oc1, ov1, shape1, 3, 2, pad1,
                                   cfg.capacities[2])[:2]
    down1 = sc.build_conv_rules(table1, shape1, oc2, ov2, 3, 2, pad1)
    return [
        # name, rules, out_valid, V_in, C, Cout, launches per scan
        ("conv_input", subm0, valid, v0, cfg.point_dim, ch[0][0], 1),
        ("L0 subm", subm0, valid, v0, ch[0][0], ch[0][0], 4),
        ("down0", down0, ov1, v0, ch[0][0], ch[0][-1], 1),
        ("L1 subm", subm1, ov1, v1, ch[1][0], ch[1][0], 4),
        ("down1", down1, ov2, v1, ch[1][0], ch[1][-1], 1),
    ]


def phase_kernel_vs_plain(cfg, device):
    from focalformer3d_tpu_torch.models.detector import preprocess_points
    from focalformer3d_tpu_torch.ops import sparse_conv_cuda as k1

    pts, mask = _scan(cfg, 0, device)
    vox = preprocess_points(cfg, pts, mask)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    max_err = 0.0
    k1_scan_ms = plain_scan_ms = 0.0
    for name, rules, out_valid, v_in, c, cout, per_scan in _geometries(
            cfg, vox):
        feats = torch.randn(1, v_in, c, device=device, generator=gen)
        feats = feats.to(torch.bfloat16)
        w = (torch.randn(27, c, cout, device=device, generator=gen)
             * (2.0 / (27 * c)) ** 0.5).to(torch.bfloat16)
        bias = torch.randn(cout, device=device, generator=gen)
        args = (feats, rules[None], w, out_valid[None], bias)
        got = k1.sparse_conv(*args)
        ref = k1.apply_conv_plain(feats.float(), rules[None], w.float(),
                                  out_valid[None], bias, torch.float32)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        if not rel <= KERNEL_TOL:
            raise RuntimeError(f"K1 {name}: rel err {rel:.3g} > {KERNEL_TOL}")
        ms = _median_ms(lambda: k1.sparse_conv(*args))
        plain_ms = _median_ms(lambda: k1.apply_conv_plain(
            feats.float(), rules[None], w.float(), out_valid[None], bias,
            torch.float32))
        n_out = int(out_valid.sum())
        print(f"K1 {name}: C {c} -> {cout}, V_in {v_in}, V_out "
              f"{rules.shape[1]} ({n_out} active), max|diff| {err:.3g}, "
              f"rel {rel:.3g}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms",
              flush=True)
        max_err = max(max_err, err)
        k1_scan_ms += per_scan * ms
        plain_scan_ms += per_scan * plain_ms
    print(f"K1 per scan (11 convs at these shapes): kernel {k1_scan_ms:.3f} "
          f"ms, plain {plain_scan_ms:.3f} ms", flush=True)
    return {"name": "sparse_conv", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES, "max_abs_err": max_err,
            "ms": k1_scan_ms, "plain_ms": plain_scan_ms}


def _model(cfg, device):
    from focalformer3d_tpu_torch.models.detector import FocalFormer3D
    from focalformer3d_tpu_torch.utils.ref_keys import make_fake_state_dict

    model = FocalFormer3D(cfg).eval()
    model.load_state_dict(make_fake_state_dict(model, seed=0), strict=True)
    return model.to(device)


def phase_slice(cfg, model, device):
    from focalformer3d_tpu_torch.models.detector import preprocess_points
    from focalformer3d_tpu_torch.ops import sparse_conv_cuda as k1

    scans = [_scan(cfg, s, device) for s in SCAN_SEEDS]
    enc_events = []

    def mark(*_):  # CUDA event at the encoder's entry and exit
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        enc_events.append(ev)

    enc = model.pts_middle_encoder
    hooks = [enc.register_forward_pre_hook(mark),
             enc.register_forward_hook(mark)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    wall, split = [], []
    k1.reset_launch_count()
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
                    raise RuntimeError(f"non-finite {k}")
            kept = int(dec["mask"].sum())
            if dec["bboxes"].shape[-1] != 9 or kept != 200:
                raise RuntimeError(f"expected 200 kept 9-dim boxes, got "
                                   f"{kept} of {tuple(dec['bboxes'].shape)}")
    finally:
        for h in hooks:
            h.remove()
    launches = k1.launch_count()
    if launches != CONVS_PER_SCAN * len(scans):
        raise RuntimeError(f"K1 launched {launches} times for {len(scans)} "
                           f"scans, expected {CONVS_PER_SCAN} per scan")
    peak = torch.cuda.max_memory_allocated(device)
    med = statistics.median(wall)
    print("slice: ms/scan " + ", ".join(f"{t:.1f}" for t in wall)
          + f" (median {med:.1f}); voxelize/encoder/rest ms "
          + "; ".join("/".join(f"{x:.1f}" for x in s) for s in split)
          + f"; peak memory {peak / 2**30:.2f} GiB; K1 launches {launches}",
          flush=True)
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
        dense_from=cfg.sparse_dense_from_eval,
    ).to(device).eval()
    plain.load_state_dict(enc.state_dict(), strict=True)
    args = (vox["features"], vox["coords"], vox["voxel_mask"])
    got, ref = enc(*args), plain(*args)
    torch.cuda.synchronize()
    rel = float((got - ref).abs().max() / ref.abs().max())
    if not rel <= ENGINE_TOL:
        raise RuntimeError(f"BEV kernel vs plain engine rel {rel:.3g}")
    print(f"engine parity: BEV {tuple(got.shape)} kernel vs plain engine "
          f"max rel diff {rel:.3g} (limit {ENGINE_TOL})", flush=True)


def main():
    device = phase_device()
    from focalformer3d_tpu_torch.configs import get_config, with_compute_dtype

    torch.set_grad_enabled(False)
    cfg = get_config("FocalFormer3D_L")["model"]
    cfg = with_compute_dtype(dataclasses.replace(cfg, sparse_engine="cuda"),
                             "bfloat16")
    phase_build()
    kernel = phase_kernel_vs_plain(cfg, device)
    model = _model(cfg, device)
    launches = phase_slice(cfg, model, device)
    phase_engine_parity(cfg, model, device)
    jaxy = [m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "focalformer3d_tpu")]
    if jaxy:
        raise RuntimeError(f"JAX or the JAX package was imported: {jaxy[:5]}")
    kernel["launches"] = launches
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

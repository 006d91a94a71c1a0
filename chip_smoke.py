"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, drive.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit as ``nvidia-smi`` reports them.
2. build: compiles the three kernels from ``focalformer3d_tpu_torch/csrc/``
   with one nvcc each, all started together (K1 sparse-conv apply, K2
   rulebook builder, K3 z-run sparse-conv apply); prints the seconds of each.
3. kernels vs plain, on one radial 200k-point scan (the scan ``bench.py``
   builds), at the shapes the encoder engines give them:
   - index builds: the torch-op build of engine ``cuda``, the meta chain of
     ``cuda_mxu`` (K2 + ``downsample_meta`` + ``colz_from_meta``) and the
     z-run plans of ``cuda_zrun``, timed on the same scan;
   - K2: the 8 rulebooks of the ``cuda_mxu`` path equal ``decode_rules``
     (its plain version) and ``build_conv_rules`` exactly;
   - K1: the 5 conv geometries of ``cuda`` and the 4 more of ``cuda_mxu``
     (L2, L3, conv_out), same bf16 inputs as the plain gather + matmul:
     max |diff| / max |plain| <= 1e-3;
   - K3: the 5 conv geometries of ``cuda_zrun`` against its plain version,
     <= 1e-3.
   Each with median times by CUDA events.
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
ENGINES = ("cuda", "cuda_mxu", "cuda_zrun")
# (K1, K2, K3) launches per scan on each engine
LAUNCHES_PER_SCAN = {"cuda": (11, 0, 0), "cuda_mxu": (21, 8, 0),
                     "cuda_zrun": (0, 0, 11)}
CSRC = "focalformer3d_tpu_torch/csrc/"
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "sparse_conv": (CSRC + "sparse_conv.cu",
                    "focalformer3d_tpu/ops/sparse_conv_pallas.py:357"),
    "plan_rules": (CSRC + "plan_builder.cu",
                   "focalformer3d_tpu/ops/plan_builder.py:129"),
    "sparse_conv_zrun": (CSRC + "sparse_conv_zrun.cu",
                         "focalformer3d_tpu/ops/sparse_conv_zrun.py:312"),
}


def _wrappers():
    from focalformer3d_tpu_torch.ops import plan_builder_cuda as k2
    from focalformer3d_tpu_torch.ops import sparse_conv_cuda as k1
    from focalformer3d_tpu_torch.ops import sparse_conv_zrun_cuda as k3

    return k1, k2, k3


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
    from focalformer3d_tpu_torch.ops import cuda_build

    k1, k2, k3 = _wrappers()
    t0 = time.perf_counter()
    secs = cuda_build.build(k1.SOURCE, k2.SOURCE, k3.SOURCE)
    for k in (k1, k2, k3):
        k._load()
    print("build: " + ", ".join(f"{stem} {s:.2f} s" for stem, s in
                                secs.items())
          + f" (in parallel; all loaded after "
          f"{time.perf_counter() - t0:.2f} s)", flush=True)
    return secs


def _walk(cfg, vox, meta_chain, n_levels):
    """The encoder's index chain on sample 0 of a scan, levels 0 ..
    n_levels - 1: [(name, src level, dst level, kernel, stride, padding)],
    subm then down per level, conv_out after the last stage."""
    from focalformer3d_tpu_torch.models.sparse_encoder import Level

    lvl = Level.from_voxels(vox["coords"][:1], vox["voxel_mask"][:1],
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
        ms = _median_ms(lambda: _index_build(cfg, vox, engine, n), reps=10)
        print(f"index build {label}: {ms:.3f} ms", flush=True)


def _rand_conv(gen, device, v_in, c, k, cout):
    feats = torch.randn(1, v_in, c, device=device, generator=gen)
    w = (torch.randn(k, c, cout, device=device, generator=gen)
         * (2.0 / (k * c)) ** 0.5)
    bias = torch.randn(cout, device=device, generator=gen)
    return feats.to(torch.bfloat16), w.to(torch.bfloat16), bias


def phase_k2(cfg, vox, mxu_geoms):
    from focalformer3d_tpu_torch.ops import plan_builder as tpb
    from focalformer3d_tpu_torch.ops import sparse_conv as sc

    _, k2, _ = _wrappers()
    k2_ms = plain_ms = torch_ms = 0.0
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
        ms = _median_ms(lambda: k2.plan_rules(*args))
        p_ms, t_ms = _median_ms(plain), _median_ms(torch_op)
        print(f"K2 {name}: K {got.shape[1]}, V_in {src.capacity}, V_out "
              f"{dst.capacity} ({int(dst.valid.sum())} active), equal to "
              f"decode_rules and build_conv_rules; kernel {ms:.4f} ms, "
              f"decode_rules {p_ms:.4f} ms, build_conv_rules {t_ms:.4f} ms",
              flush=True)
        k2_ms, plain_ms, torch_ms = (k2_ms + ms, plain_ms + p_ms,
                                     torch_ms + t_ms)
        rules_by_geom.append(got)
    print(f"K2 per scan (8 rulebooks): kernel {k2_ms:.3f} ms, decode_rules "
          f"{plain_ms:.3f} ms, build_conv_rules {torch_ms:.3f} ms",
          flush=True)
    return rules_by_geom, {"max_abs_err": 0, "ms": k2_ms,
                           "plain_ms": plain_ms, "torch_op_ms": torch_ms}


def _conv_vs_plain(tag, name, run, plain):
    got = run()
    ref = plain()
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    rel = err / float(ref.abs().max())
    if not rel <= KERNEL_TOL:
        raise RuntimeError(f"{tag} {name}: rel err {rel:.3g} > {KERNEL_TOL}")
    return err, rel, _median_ms(run), _median_ms(plain)


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
    for (name, g, c, cout, n), geoms, rules_by_geom in jobs:
        _, src, dst, *_rest = geoms[g]
        rules = rules_by_geom[g]
        feats, w, bias = _rand_conv(gen, device, src.capacity, c,
                                    rules.shape[1], cout)
        args = (feats, rules, w, dst.valid, bias)
        err, rel, ms, p_ms = _conv_vs_plain(
            "K1", name, lambda: k1.sparse_conv(*args),
            lambda: k1.apply_conv_plain(feats.float(), rules, w.float(),
                                        dst.valid, bias, torch.float32))
        print(f"K1 {name}: C {c} -> {cout}, K {rules.shape[1]}, V_in "
              f"{src.capacity} -> V_out {dst.capacity} "
              f"({int(dst.valid.sum())} active), max|diff| {err:.3g}, rel "
              f"{rel:.3g}, kernel {ms:.4f} ms, plain {p_ms:.4f} ms",
              flush=True)
        max_err = max(max_err, err)
        per_scan[name] = (n, ms, p_ms)

    def total(names):
        return (sum(per_scan[x][0] * per_scan[x][1] for x in names),
                sum(per_scan[x][0] * per_scan[x][2] for x in names))

    cuda_names = [c[0] for c in _convs(cfg, coord_geoms)]
    ms, plain_ms = total(cuda_names)
    mxu_ms, mxu_plain = total(list(per_scan))
    print(f"K1 per scan: cuda (11 convs) kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms; cuda_mxu (21 convs) kernel {mxu_ms:.3f} ms, "
          f"plain {mxu_plain:.3f} ms", flush=True)
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "ms_cuda_mxu": mxu_ms, "plain_ms_cuda_mxu": mxu_plain}


def phase_k3(cfg, vox, device):
    from focalformer3d_tpu_torch.models.sparse_encoder import conv_index
    from focalformer3d_tpu_torch.ops.sparse_conv_zrun import (
        apply_conv_zrun_plain)

    _, _, k3 = _wrappers()
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    geoms = _walk(cfg, vox, False, 2)
    codes = [conv_index(src, dst, ks, st, pad, "cuda_zrun")
             for _, src, dst, ks, st, pad in geoms]
    max_err = k3_ms = plain_ms = 0.0
    for name, g, c, cout, n in _convs(cfg, geoms):
        _, src, dst, *_rest = geoms[g]
        feats, w, bias = _rand_conv(gen, device, src.capacity, c,
                                    3 * codes[g].shape[1], cout)
        args = (feats, codes[g], w, dst.valid, bias)
        err, rel, ms, p_ms = _conv_vs_plain(
            "K3", name, lambda: k3.zrun_conv(*args),
            lambda: apply_conv_zrun_plain(feats.float(), codes[g], w.float(),
                                          dst.valid, bias, torch.float32))
        print(f"K3 {name}: C {c} -> {cout}, {codes[g].shape[1]} BEV taps, "
              f"V_in {src.capacity} -> V_out {dst.capacity}, max|diff| "
              f"{err:.3g}, rel {rel:.3g}, kernel {ms:.4f} ms, plain "
              f"{p_ms:.4f} ms", flush=True)
        max_err = max(max_err, err)
        k3_ms, plain_ms = k3_ms + n * ms, plain_ms + n * p_ms
    print(f"K3 per scan (11 convs): kernel {k3_ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms", flush=True)
    return {"max_abs_err": max_err, "ms": k3_ms, "plain_ms": plain_ms}


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


def main():
    device = phase_device()
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
    mxu_rules, k2 = phase_k2(cfg, vox, mxu_geoms)
    k1 = phase_k1(cfg, coord_geoms, coord_rules, mxu_geoms, mxu_rules,
                  device)
    k3 = phase_k3(cfg, vox, device)
    del vox, coord_geoms, mxu_geoms, coord_rules, mxu_rules  # free the card

    model = _model(cfg, device)
    scans = [_scan(cfg, s, device) for s in SCAN_SEEDS]
    by_path = {engine: phase_slice(cfg, model, engine, scans)
               for engine in ENGINES}
    phase_engine_parity(cfg, model, device)
    jaxy = [m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "focalformer3d_tpu")]
    if jaxy:
        raise RuntimeError(f"JAX or the JAX package was imported: {jaxy[:5]}")
    kernels = []
    for i, (name, stats) in enumerate(zip(KERNELS, (k1, k2, k3))):
        source, replaces = KERNELS[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(n[i] for n in by_path.values()),
            "launches_by_path": {e: n[i] for e, n in by_path.items()},
            **stats})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

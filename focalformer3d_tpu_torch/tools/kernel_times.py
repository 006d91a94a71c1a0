"""K3's and dW's times, or kernel B's or C's, or the index build's, on one
card, for one checkout of the repo.

    python -m focalformer3d_tpu_torch.tools.kernel_times --root DIR [--tag T]
        [--kernels k3_dw|gather|widen|index]

Imports ``focalformer3d_tpu_torch`` from the checkout at ``DIR`` (the repo
itself, or an older commit unpacked beside it), so two versions of the
kernels are timed by the same clock, at the same shapes and on the same
inputs, which this module builds with the checkout's package: K3 at the
five conv geometries of engine ``cuda_zrun`` on the radial 200k-point scan
(seed 0), through ``zrun_conv`` with bias; dW at every conv of the
training batch (two radial scans, seed 10, engine ``cuda``) through
``conv_wgrad``. Every time is ``tools/_common.time_ms`` of this checkout
(10 calls replayed from a CUDA graph: the device's time per call). Prints
the card's name and power limit, one line per geometry and one JSON object
with the per-scan and per-step sums. ``tests/test_torch_cuda.py`` holds
the kernels at every conv of the same scans with the same input builders
(``radial_scan``, ``walk``, ``convs``, ``rand_conv``, ``train_batch``).

``--kernels gather`` times kernel B instead (``ops/micro_gather.py`` of the
checkout) at every case of the probes P6 and P7, on the inputs their
``run`` builds (the checkout's ``micro_gather_kernel.operands`` and
``micro_gather2`` tables, made in the same order from the same seeds):
``gather_taps`` at each (W, cl, pack) and div beside
``embedding_bag(mode="sum")`` where div is 1 (and, for a cost model, at W
256 with 1, 9 and 27 taps over 512-2048 tiles), ``gather_rows`` at each row
width of the sweep beside ``x[idx]`` and ``torch.index_select``, and on the
4 MiB table; beside each width, ``zero_`` and a contiguous ``copy_`` of a
tensor of the output's size, the card's streaming rates for those bytes.
Each kernel on every route the checkout's wrapper offers
(``route=``), each result held against the default route's (equal bit for
bit), and each also timed eagerly (CUDA events around 10 calls issued from
the host, after one warm-up call), beside the graph replay.

``--kernels index`` times engine ``cuda``'s index build
(``ops/plan_builder_cuda``: ``index_table``, ``index_downsample`` and K2's
rulebooks through ``conv_index``, the output sites' packing included)
beside the torch functions that engine ``plain`` runs and the engine ran
before it (``build_table_csr``, ``build_downsample``, ``build_conv_rules``
per sample), each result held against the torch one bit for bit, at each
block of an eval scan of FocalFormer3D_L (a radial 200k-point scan, the
grid and capacities of ``L.stream``) and FocalFormer3D_Waymo_L (180k
points on its 1536 x 1536 grid, the config's capacities), and the whole
build (``SparseEncoder._index_build``) at batch 1 and, for
FocalFormer3D_L, at batch 4 (four scans, ``L.offline``'s batch), graph
replay and eager. Beside each kernel row its byte bound (inputs read once,
outputs written once, at the HBM rate). Needs a checkout that has the
index kernels.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import inspect
import json
import sys
from pathlib import Path

import numpy as np
import torch

N_POINTS = 200_000  # a radial scan, the benchmark's L.stream size
TRAIN_SEED = 10
TRAIN_BATCH = 2


def _import(root: Path) -> None:
    """Drop this checkout's package from ``sys.modules`` and import the
    one at ``root`` in its place."""
    sys.path.insert(0, str(root))
    for name in [m for m in sys.modules
                 if m.startswith("focalformer3d_tpu_torch")]:
        del sys.modules[name]
    pkg = importlib.import_module("focalformer3d_tpu_torch")
    if not Path(pkg.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"focalformer3d_tpu_torch came from "
                           f"{pkg.__file__}, not {root}")


def radial_scan(cfg, seed: int, device, n_points: int = N_POINTS):
    """(points, points_mask) of one radial scan of ``cfg``'s range."""
    from focalformer3d_tpu_torch.data import synthetic

    batch = synthetic.make_batch(
        np.random.RandomState(seed), batch_size=1, n_points=n_points,
        n_boxes=24, max_gts=32, num_classes=cfg.decoder.num_classes,
        pc_range=cfg.voxel.point_cloud_range, mode="radial")
    return (torch.from_numpy(batch["points"]).to(device),
            torch.from_numpy(batch["points_mask"]).to(device))


def train_batch(cfg, device, n_points: int = N_POINTS) -> dict:
    """The training batch: two radial scans with their GT boxes."""
    from focalformer3d_tpu_torch.data import synthetic

    batch = synthetic.make_batch(
        np.random.RandomState(TRAIN_SEED), batch_size=TRAIN_BATCH,
        n_points=n_points, n_boxes=24, max_gts=32,
        num_classes=cfg.decoder.num_classes,
        pc_range=cfg.voxel.point_cloud_range, mode="radial")
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def walk(cfg, vox, meta_chain: bool, n_levels: int, batch: int = 1):
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


def convs(cfg, geoms):
    """[(name, geometry index, C, Cout, convs per scan)] of a chain."""
    ch, n_stage = cfg.encoder_channels, len(cfg.encoder_channels)
    out = []
    for g, (name, *_rest) in enumerate(geoms):
        if name.endswith("subm"):
            i = int(name[1])
            n_basic = len(ch[i]) - (i < n_stage - 1)
            if i == 0:
                out.append(("conv_input", g, cfg.voxel_feature_dim,
                            ch[0][0], 1))
            out.append((name, g, ch[i][0], ch[i][0], 2 * n_basic))
        elif name == "conv_out":
            out.append((name, g, ch[-1][-1], cfg.sparse_out_channels, 1))
        else:
            i = int(name[4])
            out.append((name, g, ch[i][-2], ch[i][-1], 1))
    return out


def rand_conv(gen, device, v_in: int, c: int, k: int, cout: int):
    """bf16 features and weights (He-scaled) and an f32 bias."""
    feats = torch.randn(1, v_in, c, device=device, generator=gen)
    w = (torch.randn(k, c, cout, device=device, generator=gen)
         * (2.0 / (k * c)) ** 0.5)
    bias = torch.randn(cout, device=device, generator=gen)
    return feats.to(torch.bfloat16), w.to(torch.bfloat16), bias


def k3_times(device):
    from focalformer3d_tpu_torch.configs import get_config, with_compute_dtype
    from focalformer3d_tpu_torch.models.detector import preprocess_points
    from focalformer3d_tpu_torch.models.sparse_encoder import conv_index
    from focalformer3d_tpu_torch.ops import sparse_conv_zrun_cuda as k3
    from focalformer3d_tpu_torch.tools import _common

    cfg = get_config("FocalFormer3D_L")["model"]
    cfg = with_compute_dtype(dataclasses.replace(cfg, sparse_engine="cuda"),
                             "bfloat16")
    vox = preprocess_points(cfg, *radial_scan(cfg, 0, device))
    geoms = walk(cfg, vox, False, 2)
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    rows, total = {}, 0.0
    for name, g, c, cout, n in convs(cfg, geoms):
        _, src, dst, ks, st, pad = geoms[g]
        codes = conv_index(src, dst, ks, st, pad, "cuda_zrun")
        feats, w, bias = rand_conv(gen, device, src.capacity, c,
                                   3 * codes.shape[1], cout)
        ms = _common.time_ms(device, lambda: k3.zrun_conv(
            feats, codes, w, dst.valid, bias))[0]
        rows[name] = ms
        total += n * ms
        print(f"K3 {name}: C {c} -> {cout}, x{n}: {ms:.4f} ms", flush=True)
    return rows, total


def wgrad_times(device):
    from focalformer3d_tpu_torch.configs import get_config
    from focalformer3d_tpu_torch.models.detector import preprocess_points
    from focalformer3d_tpu_torch.models.sparse_encoder import conv_index
    from focalformer3d_tpu_torch.ops import sparse_conv_cuda as k1
    from focalformer3d_tpu_torch.tools import _common

    cfg = dataclasses.replace(get_config("FocalFormer3D_L")["model"],
                              sparse_engine="cuda")
    batch = train_batch(cfg, device)
    vox = preprocess_points(cfg, batch["points"], batch["points_mask"],
                            train=True)
    B = vox["coords"].shape[0]
    geoms = walk(cfg, vox, False, cfg.sparse_dense_from, batch=B)
    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    rows, total = {}, 0.0
    for name, g, c, cout, n in convs(cfg, geoms):
        _, src, dst, ks, st, pad = geoms[g]
        rules = conv_index(src, dst, ks, st, pad, "cuda")
        x = torch.where(src.valid[..., None], torch.randn(
            B, src.capacity, c, device=device, generator=gen), 0.0)
        cot = torch.where(dst.valid[..., None], torch.randn(
            B, dst.capacity, cout, device=device, generator=gen), 0.0)
        xb = x.to(torch.bfloat16)
        ms = _common.time_ms(device, lambda: k1.conv_wgrad(xb, cot, rules))[0]
        rows[name] = ms
        total += n * ms
        print(f"dW {name}: C {c} -> {cout}, K {rules.shape[1]}, x{n}: "
              f"{ms:.4f} ms", flush=True)
    return rows, total


def eager_ms(fn, reps: int = 10) -> float:
    """ms per call of ``reps`` calls issued from the host one after
    another, by CUDA events, after one warm-up call: the host's pace where
    it is slower than the device."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _routes(fn, names_attr: str, mg) -> list:
    """[None] and, where the checkout's wrapper takes ``route=``, each
    route it names."""
    if "route" not in inspect.signature(fn).parameters:
        return [None]
    return [None, *getattr(mg, names_attr)]


def _timed(device, _common, name, fn, ref=None, library=None) -> dict:
    """Graph-replay and eager ms of ``fn`` (and of ``library``), its result
    held bit for bit against ``ref`` where one is given."""
    ms, got = _common.time_ms(device, fn)
    row = {"case": name, "ms": ms, "eager_ms": eager_ms(fn)}
    if ref is not None:
        row["equal"] = bool(torch.equal(got, ref))
    if library is not None:
        row["library_ms"] = _common.time_ms(device, library)[0]
        row["library_eager_ms"] = eager_ms(library)
    return row


def _line(row: dict) -> str:
    text = f"{row['case']}: {row['ms']:.4f} ms (eager {row['eager_ms']:.4f})"
    if "library_ms" in row:
        text += (f"; {row['op']} {row['library_ms']:.4f} (eager "
                 f"{row['library_eager_ms']:.4f}), ratio "
                 f"{row['ms'] / row['library_ms']:.3f}")
    if "equal" in row:
        text += f"; equal bit for bit: {row['equal']}"
    return text


def gather_times(device) -> dict:
    from focalformer3d_tpu_torch.ops import micro_gather as mg
    from focalformer3d_tpu_torch.tools import _common
    from focalformer3d_tpu_torch.tools import micro_gather2 as p7
    from focalformer3d_tpu_torch.tools import micro_gather_kernel as p6

    out = {"taps": [], "rows": []}
    taps_routes = _routes(mg.gather_taps, "TAPS_ROUTE_NAMES", mg)
    for seed, (W, cl, pack) in enumerate(p6.CONFIGS):
        rel, xw = p6.operands(seed, p6.N_TILES, p6.T, p6.K, W, cl, pack)
        rel = torch.from_numpy(rel).to(device)
        xw = torch.from_numpy(xw).to(device).to(torch.bfloat16)
        flat = rel.view(-1, p6.K)
        for div in ((pack, 1) if pack > 1 else (1,)):
            default = mg.gather_taps(rel, xw, div)
            for route in taps_routes:
                kw = {} if route is None else {"route": route}
                try:
                    plan = (mg.taps_plan(xw.shape[0], cl, p6.K, route)["name"]
                            if hasattr(mg, "taps_plan") else "one")
                except ValueError:  # the window does not fit that route
                    continue
                row = _timed(
                    device, _common,
                    f"P6 W={W} pack={pack} div={div} route={plan}"
                    + (" (default)" if route is None else ""),
                    lambda kw=kw, div=div: mg.gather_taps(rel, xw, div, **kw),
                    ref=None if route is None else default,
                    library=(lambda: torch.nn.functional.embedding_bag(
                        flat, xw, mode="sum")) if div == 1 else None)
                row["op"] = "embedding_bag"
                out["taps"].append(row)
                print(_line(row), flush=True)
        del rel, xw, flat
    # what a launch costs apart from its taps: W 256, pack 1, at 1, 9 and
    # 27 taps and 512-2048 tiles, on the same draws cut or repeated
    rel, xw = p6.operands(0, 2048, p6.T, p6.K, 256, 128, 1)
    rel = torch.from_numpy(rel).to(device)
    xw = torch.from_numpy(xw).to(device).to(torch.bfloat16)
    for k in (1, 9, 27):
        for n_tiles in (512, 1024, 2048):
            part = rel[:n_tiles, :, :k].contiguous()
            row = _timed(device, _common,
                         f"P6 scaling W=256 div=1 K={k} tiles={n_tiles}",
                         lambda part=part: mg.gather_taps(part, xw, 1))
            out["taps"].append(row)
            print(_line(row), flush=True)
    del rel, xw

    rows_routes = _routes(mg.gather_rows, "ROWS_ROUTE_NAMES", mg)

    def rows_cases(name, x, idx, library, op):
        ref = x[idx]
        for route in rows_routes:
            kw = {} if route is None else {"route": route}
            plan = (mg.rows_plan(x.shape[1], route)["name"]
                    if hasattr(mg, "rows_plan") else "one")
            row = _timed(device, _common,
                         f"{name} route={plan}"
                         + (" (default)" if route is None else ""),
                         lambda kw=kw: mg.gather_rows(x, idx, **kw), ref=ref,
                         library=library)
            row["op"] = op
            out["rows"].append(row)
            print(_line(row), flush=True)

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    n = p7.SWEEP["rows"]
    for width in p7.WIDTHS:
        v = max(1, p7.SWEEP["table_elems"] // width)
        x = torch.randn(v, width, generator=gen, device=device).to(
            torch.bfloat16)
        idx = torch.randint(0, v, (n,), generator=gen, device=device,
                            dtype=torch.int32)
        rows_cases(f"P7 {width * 2} B rows, table {v} x {width}", x, idx,
                   lambda x=x, idx=idx: x[idx], "x[idx]")
        row = _timed(device, _common, f"P7 {width * 2} B rows index_select",
                     lambda x=x, idx=idx: torch.index_select(x, 0, idx))
        out["rows"].append(row)
        print(_line(row), flush=True)
        del x, idx
        # the card's streaming rates for the output's bytes: writes alone,
        # and a contiguous copy (as many bytes read as written)
        dst = torch.empty(n, width, dtype=torch.bfloat16, device=device)
        src = torch.empty_like(dst).zero_()
        for name, fn in (("zero_ (writes alone)", dst.zero_),
                         ("copy_ (contiguous)", lambda: dst.copy_(src))):
            row = _timed(device, _common, f"P7 {width * 2} B rows, output "
                         f"{name}", fn)
            row["GB_per_s"] = n * width * 2 / (row["ms"] * 1e-3) / 1e9
            out["rows"].append(row)
            print(_line(row) + f", {row['GB_per_s']:.0f} GB/s of output",
                  flush=True)
        del dst, src
        torch.cuda.empty_cache()
    vm = p7.VMEM
    x, idx = p7.table_rows(3, vm["V"], vm["C"], vm["N"])
    x = torch.from_numpy(x).to(device).to(torch.bfloat16)
    idx = torch.from_numpy(idx).to(device)
    rows_cases(f"P7 table {vm['V']} x {vm['C']}, {vm['N']} rows", x, idx,
               lambda: torch.index_select(x, 0, idx), "index_select")
    row = _timed(device, _common, "P7 4 MiB table x[idx]", lambda: x[idx])
    out["rows"].append(row)
    print(_line(row), flush=True)
    return out


def widen_times(device) -> list:
    from focalformer3d_tpu_torch.ops import micro_widen as mw
    from focalformer3d_tpu_torch.tools import _common
    from focalformer3d_tpu_torch.tools import micro_meta9 as p9

    out = []

    def add(row, nbytes, level, bound_ms=None):
        row["level"] = level
        row["GB_per_s"] = nbytes / (row["ms"] * 1e-3) / 1e9
        text = _line(row) + f", {row['GB_per_s']:.0f} GB/s"
        if bound_ms is not None:
            row["share_of_bound"] = bound_ms / row["ms"]
            text += f", {row['share_of_bound']:.3f} of the byte bound"
        out.append(row)
        print(text, flush=True)

    for seed, (W, level) in enumerate(p9.GRIDS):
        meta = torch.from_numpy(p9.meta_for(seed, W)).to(device)
        n_rows = meta.shape[0] + W
        nbytes = meta.numel() * 4 + n_rows * 36 * 4
        bound_ms = _common.bound(nbytes)["bound_ms"]
        ref = mw.widen_meta9_plain(meta, W)
        for route in _routes(mw.widen_meta9, "ROUTE_NAMES", mw):
            kw = {} if route is None else {"route": route}
            plan = (mw.widen_plan(meta.shape[0], W, route)
                    if hasattr(mw, "widen_plan") else None)
            name = ("one" if plan is None else
                    f"{plan['name']} tile {plan['tile_rows']}")
            row = _timed(device, _common,
                         f"P9 {level} W={W} route={name}"
                         + (" (default)" if route is None else ""),
                         lambda kw=kw: mw.widen_meta9(meta, W, **kw), ref=ref)
            add(row, nbytes, level, bound_ms)
        mp = mw.padded_meta(meta, W)
        parts = mw.nine_slices(mp, W, n_rows)
        for name, fn in (
                ("strided view copy",
                 lambda: p9.strided_widen(mp, W, n_rows)),
                ("torch.cat of the nine slices",
                 lambda: torch.cat(parts, dim=1))):
            add(_timed(device, _common, f"P9 {level} W={W} {name}", fn,
                       ref=ref), nbytes, level, bound_ms)
        del mp, parts
        dst = torch.empty_like(ref)
        src = torch.zeros_like(ref)
        for name, fn in (("zero_ (writes alone)", dst.zero_),
                         ("copy_ (contiguous)", lambda: dst.copy_(src))):
            add(_timed(device, _common, f"P9 {level} output {name}", fn),
                ref.numel() * 4, level)
        del dst, src, ref, meta
        torch.cuda.empty_cache()
    bad = [r["case"] for r in out if r.get("equal") is False]
    if bad:
        raise SystemExit(f"not equal to widen_meta9_plain: {bad}")
    return out


def _index_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def index_times(device) -> list:
    from focalformer3d_tpu_torch.configs import get_config
    from focalformer3d_tpu_torch.models.detector import preprocess_points
    from focalformer3d_tpu_torch.models.sparse_encoder import (Level,
                                                               SparseEncoder,
                                                               conv_index)
    from focalformer3d_tpu_torch.ops import plan_builder_cuda as pbc
    from focalformer3d_tpu_torch.tools import _common

    out = []

    def flat(res) -> torch.Tensor:
        """Every tensor a result holds, as one int32 vector."""
        tensors = [t.reshape(-1).to(torch.int32)
                   for t in torch.utils._pytree.tree_leaves(res)
                   if isinstance(t, torch.Tensor)]
        return torch.cat(tensors)

    def add(name, kernel, plain, nbytes=None):
        row = _timed(device, _common, name, kernel)
        row["equal"] = bool(torch.equal(flat(kernel()), flat(plain())))
        row["plain_ms"] = _common.time_ms(device, plain)[0]
        text = _line(row) + f"; torch ops {row['plain_ms']:.4f}"
        if nbytes is not None:
            row.update(_common.bound(nbytes))
            text += (f", bound {row['bound_ms']:.4f} (bytes), "
                     f"{row['bound_ms'] / row['ms']:.3f} of it")
        out.append(row)
        print(text, flush=True)

    for name, n_points in (("FocalFormer3D_L", N_POINTS),
                           ("FocalFormer3D_Waymo_L", 180_000)):
        cfg = get_config(name)["model"]
        shape = tuple(cfg.sparse_shape)
        vox = preprocess_points(cfg, *radial_scan(cfg, 0, device, n_points))
        coords, valid = vox["coords"], vox["voxel_mask"]
        add(f"{name} table", lambda: pbc.index_table(coords, valid, shape),
            lambda: pbc.index_table_plain(coords, valid, shape),
            _index_bytes(coords, valid) + (shape[1] * shape[2] + 1) * 16)
        src = Level.from_voxels(coords, valid, shape, False)
        for i in range(cfg.sparse_dense_from_eval):
            pad = cfg.down_paddings[i]
            cap = cfg.capacities[i + 1]
            dst = src.downsample(3, 2, pad, cap)
            res = pbc.index_downsample(src.coords, src.valid, src.shape, 3,
                                       2, pad, cap)
            add(f"{name} downsample L{i} -> L{i + 1}",
                lambda src=src, pad=pad, cap=cap: pbc.index_downsample(
                    src.coords, src.valid, src.shape, 3, 2, pad, cap),
                lambda src=src, pad=pad, cap=cap: pbc.index_downsample_plain(
                    src.coords, src.valid, src.shape, 3, 2, pad, cap),
                _index_bytes(src.coords, src.valid, *res[:2], *res[3:]))
            for conv, d, ks, st, p in ((f"L{i} subm", src, 3, 1, 1),
                                       (f"down{i}", dst, 3, 2, pad)):
                rules = conv_index(src, d, ks, st, p, "cuda")
                add(f"{name} rules {conv} (K2 + packing)",
                    lambda d=d, ks=ks, st=st, p=p, src=src: conv_index(
                        src, d, ks, st, p, "cuda"),
                    lambda d=d, ks=ks, st=st, p=p, src=src: conv_index(
                        src, d, ks, st, p, "plain"),
                    _index_bytes(src.meta, d.valid, rules)
                    + d.valid.numel() * 4)
            src = dst
        batches = [(1, coords, valid)]
        if name == "FocalFormer3D_L":
            scans = [preprocess_points(cfg, *radial_scan(cfg, seed, device,
                                                         n_points))
                     for seed in range(4)]
            batches.append((4, torch.cat([v["coords"] for v in scans]),
                            torch.cat([v["voxel_mask"] for v in scans])))
        enc = SparseEncoder(
            sparse_shape=shape, encoder_channels=cfg.encoder_channels,
            down_paddings=cfg.down_paddings, capacities=cfg.capacities,
            out_capacity=cfg.out_capacity, engine="cuda",
            dense_from=cfg.sparse_dense_from_eval).to(device).eval()
        for b, c, v in batches:
            def whole(engine, c=c, v=v):
                return [(lvl.valid, lvl.meta, lvl.sites(), index)
                        for lvl, index, _ in enc._index_build(c, v, engine)]
            add(f"{name} whole eval build, batch {b}",
                lambda: whole("cuda"), lambda: whole("plain"))
            out[-1]["plain_eager_ms"] = eager_ms(lambda: whole("plain"))
            print(f"  torch ops eager {out[-1]['plain_eager_ms']:.4f} ms",
                  flush=True)
        del vox, coords, valid, src, enc, batches
        torch.cuda.empty_cache()
    bad = [r["case"] for r in out if r.get("equal") is False]
    if bad:
        raise SystemExit(f"not equal to the torch functions: {bad}")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, type=Path)
    ap.add_argument("--tag", default="")
    ap.add_argument("--kernels", choices=("k3_dw", "gather", "widen",
                                          "index"), default="k3_dw")
    args = ap.parse_args()
    root = args.root.resolve()
    _import(root)
    from focalformer3d_tpu_torch.tools.benchmark import card_info
    from focalformer3d_tpu_torch.tools.train import resolve_device

    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: no CUDA device")
    device = resolve_device("cuda")  # TF32 off
    print(card_info(device), flush=True)
    torch.set_grad_enabled(False)
    if args.kernels == "gather":
        print(json.dumps({"tag": args.tag, "root": str(root),
                          **gather_times(device)}), flush=True)
        return
    if args.kernels == "widen":
        print(json.dumps({"tag": args.tag, "root": str(root),
                          "widen": widen_times(device)}), flush=True)
        return
    if args.kernels == "index":
        print(json.dumps({"tag": args.tag, "root": str(root),
                          "index": index_times(device)}), flush=True)
        return
    k3_rows, k3_total = k3_times(device)
    dw_rows, dw_total = wgrad_times(device)
    print(json.dumps({"tag": args.tag, "root": str(root),
                      "k3_ms_per_scan": k3_total, "k3": k3_rows,
                      "wgrad_ms_per_step": dw_total, "wgrad": dw_rows}),
          flush=True)


if __name__ == "__main__":
    main()

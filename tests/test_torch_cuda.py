"""On-card checks of the PyTorch port (marker ``cuda``; skipped without one).

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has PyTorch with CUDA and no JAX. ``tests/conftest.py``
imports JAX, so run it there with

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_cuda.py

It holds the K1 and K3 kernels against their plain PyTorch versions (1e-3
of the output scale, the bf16-operand / f32-accumulate contract), K2's
rulebooks against ``decode_rules`` and ``build_conv_rules`` (exactly), the
index build and the voxelizer on the card against the same functions on the
CPU (exactly), the Tiny_L slice's encoder on each kernel engine against
the plain engine (1e-2, bf16 scale), K1's backward (dx on the transposed
rulebook, the dW kernel, the autograd Function; 1e-3) against its plain
versions, and one Tiny_L training step on the card against the same step
on the CPU (1e-3). For the probes (``focalformer3d_tpu_torch/tools/``): kernel
A and B's ``gather_taps`` against their plain versions (1e-3), B's
``gather_rows`` and C exactly, K1's phase probe in full mode against
production K1 bit for bit and in its other modes exactly, and every probe
module at its small size. The redesigned K1 (persistent blocks, hit masks,
pipelined gather, wgmma and mma.sync routes) and kernel A (both routes) have
their own grids of widths, tap counts, batch sizes and ragged sizes near the
end of the file; then come branch freezing (``freeze_pts`` launches no dx
or dW and keeps the point branch's bits) and a checkpoint round trip of a
card model; then the test CLI on a written nuScenes-format directory on
the card against the same run on the CPU's plain engine (1e-2), and the
same on a tiny LC config over a directory with JPEG cameras; last,
``dynamic_voxelize`` on the card against the CPU (coords and mask exactly,
features within 2 * 2**-23 * sum|x| per voxel), a DeformFormer3D_L scan
per engine with FocalFormer3D_L's launch counts, the TTA merge on the card
against the CPU (masks, labels and scores exactly, boxes 1e-5), and the
train and benchmark CLIs on DeformFormer3D_L. The camera path closes it:
the tiny LC model on ``cuda`` against the CPU's plain engine (the LSS BEV
1e-4, the heads 1e-2), FocalFormer3D_LC's launches per scan on each
engine equal to FocalFormer3D_L's on the same scan, and
DeformFormer3D_C_R50 launching no kernel. Training on the kernel engines
ends it: dW at (128, 128) with 27 and 3 taps (``cuda_mxu``'s L3 and
conv_out) against ``wgrad_plain``, ``zrun_conv_train`` against autograd
through its plain version (1e-3), and one full-width FocalFormer3D_L step
on ``cuda_mxu`` and on ``cuda_zrun`` with ``train_step``'s launch counts.
The CUDA graph replays close it: the index build's against its eager
build, and the eval head's (FocalFormer3D_L at batch 1 and 4,
_Waymo_L, ``boxcls``, _Waymo15_L's ``classaware_reg``) against the eager
head, bit for bit, with no host sync, across ``load_state_dict``, and
eager in training or with grad.

This file is the port's only card gate. The last sections hold the port
at the benchmark's sizes (a radial 200k-point FocalFormer3D_L scan, 180k
for _Waymo_L; ``tools/kernel_times.py`` builds the inputs): K2, K1 and K3
at every conv of a scan and the training convs at every conv of a batch of
two against their plain versions, the full-width BEV on each engine
against the plain engine, the Waymo configs' scans, the train, benchmark
and get_flops CLIs, the CLIs on written nuScenes, camera and Waymo
directories at a real sample's size (``data/synthetic_dirs.py``), the
frozen camera steps, and data parallelism at full width over two gloo
ranks on the card, each with its exact launch counts.
"""
import dataclasses
import json
import os
import socket
import sys

import numpy as np
import pytest
import torch

from focalformer3d_tpu_torch.configs import get_config
from focalformer3d_tpu_torch.data import synthetic, synthetic_dirs
from focalformer3d_tpu_torch.models import detector as tdet
from focalformer3d_tpu_torch.models.sparse_encoder import (Level,
                                                           backward_index,
                                                           conv_index)
from focalformer3d_tpu_torch.ops import plan_builder as tpb
from focalformer3d_tpu_torch.ops import plan_builder_cuda as k2
from focalformer3d_tpu_torch.ops import sparse_conv as tsc
from focalformer3d_tpu_torch.ops import sparse_conv_cuda as k1
from focalformer3d_tpu_torch.ops import sparse_conv_zrun as tzr
from focalformer3d_tpu_torch.ops import sparse_conv_zrun_cuda as k3
from focalformer3d_tpu_torch.tools import kernel_times as kt
from focalformer3d_tpu_torch.training import train_step
from focalformer3d_tpu_torch.utils.ref_keys import make_fake_state_dict

pytestmark = pytest.mark.cuda
SHAPE = (41, 40, 36)
GEOMS = {
    "subm": None,
    "down_p111": (3, 2, (1, 1, 1)),
    "down_p011": (3, 2, (0, 1, 1)),
    "conv_out": ((3, 1, 1), (2, 1, 1), 0),
}
ENGINES = ("cuda", "cuda_mxu", "cuda_zrun")
# (K1, K2, K3) launches per eval scan on each kernel engine
LAUNCHES_PER_SCAN = {"cuda": (11, 4, 0), "cuda_mxu": (21, 8, 0),
                     "cuda_zrun": (0, 0, 11)}
# the index build's (table, downsample) calls per eval scan (dense from L2)
INDEX_PER_SCAN = {"cuda": (1, 2), "cuda_mxu": (1, 0), "cuda_zrun": (1, 2)}
KERNELS = ("forward", "dx", "wgrad", "plan", "zrun", "index_table",
           "index_downsample")
# K1 forward / dx / dW, K2, K3 and index-build launches of a
# FocalFormer3D_L training step: 16 sparse convs up to the dense boundary
# L3 (conv_input's features take no dx), six conv geometries, three
# downsamples; ``cuda_mxu`` is all-sparse, 21 convs, 8 geometries
STEP_LAUNCHES = {
    "plain": dict.fromkeys(KERNELS, 0),
    "cuda": {"forward": 16, "dx": 15, "wgrad": 16, "plan": 6, "zrun": 0,
             "index_table": 1, "index_downsample": 3},
    "cuda_mxu": {"forward": 21, "dx": 20, "wgrad": 21, "plan": 8, "zrun": 0,
                 "index_table": 1, "index_downsample": 0},
    "cuda_zrun": {"forward": 0, "dx": 15, "wgrad": 16, "plan": 0, "zrun": 16,
                  "index_table": 1, "index_downsample": 3}}
# points of a full-size radial scan: the benchmark cells' sizes
FULL = {"FocalFormer3D_L": 200000, "FocalFormer3D_Waymo_L": 180000}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _kernel_launches():
    """K1 forward / dx / dW, K2, K3 and index-build launches since
    ``train_step.reset_kernel_launches``."""
    got = train_step.kernel_launches()
    return {k: got[k] for k in KERNELS}


def _eval_launches(engine, passes):
    """What ``passes`` eval scans launch on ``engine``."""
    fwd, plan, zrun = LAUNCHES_PER_SCAN[engine]
    table, down = INDEX_PER_SCAN[engine]
    return {"forward": fwd * passes, "dx": 0, "wgrad": 0,
            "plan": plan * passes, "zrun": zrun * passes,
            "index_table": table * passes, "index_downsample": down * passes}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _train_log(work):
    """The train records of a work dir's ``train_log.jsonl``."""
    with open(f"{work}/train_log.jsonl") as fh:
        return [r for r in map(json.loads, fh) if r["mode"] == "train"]


def _voxels(seed, n=5000, cap=6000):
    D, H, W = SHAPE
    rng = np.random.RandomState(seed)
    keys = np.sort(rng.choice(D * H * W, size=n, replace=False))
    z, yx = keys % D, keys // D
    coords = np.stack([z, yx // W, yx % W], -1).astype(np.int32)
    coords = torch.from_numpy(np.pad(coords, ((0, cap - n), (0, 0))))
    return coords, torch.arange(cap) < n


def _rules(coords, valid, geom):
    table = tsc.build_table_csr(coords, valid, SHAPE)
    if GEOMS[geom] is None:
        return tsc.build_subm_rules(table, SHAPE, 3), valid
    ks, stride, pad = GEOMS[geom]
    oc, ov = tsc.build_downsample(coords, valid, SHAPE, ks, stride, pad,
                                  4000)[:2]
    return tsc.build_conv_rules(table, SHAPE, oc, ov, ks, stride,
                                pad), ov


@pytest.mark.parametrize("geom", list(GEOMS))
def test_index_build_on_card_matches_cpu(dev, geom):
    coords, valid = _voxels(0)
    r_cpu, ov_cpu = _rules(coords, valid, geom)
    r_dev, ov_dev = _rules(coords.to(dev), valid.to(dev), geom)
    assert torch.equal(r_dev.cpu(), r_cpu)
    assert torch.equal(ov_dev.cpu(), ov_cpu)


@pytest.mark.parametrize("geom", list(GEOMS))
@pytest.mark.parametrize("cin,cout", [(5, 16), (16, 32), (32, 64), (8, 24),
                                      (64, 128), (128, 128)])
def test_kernel_vs_plain(dev, geom, cin, cout):
    coords, valid = _voxels(1)
    rules, ov = _rules(coords.to(dev), valid.to(dev), geom)
    K = rules.shape[0]
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    f = torch.randn(1, coords.shape[0], cin, device=dev, generator=g)
    w = torch.randn(K, cin, cout, device=dev, generator=g) * 0.2
    b = torch.randn(cout, device=dev, generator=g)
    args = (f.bfloat16(), rules[None], w.bfloat16(), ov[None], b)
    n0 = k1.launch_count()
    got = k1.sparse_conv(*args)
    torch.cuda.synchronize()
    assert k1.launch_count() == n0 + 1
    assert got.shape == (1, rules.shape[1], cout)
    ref = k1.apply_conv_plain(args[0].float(), args[1], args[2].float(),
                              args[3], b)
    assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-3
    assert torch.all(got[0][~ov] == 0)
    nob = k1.sparse_conv(*args[:4])
    ref0 = k1.apply_conv_plain(args[0].float(), args[1], args[2].float(),
                               args[3])
    assert float((nob - ref0).abs().max() / ref0.abs().max()) <= 1e-3


def test_kernel_rejects_cpu_mix_and_dtype(dev):
    coords, valid = _voxels(2)
    rules, ov = _rules(coords.to(dev), valid.to(dev), "subm")
    f = torch.zeros(1, coords.shape[0], 16, device=dev, dtype=torch.bfloat16)
    w = torch.zeros(27, 16, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        k1.sparse_conv(f, rules[None], w, ov[None])
    with pytest.raises(TypeError):
        k1.sparse_conv(f.float(), rules[None], w.to(dev), ov[None])


def _out_sites(coords, valid, geom):
    """(out coords, out valid, out shape) of a geometry, from the card."""
    if GEOMS[geom] is None:
        return coords, valid, SHAPE
    ks, stride, pad = GEOMS[geom]
    oc, ov, oshape = tsc.build_downsample(coords, valid, SHAPE, ks, stride,
                                          pad, 4000)[:3]
    return oc, ov, oshape


@pytest.mark.parametrize("geom", list(GEOMS))
def test_k2_vs_decode_rules(dev, geom):
    ks, stride, pad = GEOMS[geom] or (3, 1, 1)
    rules, colzs, metas = [], [], []
    for seed in (3, 4):  # a batch of two sets
        coords, valid = _voxels(seed)
        coords, valid = coords.to(dev), valid.to(dev)
        table = tsc.build_table_csr(coords, valid, SHAPE)
        oc, ov, oshape = _out_sites(coords, valid, geom)
        colzs.append(tpb.colz_from_coords(oc, ov, oshape[2]))
        metas.append(table.meta)
        rules.append(tsc.build_conv_rules(table, SHAPE, oc, ov, ks, stride,
                                          pad))
    meta, colz = torch.stack(metas), torch.stack(colzs)
    args = (meta, colz, 6000, ks, stride, pad, SHAPE, oshape[2])
    n0 = k2.launch_count()
    got = k2.plan_rules(*args)
    torch.cuda.synchronize()
    assert k2.launch_count() == n0 + 1
    for b in range(2):
        plain = tpb.decode_rules(colz[b], 6000, meta[b], *args[3:])
        assert torch.equal(got[b], plain)
        assert torch.equal(got[b], rules[b])
    # an input level whose meta counts voxels past its capacity: clipped
    clipped = k2.plan_rules(meta, colz, 1000, *args[3:])
    assert torch.equal(clipped, torch.clamp(got, max=1000))


@pytest.mark.parametrize("geom", list(GEOMS))
@pytest.mark.parametrize("cin,cout", [(5, 16), (16, 32), (32, 64), (8, 24),
                                      (64, 128)])
def test_k3_vs_plain(dev, geom, cin, cout):
    ks, stride, pad = GEOMS[geom] or (3, 1, 1)
    coords, valid = _voxels(5)
    coords, valid = coords.to(dev), valid.to(dev)
    table = tsc.build_table_csr(coords, valid, SHAPE)
    oc, ov, _ = _out_sites(coords, valid, geom)
    codes = tzr.build_zplan(table, SHAPE, oc, ov, ks, stride, pad)
    assert torch.equal(tzr.zrun_rules(codes, coords.shape[0]),
                       tsc.build_conv_rules(table, SHAPE, oc, ov, ks, stride,
                                            pad))
    K = 3 * codes.shape[0]
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    f = torch.randn(1, coords.shape[0], cin, device=dev, generator=g)
    w = torch.randn(K, cin, cout, device=dev, generator=g) * 0.2
    b = torch.randn(cout, device=dev, generator=g)
    args = (f.bfloat16(), codes[None], w.bfloat16(), ov[None], b)
    n0 = k3.launch_count()
    got = k3.zrun_conv(*args)
    torch.cuda.synchronize()
    assert k3.launch_count() == n0 + 1
    assert got.shape == (1, oc.shape[0], cout)
    ref = tzr.apply_conv_zrun_plain(args[0].float(), args[1],
                                    args[2].float(), args[3], b)
    assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-3
    assert torch.all(got[0][~ov] == 0)


def test_slice_on_card(dev):
    """Tiny_L end to end on the card: voxelizer equals the CPU's, the
    encoder's BEV on the kernel engine is near the plain engine's with 11
    kernel launches, and the boxes are finite."""
    cfg = get_config("Tiny_L")["model"]
    batch = synthetic.make_batch(
        np.random.RandomState(11), batch_size=1, n_points=3000, n_boxes=6,
        max_gts=8, num_classes=cfg.decoder.num_classes,
        pc_range=cfg.voxel.point_cloud_range, mode="radial")
    pts = torch.from_numpy(batch["points"])
    mask = torch.from_numpy(batch["points_mask"])
    sd = make_fake_state_dict(tdet.FocalFormer3D(cfg), 3)
    vox_cpu = tdet.preprocess_points(cfg, pts, mask)
    bev = {}
    with torch.no_grad():
        for engine in ("cuda", "plain"):
            c = dataclasses.replace(cfg, sparse_engine=engine)
            m = tdet.FocalFormer3D(c).eval()
            m.load_state_dict(sd, strict=True)
            m = m.to(dev)
            vox = tdet.preprocess_points(c, pts.to(dev), mask.to(dev))
            for k in ("coords", "voxel_mask"):
                assert torch.equal(vox[k].cpu(), vox_cpu[k])
            k1.reset_launch_count()
            bev[engine] = m.pts_middle_encoder(
                vox["features"], vox["coords"], vox["voxel_mask"])
            assert k1.launch_count() == (11 if engine == "cuda" else 0)
            dec = m.get_bboxes(m(vox), 200)
            assert torch.isfinite(dec["bboxes"]).all()
            assert torch.isfinite(dec["scores"]).all()
    err = (bev["cuda"] - bev["plain"]).abs().max() / bev["plain"].abs().max()
    assert float(err) <= 1e-2


@pytest.mark.parametrize("engine,dense_from,counts", [
    ("cuda_mxu", 4, (21, 8, 0)),   # K1, K2, K3 launches per scan
    ("cuda_zrun", 2, (0, 0, 11)),
])
def test_new_engines_on_card(dev, engine, dense_from, counts):
    """Tiny_L's encoder on the meta-chain and z-run engines against the
    plain engine at the same dense boundary (1e-2, bf16 scale), with exact
    launch counts, on a scan whose levels all fit their capacities."""
    cfg = get_config("Tiny_L")["model"]
    cfg = dataclasses.replace(cfg, capacities=(512, 1024, 512, 256),
                              out_capacity=256)
    batch = synthetic.make_batch(
        np.random.RandomState(11), batch_size=1, n_points=3000, n_boxes=6,
        max_gts=8, num_classes=cfg.decoder.num_classes,
        pc_range=cfg.voxel.point_cloud_range, mode="radial")
    pts = torch.from_numpy(batch["points"]).to(dev)
    mask = torch.from_numpy(batch["points_mask"]).to(dev)
    sd = make_fake_state_dict(tdet.FocalFormer3D(cfg), 3)
    bev = {}
    with torch.no_grad():
        for eng in (engine, "plain"):
            c = dataclasses.replace(cfg, sparse_engine=eng,
                                    sparse_dense_from_eval=dense_from)
            m = tdet.FocalFormer3D(c).eval()
            m.load_state_dict(sd, strict=True)
            m = m.to(dev)
            vox = tdet.preprocess_points(c, pts, mask)
            for k in (k1, k2, k3):
                k.reset_launch_count()
            bev[eng] = m.pts_middle_encoder(
                vox["features"], vox["coords"], vox["voxel_mask"])
            got = (k1.launch_count(), k2.launch_count(), k3.launch_count())
            assert got == (counts if eng == engine else (0, 0, 0))
            dec = m.get_bboxes(m(vox), 200)
            assert torch.isfinite(dec["bboxes"]).all()
    err = (bev[engine] - bev["plain"]).abs().max() / bev["plain"].abs().max()
    assert float(err) <= 1e-2


@pytest.mark.parametrize("geom", list(GEOMS))
@pytest.mark.parametrize("cin,cout", [(5, 16), (16, 16), (16, 32), (32, 64),
                                      (64, 128), (128, 64)])
def test_backward_kernels_vs_plain(dev, geom, cin, cout):
    """dx (K1 on the transposed rulebook) and dW (the dW kernel) against
    their plain versions, 1e-3 of the output scale (same rounding, f32
    sums in another order); the differentiable conv's dx, dW and db
    against autograd through its plain version."""
    coords, valid = _voxels(6)
    coords, valid = coords.to(dev), valid.to(dev)
    rules, ov = _rules(coords, valid, geom)
    v_in, K = coords.shape[0], rules.shape[0]
    rules_t = tsc.transpose_rules(rules, v_in)
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    x = torch.where(valid[:, None], torch.randn(v_in, cin, device=dev,
                                                generator=g), 0.0)[None]
    w = torch.randn(K, cin, cout, device=dev, generator=g) * 0.2
    cot = torch.where(ov[:, None], torch.randn(rules.shape[1], cout,
                                               device=dev, generator=g),
                      0.0)[None]
    xb, wb = x.bfloat16(), w.bfloat16()
    n0 = {kind: k1.launch_count(kind) for kind in ("dx", "wgrad")}
    dx = k1.conv_dx(cot, rules_t[None], wb)
    dw = k1.conv_wgrad(xb, cot, rules[None])
    torch.cuda.synchronize()
    assert {kind: k1.launch_count(kind) - n0[kind] for kind in n0} == \
        {"dx": 1, "wgrad": 1}
    every = torch.ones(1, v_in, dtype=torch.bool, device=dev)
    dx_ref = k1.apply_conv_plain(cot.bfloat16().float(), rules_t[None],
                                 wb.flip(0).transpose(1, 2).float(), every)
    dw_ref = k1.wgrad_plain(xb, cot, rules[None])
    assert dx.shape == (1, v_in, cin) and dw.shape == (K, cin, cout)
    assert float((dx - dx_ref).abs().max() / dx_ref.abs().max()) <= 1e-3
    assert float((dw - dw_ref).abs().max() / dw_ref.abs().max()) <= 1e-3
    assert torch.all(dx[0][~valid] == 0)  # padded rows get no gradient

    res = {}
    for tag in ("kernel", "plain"):
        xx = x.clone().requires_grad_(True)
        ww = w.clone().requires_grad_(True)
        bb = torch.zeros(cout, device=dev, requires_grad=True)
        with torch.enable_grad():  # other test modules may turn it off
            if tag == "kernel":
                y = k1.sparse_conv_train(xx, rules[None], rules_t[None], ww,
                                         ov[None], bb)
            else:
                y = k1.apply_conv_bf16_plain(xx, rules[None], ww, ov[None],
                                             bb)
            y.backward(torch.randn(
                y.shape, device=dev,
                generator=torch.Generator(dev).manual_seed(3)))
        res[tag] = (y.detach(), xx.grad, ww.grad, bb.grad)
    for got, ref in zip(res["kernel"], res["plain"]):
        assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-3


def test_wgrad_random_rulebook_with_misses(dev):
    """dW over a batch of two random rulebooks (a third of the rules miss)
    against its plain version; repeated launches give the same bits (the
    per-slice partials are summed in a fixed order)."""
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    B, v_in, v_out, K = 2, 3000, 2500, 27
    rules = torch.randint(0, v_in, (B, K, v_out), device=dev, generator=g,
                          dtype=torch.int32)
    miss = torch.rand(B, K, v_out, device=dev, generator=g) < 1 / 3
    rules = torch.where(miss, v_in, rules).to(torch.int32)
    x = torch.randn(B, v_in, 32, device=dev, generator=g).bfloat16()
    cot = torch.randn(B, v_out, 64, device=dev, generator=g)
    dw = k1.conv_wgrad(x, cot, rules)
    ref = k1.wgrad_plain(x, cot, rules)
    assert float((dw - ref).abs().max() / ref.abs().max()) <= 1e-3
    assert torch.equal(k1.conv_wgrad(x, cot, rules), dw)


def test_train_step_on_card_matches_cpu(dev):
    """One Tiny_L training step on engine ``cuda`` on the card (K1 forward,
    dx and dW kernels) against the same step on the CPU (their plain
    versions, the same rounding): every loss term and the gradient norm
    within 1e-3 relative, with 16 / 15 / 16 launches. Dropout is off and
    the GT-group noise is one draw, handed to both, so the two steps see
    the same numbers."""
    from focalformer3d_tpu_torch.models import focal_decoder as tfd
    from focalformer3d_tpu_torch.training import losses, optim

    cfg = get_config("Tiny_L")["model"]
    cfg = dataclasses.replace(cfg, sparse_engine="cuda",
                              decoder=dataclasses.replace(cfg.decoder,
                                                          roi_dropout=0.0))
    batch = synthetic.make_batch(
        np.random.RandomState(5), batch_size=2, n_points=2000, n_boxes=4,
        max_gts=8, num_classes=cfg.decoder.num_classes,
        pc_range=cfg.voxel.point_cloud_range, mode="radial")
    noise = torch.from_numpy(np.random.RandomState(9).uniform(
        -1, 1, (2, cfg.decoder.add_gt_groups * 8, 2)).astype(np.float32))
    sd = make_fake_state_dict(tdet.FocalFormer3D(cfg), 2)
    lcfg = losses.LossConfig(code_weights=(1.0,) * 8 + (0.2, 0.2))
    metrics = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(tfd, "gt_group_noise",
               lambda gen, shape, device: noise.to(device))
    try:
        for device in ("cpu", dev):
            m = tdet.FocalFormer3D(cfg)
            m.load_state_dict(sd, strict=True)
            for mod in m.modules():
                if isinstance(getattr(mod, "dropout", None), float):
                    mod.dropout = 0.0
            m = m.to(device)
            tx = optim.make_optimizer(total_steps=10)
            state = tx.init(list(m.parameters()))
            b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
            k1.reset_launch_count()
            met = train_step.make_train_step(cfg, lcfg, tx)(m, state, b,
                                                            None)
            metrics[str(device)] = {k: float(v) for k, v in met.items()}
            on_card = device != "cpu"
            assert [k1.launch_count(kind) for kind in
                    ("forward", "dx", "wgrad")] == \
                ([16, 15, 16] if on_card else [0, 0, 0])
    finally:
        mp.undo()
    cpu, card = metrics["cpu"], metrics[str(dev)]
    assert card["num_pos"] == cpu["num_pos"]
    for k, v in cpu.items():
        if k == "assign_iterations":
            continue
        assert np.isfinite(card[k]), k
        assert abs(card[k] - v) <= 1e-3 * max(abs(v), 1e-6), (k, card[k], v)


# ---------------------------------------------------------------------------
# the probes' kernels: A (micro_dot), B (micro_gather), C (micro_widen) and
# K1's phase probe, against their plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_a,m,k,n,reps,n_blocks,rows_out,store", [
    (1, 2304, 64, 128, 3, 40, 8, 0),      # P2's shape, fewer blocks
    (6, 200, 80, 48, 2, 6, 200, 3),       # ragged M, K and N tiles
    (3, 256, 1152, 16, 1, 7, 33, 6),      # block 6 reads a[6 mod 3]
])
def test_micro_dot_vs_plain(dev, n_a, m, k, n, reps, n_blocks, rows_out,
                            store):
    from focalformer3d_tpu_torch.ops import micro_dot

    g = torch.Generator(device=dev)
    g.manual_seed(5)
    a = torch.randn(n_a, m, k, device=dev, generator=g).bfloat16()
    b = torch.randn(k, n, device=dev, generator=g).bfloat16()
    n0 = micro_dot.launch_count()
    got = micro_dot.dot_probe(a, b, n_blocks, reps, rows_out, store)
    torch.cuda.synchronize()
    assert micro_dot.launch_count() == n0 + 1
    ref = micro_dot.dot_probe_plain(a, b, reps, rows_out, store)
    assert got.shape == (rows_out, n)
    assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-3


@pytest.mark.parametrize("r_rows,l,div", [(512, 128, 8), (256, 128, 1),
                                          (100, 24, 3)])
def test_gather_taps_vs_plain(dev, r_rows, l, div):
    from focalformer3d_tpu_torch.ops import micro_gather

    g = torch.Generator(device=dev)
    g.manual_seed(6)
    # a few indices past the window or negative: zero rows
    rel = torch.randint(-5, r_rows * div + 40, (37, 128, 27), device=dev,
                        generator=g, dtype=torch.int32)
    window = torch.randn(r_rows, l, device=dev, generator=g).bfloat16()
    n0 = micro_gather.launch_count("taps")
    got = micro_gather.gather_taps(rel, window, div)
    torch.cuda.synchronize()
    assert micro_gather.launch_count("taps") == n0 + 1
    ref = micro_gather.gather_taps_plain(rel, window, div)
    err = (got.float() - ref.float()).abs().max()
    assert float(err / ref.float().abs().max()) <= 1e-3


def test_gather_rows_exact(dev):
    from focalformer3d_tpu_torch.ops import micro_gather

    g = torch.Generator(device=dev)
    g.manual_seed(7)
    x = torch.randn(5000, 40, device=dev, generator=g).bfloat16()
    idx = torch.randint(-3, 5010, (100_003,), device=dev, generator=g,
                        dtype=torch.int32)
    n0 = micro_gather.launch_count("rows")
    got = micro_gather.gather_rows(x, idx)
    torch.cuda.synchronize()
    assert micro_gather.launch_count("rows") == n0 + 1
    assert torch.equal(got, micro_gather.gather_rows_plain(x, idx))


def _rows_routes():
    from focalformer3d_tpu_torch.ops import micro_gather

    return list(micro_gather.ROWS_ROUTE_NAMES)


@pytest.mark.parametrize("route", _rows_routes())
@pytest.mark.parametrize("C", [8, 24, 32, 64, 512, 1000, 2048, 4096])
def test_gather_rows_widths_exact(dev, C, route):
    """Every lane-group size (C / 8 chunks of 1-512) and route, bit for bit,
    with N not a multiple of any warp's rows and misses on both sides."""
    from focalformer3d_tpu_torch.ops import micro_gather

    g = torch.Generator(device=dev)
    g.manual_seed(C)
    V, N = 777, 3001
    x = torch.randn(V, C, device=dev, generator=g).bfloat16()
    idx = torch.randint(-4, V + 5, (N,), device=dev, generator=g,
                        dtype=torch.int32)
    idx[:2] = torch.tensor([-2**31, 2**31 - 1], dtype=torch.int32)
    n0 = micro_gather.launch_count("rows")
    got = micro_gather.gather_rows(x, idx, route=route)
    torch.cuda.synchronize()
    assert micro_gather.launch_count("rows") == n0 + 1
    assert torch.equal(got, micro_gather.gather_rows_plain(x, idx))
    assert torch.equal(micro_gather.gather_rows(x, idx, route=route), got)


@pytest.mark.parametrize("route", _rows_routes())
@pytest.mark.parametrize("N", [0, 1, 7, 33, 129])
def test_gather_rows_few_rows(dev, N, route):
    from focalformer3d_tpu_torch.ops import micro_gather

    x = torch.randn(50, 64, device=dev).bfloat16()
    idx = (torch.arange(N, device=dev, dtype=torch.int32) * 7) % 53 - 1
    got = micro_gather.gather_rows(x, idx, route=route)
    torch.cuda.synchronize()
    assert got.shape == (N, 64)
    assert torch.equal(got, micro_gather.gather_rows_plain(x, idx))


def _taps_routes():
    from focalformer3d_tpu_torch.ops import micro_gather

    return list(micro_gather.TAPS_ROUTE_NAMES)


@pytest.mark.parametrize("route", _taps_routes())
@pytest.mark.parametrize("n_tiles,T,K,r_rows,l,div", [
    (1024, 128, 27, 256, 128, 4),  # P6's shapes
    (1024, 128, 27, 512, 128, 1),  # W 512: one block per SM on smem
    (37, 128, 27, 100, 24, 3),     # 37 tiles: not a multiple of the grid
    (5, 16, 9, 64, 64, 5),         # stages of 64 rows over 80
    (3, 7, 27, 32, 8, 1),          # 21 rows, one 16-byte chunk per row
    (3, 10, 4096, 8, 16, 1),       # MAX_TAPS: stages of four rows
])
def test_gather_taps_routes(dev, n_tiles, T, K, r_rows, l, div, route):
    """Both routes within 1e-3 of the plain sums (summed in the same order,
    so also equal), equal across two runs, with misses on both sides and
    rel up to the window's end: the last row is rel R * div - 1."""
    from focalformer3d_tpu_torch.ops import micro_gather

    g = torch.Generator(device=dev)
    g.manual_seed(n_tiles + K)
    rel = torch.randint(-3, r_rows * div + 3 * div, (n_tiles, T, K),
                        device=dev, generator=g, dtype=torch.int32)
    rel.view(-1)[:3] = torch.tensor([r_rows * div - 1, r_rows * div,
                                     r_rows * div - div], dtype=torch.int32)
    window = torch.randn(r_rows, l, device=dev, generator=g).bfloat16()
    if micro_gather.taps_smem_bytes(micro_gather.TAPS_SMEM, r_rows, l, K,
                                    micro_gather.TAPS_STAGE_ROWS) > \
            micro_gather.SMEM_BYTES and route == micro_gather.TAPS_SMEM:
        with pytest.raises(ValueError):  # no room for the window's route
            micro_gather.gather_taps(rel, window, div, route=route)
        return
    n0 = micro_gather.launch_count("taps")
    got = micro_gather.gather_taps(rel, window, div, route=route)
    torch.cuda.synchronize()
    assert micro_gather.launch_count("taps") == n0 + 1
    ref = micro_gather.gather_taps_plain(rel, window, div)
    err = (got.float() - ref.float()).abs().max()
    assert float(err / ref.float().abs().max()) <= 1e-3
    assert torch.equal(got, ref)
    assert torch.equal(micro_gather.gather_taps(rel, window, div,
                                                route=route), got)


def test_gather_taps_largest_window_takes_the_global_route(dev):
    """A 227 KB window (908 rows of 128 bf16) leaves no room for the
    stages, so the plan takes the global route; its last row is read."""
    from focalformer3d_tpu_torch.ops import micro_gather

    R, L = 908, 128
    assert micro_gather.taps_plan(R, L, 27)["name"] == "global"
    with pytest.raises(ValueError):
        micro_gather.gather_taps(
            torch.zeros(1, 1, 27, dtype=torch.int32, device=dev),
            torch.zeros(R, L, dtype=torch.bfloat16, device=dev), 2,
            route=micro_gather.TAPS_SMEM)
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    rel = torch.randint(-1, 2 * R + 2, (40, 128, 27), device=dev,
                        generator=g, dtype=torch.int32)
    rel[0, 0, :] = 2 * R - 1
    window = torch.randn(R, L, device=dev, generator=g).bfloat16()
    got = micro_gather.gather_taps(rel, window, 2)
    torch.cuda.synchronize()
    ref = micro_gather.gather_taps_plain(rel, window, 2)
    assert torch.equal(got, ref)
    assert torch.equal(got[0, 0], (27 * window[-1].float()).bfloat16())


def _widen_routes_exact(meta, W):
    """C on its default route and each route forced: bit for bit equal to
    ``widen_meta9_plain``, one launch per call."""
    from focalformer3d_tpu_torch.ops import micro_widen

    ref = micro_widen.widen_meta9_plain(meta, W)
    for route in [None, *micro_widen.ROUTE_NAMES]:
        n0 = micro_widen.launch_count()
        got = micro_widen.widen_meta9(meta, W, route=route)
        torch.cuda.synchronize()
        assert micro_widen.launch_count() == n0 + 1
        assert got.shape == ref.shape
        assert torch.equal(got, ref), (W, meta.shape[0], route)


@pytest.mark.parametrize("W", [1, 2, 37, 360, 1440])
def test_widen_meta9_exact(dev, W):
    g = torch.Generator(device=dev)
    g.manual_seed(8)
    meta = torch.randint(0, 2**30, (W * W + 1, 4), device=dev, generator=g,
                         dtype=torch.int32)
    _widen_routes_exact(meta, W)


@pytest.mark.parametrize("W", [1, 2, 37, 360])
def test_widen_meta9_ragged_tiles(dev, W):
    """Row counts that are not a multiple of the tile: n_meta and n_meta +
    W one off a tile (and off two tiles), and metas shorter than W + 1
    rows, where every row's taps read padding in part."""
    from focalformer3d_tpu_torch.ops import micro_widen

    tile = micro_widen.TILE_ROWS
    sizes = {tile - 1, tile + 1, 2 * tile - 1, 2 * tile + 1,
             tile - W - 1, tile - W + 1, 1, 2, W // 2 + 1, W}
    g = torch.Generator(device=dev)
    g.manual_seed(9)
    for n_meta in sorted(n for n in sizes if n >= 1):
        meta = torch.randint(0, 2**30, (n_meta, 4), device=dev, generator=g,
                             dtype=torch.int32)
        _widen_routes_exact(meta, W)


def test_widen_meta9_all_ones_edges(dev):
    """A meta of ones at W 1440 (L0): the first and last W + 2 rows hold
    ones exactly at the taps that land inside the meta, on every route."""
    from focalformer3d_tpu_torch.ops import micro_widen

    W = 1440
    n_meta = W * W + 1
    meta = torch.ones(n_meta, 4, dtype=torch.int32, device=dev)
    r = torch.arange(n_meta + W, device=dev)[:, None]
    off = torch.tensor([(t // 3 - 1) * W + t % 3 - 1 for t in range(9)],
                       device=dev)
    inside = ((r + off >= 0) & (r + off < n_meta)).int()
    want = inside.repeat_interleave(4, dim=1)
    edges = torch.cat([torch.arange(W + 2), torch.arange(n_meta - 2,
                                                         n_meta + W)])
    for route in [None, *micro_widen.ROUTE_NAMES]:
        got = micro_widen.widen_meta9(meta, W, route=route)
        torch.cuda.synchronize()
        assert torch.equal(got[edges.to(dev)], want[edges.to(dev)])
        assert torch.equal(got, want)
    _widen_routes_exact(meta, W)


@pytest.mark.parametrize("geom", list(GEOMS))
@pytest.mark.parametrize("cin,cout", [(5, 16), (32, 64), (64, 128)])
def test_sparse_conv_probe_modes(dev, geom, cin, cout):
    """Full mode equals production K1 bit for bit; the modes with a phase
    off give the bias at the valid sites and zeros elsewhere, exactly."""
    coords, valid = _voxels(9)
    rules, ov = _rules(coords.to(dev), valid.to(dev), geom)
    g = torch.Generator(device=dev)
    g.manual_seed(9)
    f = torch.randn(1, coords.shape[0], cin, device=dev, generator=g)
    w = torch.randn(rules.shape[0], cin, cout, device=dev, generator=g)
    b = torch.randn(cout, device=dev, generator=g)
    args = (f.bfloat16(), rules[None], w.bfloat16(), ov[None], b)
    n0 = k1.launch_count("probe")
    full = k1.sparse_conv_probe(*args)
    assert torch.equal(full, k1.sparse_conv(*args))
    for phases in (0, k1.PHASE_GATHER, k1.PHASE_MMA):
        got = k1.sparse_conv_probe(*args, phases=phases)
        assert torch.equal(got, k1.sparse_conv_probe_plain(
            args[0].float(), args[1], args[2].float(), args[3], b, phases))
    torch.cuda.synchronize()
    assert k1.launch_count("probe") == n0 + 4


PROBES = ("micro_mxu_probe", "micro_dotshape", "micro_dotshape2",
          "micro_kernel_v2", "micro_pallas_attr", "micro_gather_kernel",
          "micro_gather2", "micro_batch_grid", "micro_meta9")


def _probe_rows(dev, name, size):
    """A probe's rows at ``size``: all checks pass (each kernel case held
    against its plain version), and every kernel case has its time and
    its plain version's."""
    import importlib

    mod = importlib.import_module(f"focalformer3d_tpu_torch.tools.{name}")
    rows = mod.run(dev, size)
    assert rows and all(r["ok"] for r in rows), [
        r["case"] for r in rows if not r["ok"]]
    for r in rows:
        if r["kernel"] is not None:
            assert r["ms"] > 0 and r["plain_ms"] > 0
        else:
            assert r["library_ms"] > 0


@pytest.mark.parametrize("name", PROBES)
def test_probe_runs_small_on_card(dev, name):
    """Every probe at its small size on the card (``_probe_rows``)."""
    _probe_rows(dev, name, "small")


@pytest.mark.parametrize("name", PROBES)
def test_probe_runs_full_on_card(dev, name):
    """Every probe at its full size, the original's shapes
    (``_probe_rows``)."""
    _probe_rows(dev, name, "full")
    torch.cuda.empty_cache()


def test_probe_timing_counts_graph_replays(dev):
    """A timed call is one eager launch, ``reps`` captured calls that
    launch nothing, and two replays that launch ``reps`` kernels each; the
    result is the replay's, equal to the plain version's."""
    from focalformer3d_tpu_torch.ops import micro_gather
    from focalformer3d_tpu_torch.tools import _common

    g = torch.Generator(device=dev)
    g.manual_seed(10)
    x = torch.randn(300, 32, device=dev, generator=g).bfloat16()
    idx = torch.randint(0, 300, (1000,), device=dev, generator=g,
                        dtype=torch.int32)
    n0 = micro_gather.launch_count("rows")
    ms, got = _common.time_ms(dev, lambda: micro_gather.gather_rows(x, idx),
                              reps=3)
    assert ms > 0 and micro_gather.launch_count("rows") == n0 + 1 + 2 * 3
    assert torch.equal(got, micro_gather.gather_rows_plain(x, idx))


# ---------------------------------------------------------------------------
# the redesigned K1 and kernel A, on both instruction routes
# ---------------------------------------------------------------------------

def _random_conv(dev, seed, B, v_in, v_out, K, c, cout, miss=0.7):
    """A random rulebook (a share ``miss`` of the rules miss) with bf16
    features and weights, a bias and an out_valid mask."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    rules = torch.randint(0, v_in, (B, K, v_out), device=dev, generator=g,
                          dtype=torch.int32)
    hole = torch.rand(B, K, v_out, device=dev, generator=g) < miss
    rules = torch.where(hole, v_in, rules).to(torch.int32)
    f = torch.randn(B, v_in, c, device=dev, generator=g).bfloat16()
    w = (torch.randn(K, c, cout, device=dev, generator=g) * 0.2).bfloat16()
    bias = torch.randn(cout, device=dev, generator=g)
    ov = torch.rand(B, v_out, device=dev, generator=g) < 0.9
    return f, rules, w, ov, bias


def _plain(args):
    f, rules, w, ov, bias = args
    return k1.apply_conv_plain(f.float(), rules, w.float(), ov, bias)


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("route", list(k1.ROUTE_NAMES))
@pytest.mark.parametrize("c", [16, 32, 64, 128])
@pytest.mark.parametrize("cout", [16, 32, 64, 128])
def test_k1_widths_taps_and_batches(dev, route, c, cout):
    """Every pair of widths (the dx widths 32 -> 16, 64 -> 32, 128 -> 64
    among them) with K in {1, 27} and batch 1 and 2 on each route: within
    1e-3 of the plain conv, two runs equal bit for bit, zeros at invalid
    sites."""
    for seed, (K, B, v_out) in enumerate([(27, 2, 5000), (1, 1, 5000),
                                          (27, 1, 129), (1, 2, 127)]):
        args = _random_conv(dev, seed, B, 3000, v_out, K, c, cout)
        got = k1.sparse_conv_probe(*args, route=route)
        again = k1.sparse_conv_probe(*args, route=route)
        torch.cuda.synchronize()
        assert got.shape == (B, v_out, cout)
        assert _rel(got, _plain(args)) <= 1e-3
        assert torch.equal(got, again)
        assert torch.all(got[~args[3]] == 0)


@pytest.mark.parametrize("route", list(k1.ROUTE_NAMES))
@pytest.mark.parametrize("v_out", [1, 127, 128, 129, 5000])
def test_k1_ragged_site_counts(dev, route, v_out):
    for c, cout in ((16, 16), (32, 64), (64, 64)):
        args = _random_conv(dev, v_out, 2, 777, v_out, 27, c, cout)
        got = k1.sparse_conv_probe(*args, route=route)
        assert _rel(got, _plain(args)) <= 1e-3


@pytest.mark.parametrize("route", list(k1.ROUTE_NAMES))
@pytest.mark.parametrize("c,cout", [(16, 16), (32, 32), (64, 64), (128, 128)])
def test_k1_all_miss_and_single_hit(dev, route, c, cout):
    """A rulebook on which every rule misses gives the bias at the valid
    sites exactly; one with a single hit in one tile matches the plain
    conv."""
    f, rules, w, ov, bias = _random_conv(dev, 3, 1, 3000, 1000, 27, c, cout)
    rules = torch.full_like(rules, 3000)
    got = k1.sparse_conv_probe(f, rules, w, ov, bias, route=route)
    assert torch.equal(got, torch.where(ov[..., None], bias, 0.0))
    rules[0, 13, 700] = 5
    args = (f, rules, w, ov, bias)
    got = k1.sparse_conv_probe(*args, route=route)
    ref = _plain(args)
    assert _rel(got, ref) <= 1e-3
    touched = torch.zeros(1000, dtype=torch.bool, device=dev)
    touched[700] = True
    assert torch.equal(got[0][~touched], ref[0][~touched])


def test_k1_production_route_and_wide_input(dev):
    """``sparse_conv`` runs ``route_for``'s route (its bits equal the probe's
    on that route); an input of 256 channels runs as two launches."""
    for c, cout in ((16, 16), (32, 32), (64, 64), (64, 128), (128, 64)):
        args = _random_conv(dev, 4, 2, 3000, 2000, 27, c, cout)
        got = k1.sparse_conv(*args)
        route = k1.route_for(*k1.kernel_widths(c, cout))
        assert torch.equal(got, k1.sparse_conv_probe(*args, route=route))
        plan = k1.launch_plan(2, 2000, 27, c, cout)
        assert plan["route"] == k1.ROUTE_NAMES[route] and plan["grid"] >= 1
    args = _random_conv(dev, 5, 1, 3000, 1000, 27, 256, 64)
    n0 = k1.launch_count()
    got = k1.sparse_conv(*args)
    assert k1.launch_count() == n0 + 2
    assert _rel(got, _plain(args)) <= 1e-3


@pytest.mark.parametrize("route", list(k1.ROUTE_NAMES))
@pytest.mark.parametrize("c,cout", [(16, 16), (32, 64), (64, 64), (128, 32)])
def test_k1_phase_modes_on_each_route(dev, route, c, cout):
    """The four ``PHASES`` modes on each route, W resident (16x16, 32x64)
    and streamed (64x64, 128x32): full within 1e-3 of the plain conv, the
    others the bias at valid sites, exactly."""
    args = _random_conv(dev, 6, 2, 3000, 1500, 27, c, cout)
    assert _rel(k1.sparse_conv_probe(*args, route=route),
                _plain(args)) <= 1e-3
    for phases in (0, k1.PHASE_GATHER, k1.PHASE_MMA):
        got = k1.sparse_conv_probe(*args, phases=phases, route=route)
        assert torch.equal(got, k1.sparse_conv_probe_plain(
            args[0].float(), args[1], args[2].float(), args[3], args[4],
            phases))


def test_pack_weights_on_card_matches_cpu(dev):
    w = torch.randn(27, 64, 32).bfloat16()
    assert torch.equal(k1.pack_weights(w.to(dev)).cpu(), k1.pack_weights(w))


@pytest.mark.parametrize("route", [0, 1])
@pytest.mark.parametrize("k", [16, 32, 64, 80])
@pytest.mark.parametrize("n", [16, 64, 256])
def test_micro_dot_depths_and_widths(dev, route, k, n):
    """Kernel A at depths short of, equal to and past one 64-deep slice and
    at column tiles of 16, 64 and 128, with M short of a tile (100), equal
    to one (128) and past one (300), on each route."""
    from focalformer3d_tpu_torch.ops import micro_dot

    g = torch.Generator(device=dev)
    g.manual_seed(k + n)
    for m in (100, 128, 300):
        a = torch.randn(2, m, k, device=dev, generator=g).bfloat16()
        b = torch.randn(k, n, device=dev, generator=g).bfloat16()
        got = micro_dot.dot_probe(a, b, 3, 2, m, 1, route=route)
        ref = micro_dot.dot_probe_plain(a, b, 2, m, 1)
        assert got.shape == (m, n)
        assert _rel(got, ref) <= 1e-3


# ---------------------------------------------------------------------------
# the redesigned K3 (K1's tile kernel on z-run codes) and dW (tensor cores,
# split cotangent)
# ---------------------------------------------------------------------------

def _zrun_conv(dev, seed, B, v_in, v_out, R, c, cout, miss=0.5):
    """Random z-run codes (a share ``miss`` without any z tap; anchors up
    to v_in + 1, so some rows fall past V_in and miss) with bf16 features
    and weights, a bias and an out_valid mask."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    anchor = torch.randint(0, v_in + 2, (B, R, v_out), device=dev,
                           generator=g)
    pattern = torch.randint(1, 8, (B, R, v_out), device=dev, generator=g)
    hole = torch.rand(B, R, v_out, device=dev, generator=g) < miss
    codes = torch.where(hole, 0, (anchor << 3) | pattern).to(torch.int32)
    f = torch.randn(B, v_in, c, device=dev, generator=g).bfloat16()
    w = (torch.randn(3 * R, c, cout, device=dev, generator=g)
         * 0.2).bfloat16()
    bias = torch.randn(cout, device=dev, generator=g)
    ov = torch.rand(B, v_out, device=dev, generator=g) < 0.9
    return f, codes, w, ov, bias


def _zrun_plain(args):
    f, codes, w, ov, bias = args
    return tzr.apply_conv_zrun_plain(f.float(), codes, w.float(), ov, bias)


@pytest.mark.parametrize("route", list(k1.ROUTE_NAMES))
@pytest.mark.parametrize("c", [16, 32, 64, 128])
@pytest.mark.parametrize("cout", [16, 32, 64, 128])
def test_k3_widths_on_each_route(dev, route, c, cout):
    """Every pair of widths with R in {1, 9} and batch 1 and 2 on each
    route (three z taps a stage where two such stages fit, one at C = 128):
    within 1e-3 of the plain conv, two runs equal bit for bit, zeros at
    invalid sites, one launch each."""
    for seed, (R, B, v_out) in enumerate([(9, 2, 3000), (1, 1, 129),
                                          (9, 1, 127)]):
        args = _zrun_conv(dev, seed, B, 2000, v_out, R, c, cout)
        n0 = k3.launch_count()
        got = k3.zrun_conv(*args, route=route)
        again = k3.zrun_conv(*args, route=route)
        torch.cuda.synchronize()
        assert k3.launch_count() == n0 + 2
        assert got.shape == (B, v_out, cout)
        assert _rel(got, _zrun_plain(args)) <= 1e-3
        assert torch.equal(got, again)
        assert torch.all(got[~args[3]] == 0)
    plan = k3.launch_plan(2, 3000, 9, c, cout, route)
    assert plan["z_per_stage"] == (1 if c == 128 and cout >= 32 else 3)
    assert plan["route"] == k1.ROUTE_NAMES[route] and plan["grid"] >= 1


@pytest.mark.parametrize("route", list(k1.ROUTE_NAMES))
@pytest.mark.parametrize("geom", list(GEOMS))
@pytest.mark.parametrize("cin,cout", [(16, 16), (32, 64), (64, 128),
                                      (128, 128), (128, 16)])
def test_k3_geometries_on_each_route(dev, route, geom, cin, cout):
    """K3 on the codes of a submanifold and three strided geometries of a
    CSR voxel set, on each route: within 1e-3 of the plain conv and of K1
    on the rulebook the codes encode."""
    ks, stride, pad = GEOMS[geom] or (3, 1, 1)
    coords, valid = _voxels(12)
    coords, valid = coords.to(dev), valid.to(dev)
    table = tsc.build_table_csr(coords, valid, SHAPE)
    oc, ov, _ = _out_sites(coords, valid, geom)
    codes = tzr.build_zplan(table, SHAPE, oc, ov, ks, stride, pad)[None]
    g = torch.Generator(device=dev)
    g.manual_seed(13)
    f = torch.randn(1, coords.shape[0], cin, device=dev,
                    generator=g).bfloat16()
    w = (torch.randn(3 * codes.shape[1], cin, cout, device=dev, generator=g)
         * 0.2).bfloat16()
    b = torch.randn(cout, device=dev, generator=g)
    args = (f, codes, w, ov[None], b)
    got = k3.zrun_conv(*args, route=route)
    assert _rel(got, _zrun_plain(args)) <= 1e-3
    rules = tzr.zrun_rules(codes, coords.shape[0])
    assert _rel(got, k1.sparse_conv(f, rules, w, ov[None], b)) <= 1e-3


@pytest.mark.parametrize("route", list(k1.ROUTE_NAMES))
@pytest.mark.parametrize("v_out", [1, 127, 128, 129])
def test_k3_ragged_site_counts(dev, route, v_out):
    for c, cout in ((16, 16), (32, 64), (64, 64)):
        args = _zrun_conv(dev, v_out, 2, 777, v_out, 9, c, cout)
        assert _rel(k3.zrun_conv(*args, route=route),
                    _zrun_plain(args)) <= 1e-3


@pytest.mark.parametrize("route", list(k1.ROUTE_NAMES))
@pytest.mark.parametrize("c,cout", [(16, 16), (32, 32), (64, 64), (128, 128)])
def test_k3_all_miss_single_hit_and_gap(dev, route, c, cout):
    """Codes without any z tap give the bias at the valid sites exactly;
    a single hit, and a site whose pattern 0b101 reads z0 and z0 + 2 from
    consecutive rows, match the plain conv and leave every other site at
    the bias."""
    f, codes, w, ov, bias = _zrun_conv(dev, 3, 1, 3000, 1000, 9, c, cout)
    codes = torch.zeros_like(codes)
    got = k3.zrun_conv(f, codes, w, ov, bias, route=route)
    assert torch.equal(got, torch.where(ov[..., None], bias, 0.0))
    codes[0, 4, 700] = (5 << 3) | 0b010
    codes[0, 2, 300] = (10 << 3) | 0b101
    args = (f, codes, w, ov, bias)
    got = k3.zrun_conv(*args, route=route)
    ref = _zrun_plain(args)
    assert _rel(got, ref) <= 1e-3
    touched = torch.zeros(1000, dtype=torch.bool, device=dev)
    touched[[300, 700]] = True
    assert torch.equal(got[0][~touched], ref[0][~touched])
    gap = tzr.zrun_rules(codes, 3000)[0, :, 300]
    assert gap[[2, 9 + 2, 18 + 2]].tolist() == [10, 3000, 11]


@pytest.mark.parametrize("c", [16, 32, 64, 128])
@pytest.mark.parametrize("cout", [16, 32, 64, 128])
def test_wgrad_widths(dev, c, cout):
    """dW at every pair of widths over a batch of two random rulebooks
    (two fifths of the rules miss): within 1e-3 of its plain version (the
    same split of the cotangent; f32 sums in another order), two runs equal
    bit for bit, one launch each."""
    g = torch.Generator(device=dev)
    g.manual_seed(c + cout)
    B, v_in, v_out, K = 2, 3000, 2500, 27
    rules = torch.randint(0, v_in, (B, K, v_out), device=dev, generator=g,
                          dtype=torch.int32)
    miss = torch.rand(B, K, v_out, device=dev, generator=g) < 0.4
    rules = torch.where(miss, v_in, rules).to(torch.int32)
    x = torch.randn(B, v_in, c, device=dev, generator=g).bfloat16()
    cot = torch.randn(B, v_out, cout, device=dev, generator=g)
    n0 = k1.launch_count("wgrad")
    dw = k1.conv_wgrad(x, cot, rules)
    again = k1.conv_wgrad(x, cot, rules)
    torch.cuda.synchronize()
    assert k1.launch_count("wgrad") == n0 + 2
    assert dw.shape == (K, c, cout)
    assert _rel(dw, k1.wgrad_plain(x, cot, rules)) <= 1e-3
    assert torch.equal(dw, again)
    assert k1.wgrad_chunk(c, cout) == (
        128 if 128 * (2 * c + 4 * (cout + 4)) <= 32 * 1024 else 64)


@pytest.mark.parametrize("miss", [0.0, 0.9])
@pytest.mark.parametrize("c,cout", [(16, 32), (64, 128), (128, 128)])
def test_wgrad_long_slices(dev, miss, c, cout):
    """dW where each block's slice spans several rounds of rule loads and
    crosses from one sample into the next (V_out not a multiple of 256),
    on a dense and a sparse rulebook: within 1e-3 of its plain version, two
    runs equal bit for bit."""
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    B, v_in, v_out, K = 2, 60000, 100003, 27
    n_slices, per = k1.wgrad_slices(B * v_out, K)
    assert per > 256 and (n_slices - 1) * per < B * v_out <= n_slices * per
    rules = torch.randint(0, v_in, (B, K, v_out), device=dev, generator=g,
                          dtype=torch.int32)
    drop = torch.rand(B, K, v_out, device=dev, generator=g) < miss
    rules = torch.where(drop, v_in, rules).to(torch.int32)
    x = torch.randn(B, v_in, c, device=dev, generator=g).bfloat16()
    cot = torch.randn(B, v_out, cout, device=dev, generator=g)
    dw = k1.conv_wgrad(x, cot, rules)
    assert _rel(dw, k1.wgrad_plain(x, cot, rules)) <= 1e-3
    assert torch.equal(dw, k1.conv_wgrad(x, cot, rules))


def test_k3_and_wgrad_reject_dtypes_and_devices(dev):
    f, codes, w, ov, bias = _zrun_conv(dev, 1, 1, 500, 300, 9, 16, 16)
    with pytest.raises(TypeError):
        k3.zrun_conv(f.float(), codes, w, ov, bias)
    with pytest.raises(TypeError):
        k3.zrun_conv(f, codes.long(), w, ov, bias)
    with pytest.raises(ValueError):
        k3.zrun_conv(f, codes.cpu(), w, ov, bias)
    with pytest.raises(ValueError):
        k3.zrun_conv(f, codes, w, ov, bias, route=2)
    rules = torch.full((1, 27, 300), 500, dtype=torch.int32, device=dev)
    cot = torch.zeros(1, 300, 16, device=dev)
    with pytest.raises(TypeError):
        k1.conv_wgrad(f.float(), cot, rules)
    with pytest.raises(TypeError):
        k1.conv_wgrad(f, cot.bfloat16(), rules)
    with pytest.raises(ValueError):
        k1.conv_wgrad(f, cot, rules.cpu())
    assert torch.equal(k1.conv_wgrad(f, cot, rules),
                       torch.zeros(27, 16, 16, device=dev))


# ---------------------------------------------------------------------------
# branch freezing and checkpoints on the card
# ---------------------------------------------------------------------------

def _tiny_freeze_setup(dev, freeze_pts):
    from focalformer3d_tpu_torch.training import optim

    c = get_config("Tiny_L")
    cfg = dataclasses.replace(c["model"], sparse_engine="cuda",
                              freeze_pts=freeze_pts)
    m = tdet.FocalFormer3D(cfg)
    m.load_state_dict(make_fake_state_dict(m, 2), strict=True)
    m = m.to(dev)
    tx = optim.make_optimizer(total_steps=10)
    state = tx.init(m.named_parameters())
    batch = synthetic.make_batch(
        np.random.RandomState(5), batch_size=2, n_points=2000, n_boxes=4,
        max_gts=8, num_classes=cfg.decoder.num_classes,
        pc_range=cfg.voxel.point_cloud_range, mode="radial")
    b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    return cfg, c["loss"], tx, m, state, b


def test_freeze_pts_step_on_card(dev):
    """Tiny_L with ``freeze_pts`` on engine ``cuda``: two steps launch K1
    forward at the eval boundary's 11 convs per step and no dx or dW, and
    leave every point-branch parameter and batch-norm statistic (with
    ``imgpts_neck.shared_conv_pts``) bit-identical while the head moves."""
    cfg, lcfg, tx, m, state, b = _tiny_freeze_setup(dev, True)
    before = {k: v.clone() for k, v in m.state_dict().items()}
    step = train_step.make_train_step(cfg, lcfg, tx)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    k1.reset_launch_count()
    for _ in range(2):
        met = step(m, state, b, gen)
        assert all(np.isfinite(float(v)) for v in met.values())
    assert [k1.launch_count(k) for k in ("forward", "dx", "wgrad")] == \
        [22, 0, 0]
    after = m.state_dict()
    pts = ("pts_middle_encoder.", "pts_backbone.", "pts_neck.",
           "imgpts_neck.shared_conv_pts.")
    frozen = [k for k in after if k.startswith(pts)]
    assert any(k.endswith("running_var") for k in frozen)
    for k in frozen:
        assert torch.equal(after[k], before[k]), k
    head = [k for k in after if k.startswith("pts_bbox_head.")
            and not torch.equal(after[k], before[k])]
    assert len(head) > 50


def test_checkpoint_round_trip_on_card(dev, tmp_path):
    """A card model and its optimizer state after one step, saved and
    restored into a fresh card model: parameters, buffers, moments and the
    step bit for bit, all on the card."""
    from focalformer3d_tpu_torch.training import checkpoint as ckpt

    cfg, lcfg, tx, m, state, b = _tiny_freeze_setup(dev, False)
    train_step.make_train_step(cfg, lcfg, tx)(m, state, b, None)
    ckpt.save_checkpoint(str(tmp_path), m, state, epoch=1)
    _, _, _, m2, s2, _ = _tiny_freeze_setup(dev, False)
    assert ckpt.auto_resume(str(tmp_path), m2, s2) == 1
    assert s2.count == state.count == 1
    for k, v in m.state_dict().items():
        got = m2.state_dict()[k]
        assert got.device == v.device and torch.equal(got, v), k
    for a, c in zip(s2.mu + s2.nu, state.mu + state.nu):
        assert a.device.type == "cuda" and torch.equal(a, c)


# ---------------------------------------------------------------------------
# the test CLI on a written nuScenes-format directory
# ---------------------------------------------------------------------------

def _top_boxes_close(got, ref, k=50, tol=1e-2):
    """The ``k`` best-scored boxes of ``ref`` (the CPU run) each have a box
    of the same label in ``got`` (the card's ``k + 10`` best) within
    ``tol`` of the scale of ``ref``'s boxes (yaw as its wrapped
    difference, in radians against pi), and the ``k`` best scores agree
    within ``tol`` of the best score. Near-ties may swap order, so boxes
    are paired by their nearest BEV centre, not by rank."""
    top = np.argsort(-ref["scores"])[:k]
    cand = np.argsort(-got["scores"])[:k + 10]
    scores = np.sort(ref["scores"])[::-1][:k]
    np.testing.assert_allclose(np.sort(got["scores"])[::-1][:k], scores,
                               rtol=0, atol=tol * scores[0])
    cols = [c for c in (0, 1, 2, 3, 4, 5, 7, 8) if c < ref["boxes"].shape[1]]
    scale = np.abs(ref["boxes"][top][:, cols]).max()
    for i in top:
        same = cand[got["labels"][cand] == ref["labels"][i]]
        d = np.linalg.norm(got["boxes"][same, :2] - ref["boxes"][i, :2],
                           axis=1)
        j = same[np.argmin(d)]
        assert np.abs(got["boxes"][j, cols] - ref["boxes"][i, cols]).max() \
            <= tol * scale, (i, got["boxes"][j], ref["boxes"][i])
        dyaw = (got["boxes"][j, 6] - ref["boxes"][i, 6] + np.pi) \
            % (2 * np.pi) - np.pi
        assert abs(dyaw) <= tol * np.pi, (i, dyaw)


def test_test_cli_on_card_matches_cpu(dev, tmp_path):
    """The test CLI (Tiny_L, random weights from a seed) on a directory of
    ``synthetic_dirs.write_nuscenes``: engine ``cuda`` on the card (K1, 11
    launches a sample) against ``--device cpu`` on the plain engine, the
    best 50 boxes of each sample (all 32 that Tiny_L keeps) within 1e-2
    (``_top_boxes_close``)."""
    from focalformer3d_tpu_torch.tools import test as test_cli

    cfg_all = get_config("Tiny_L")
    synthetic_dirs.write_nuscenes(
        tmp_path, seed=3, samples=2, points=1500, sweeps=2,
        pc_range=cfg_all["model"].voxel.point_cloud_range,
        classes=cfg_all["class_names"], boxes=4)
    runs = {}
    for device, engine in (("cuda", "cuda"), ("cpu", "plain")):
        k1.reset_launch_count()
        runs[device] = test_cli.main([
            "Tiny_L", "--data-root", str(tmp_path), "--device", device,
            "--engine", engine, "--limit", "2", "--max-points", "6000",
            "--seed", "3"])
        assert k1.launch_count() == (22 if device == "cuda" else 0)
    assert set(runs["cuda"].predictions) == set(runs["cpu"].predictions)
    for tok, ref in runs["cpu"].predictions.items():
        assert len(ref["scores"]) >= 30  # Tiny_L keeps 32
        _top_boxes_close(runs["cuda"].predictions[tok], ref)


def test_test_cli_on_a_camera_directory_matches_cpu(dev, tmp_path,
                                                   monkeypatch):
    """The test CLI on a tiny LC config (``Tiny_LC`` of
    ``tests/test_torch_camera_cli.py``) over a written directory with six
    90 x 160 JPEG cameras a sample, decoded by the port's decoder: engine
    ``cuda`` on the card (K1, 11 launches a sample) against ``--device
    cpu`` on the plain engine, the best 50 boxes of each sample within 1e-2
    (``_top_boxes_close``, as for Tiny_L)."""
    from focalformer3d_tpu_torch import configs as tconfigs
    from focalformer3d_tpu_torch.data import image_io
    from focalformer3d_tpu_torch.tools import test as test_cli
    from test_torch_camera_cli import _tiny_lc

    monkeypatch.setitem(tconfigs._REGISTRY, "Tiny_LC", _tiny_lc)
    cfg_all = get_config("Tiny_L")
    synthetic_dirs.write_nuscenes(
        tmp_path, seed=3, samples=2, points=1500, sweeps=2,
        pc_range=cfg_all["model"].voxel.point_cloud_range,
        classes=cfg_all["class_names"], boxes=4, cameras=True,
        img_hw=(90, 160))
    runs = {}
    for device, engine in (("cuda", "cuda"), ("cpu", "plain")):
        k1.reset_launch_count()
        image_io.reset_call_count()
        runs[device] = test_cli.main([
            "Tiny_LC", "--data-root", str(tmp_path), "--device", device,
            "--engine", engine, "--limit", "2", "--max-points", "6000",
            "--seed", "3"])
        assert k1.launch_count() == (22 if device == "cuda" else 0)
        assert image_io.call_count() == 12
    assert set(runs["cuda"].predictions) == set(runs["cpu"].predictions)
    for tok, ref in runs["cpu"].predictions.items():
        assert len(ref["scores"]) >= 30
        _top_boxes_close(runs["cuda"].predictions[tok], ref)


# ---------------------------------------------------------------------------
# dynamic voxelization, DeformFormer3D_L and the TTA merge
# ---------------------------------------------------------------------------

def _voxel_abs_sums(vcfg, points, mask):
    """float64 sum of |x| over each kept voxel's points, (max_voxels, D)
    in CSR order: the scale of a voxel mean's float32 rounding."""
    from focalformer3d_tpu_torch.ops.voxelize import (INT32_MAX,
                                                      _linear_key,
                                                      point_voxel_coords)

    coords, valid = point_voxel_coords(vcfg, points, mask)
    key = _linear_key(coords, valid, vcfg.grid_size)
    uniq, inv = torch.unique(key, return_inverse=True)
    sums = torch.zeros((len(uniq), points.shape[1]), dtype=torch.float64)
    sums.index_add_(0, inv, points.abs().double())
    sums = sums[uniq != INT32_MAX][:vcfg.max_voxels]
    out = torch.zeros((vcfg.max_voxels, points.shape[1]), dtype=torch.float64)
    out[:len(sums)] = sums
    return out


def _decided(cands, cfg, margin=1e-5):
    """True where no two valid class-offset candidates have a BEV IoU
    within ``margin`` of the NMS or the vote threshold (on the CPU): there
    two correct IoUs may decide differently."""
    from focalformer3d_tpu_torch.core.iou import boxes_iou_bev

    b, _, lab, v = (torch.from_numpy(x) for x in cands)
    b = b[v].clone()
    b[:, 0] += lab[v].to(b.dtype) * (2.0 * 200.0)
    iou = boxes_iou_bev(b, b)
    return not any(bool(((iou - t).abs() <= margin).any())
                   for t in (cfg.nms_thresh, cfg.vote_iou))


def _radial(cfg, seed, n):
    batch = synthetic.make_batch(
        np.random.RandomState(seed), batch_size=1, n_points=n, n_boxes=12,
        max_gts=16, num_classes=cfg.decoder.num_classes,
        pc_range=cfg.voxel.point_cloud_range, mode="radial")
    return (torch.from_numpy(batch["points"]),
            torch.from_numpy(batch["points_mask"]))


@pytest.mark.parametrize("max_voxels", [60000, 5000])
def test_dynamic_voxelize_on_card_matches_cpu(dev, max_voxels):
    """DeformFormer3D_L_dynamic's voxelizer on a 60k-point radial scan, all
    voxels kept and capped: coords and mask bit for bit, features within
    2 * 2**-23 * sum|x| of each voxel (the card's atomic adds sum in any
    order)."""
    from focalformer3d_tpu_torch.ops.voxelize import dynamic_voxelize

    cfg = get_config("DeformFormer3D_L_dynamic")["model"]
    vcfg = dataclasses.replace(cfg.voxel, max_voxels=max_voxels)
    pts, mask = (x[0] for x in _radial(cfg, 5, 60000))
    ref = dynamic_voxelize(vcfg, pts, mask)
    got = dynamic_voxelize(vcfg, pts.to(dev), mask.to(dev))
    for k in ("coords", "voxel_mask"):
        assert torch.equal(got[k].cpu(), ref[k]), k
    n = int(ref["voxel_mask"].sum())
    assert (n == max_voxels) == (max_voxels == 5000)
    bound = 2 * 2.0 ** -23 * _voxel_abs_sums(vcfg, pts, mask)
    err = (got["features"].cpu().double() - ref["features"].double()).abs()
    assert bool((err <= bound).all()), float(err.max())


def _scans_on_card(dev, name, engine, n_points, seeds):
    """``name`` at full width, bf16, seeded weights, on ``engine``: one
    radial scan of ``n_points`` a seed, in turn (a third call replays the
    index build and the head), each through ``preprocess_points`` -> model
    -> ``get_bboxes``: the head's queries (200 a heatmap stage) with finite
    boxes and scores, 1-200 kept; FocalFormer3D_L's launches per scan (its
    encoder) exactly."""
    from focalformer3d_tpu_torch.configs import with_compute_dtype

    cfg = with_compute_dtype(dataclasses.replace(
        get_config(name)["model"], sparse_engine=engine), "bfloat16")
    m = tdet.FocalFormer3D(cfg).eval()
    m.load_state_dict(make_fake_state_dict(m, 0), strict=True)
    m = m.to(dev)
    train_step.reset_kernel_launches()
    for seed in seeds:
        pts, mask = (x.to(dev) for x in _radial(cfg, seed, n_points))
        with torch.no_grad():
            dec = m.get_bboxes(m(tdet.preprocess_points(cfg, pts, mask)),
                               200)
        queries = cfg.decoder.num_proposals * cfg.decoder.total_stages
        dim = 9 if cfg.decoder.with_vel else 7
        assert dec["bboxes"].shape == (1, queries, dim)
        assert torch.isfinite(dec["bboxes"]).all()
        assert torch.isfinite(dec["scores"]).all()
        assert 0 < int(dec["mask"].sum()) <= 200
    assert _kernel_launches() == _eval_launches(engine, len(seeds))


@pytest.mark.parametrize("name,engine", [
    ("DeformFormer3D_L", "cuda"), ("DeformFormer3D_L", "cuda_mxu"),
    ("DeformFormer3D_L", "cuda_zrun"), ("DeformFormer3D_L_dynamic", "cuda")])
def test_deformformer3d_l_scan_on_card(dev, name, engine):
    """DeformFormer3D_L (the single-stage head) and _dynamic (dynamic
    voxelization) on one radial 200k-point scan per engine
    (``_scans_on_card``)."""
    _scans_on_card(dev, name, engine, 200000, (0,))


@pytest.mark.parametrize("name,engine", [
    ("FocalFormer3D_Waymo_L", "cuda"), ("FocalFormer3D_Waymo_L", "cuda_mxu"),
    ("FocalFormer3D_Waymo_L", "cuda_zrun"),
    ("FocalFormer3D_Waymo15_L", "cuda_mxu"),
    ("DeformFormer3D_Waymo_L", "cuda_mxu")])
def test_waymo_configs_on_card(dev, name, engine):
    """The Waymo configs (the HardVFE, the 1536 x 1536 grid; _Waymo15_L's
    class-aware heads; DeformFormer3D_Waymo_L's single stage) on three
    radial 180k-point frames in turn (``_scans_on_card``): 7-value
    boxes."""
    _scans_on_card(dev, name, engine, 180000, (0, 1, 2))


def test_tta_merge_on_card_matches_cpu(dev):
    """4 passes x 600 candidates (the test CLI's merge for FocalFormer3D_L)
    merged on the card and on the CPU: mask, labels and scores equal, boxes
    within 1e-5 of each value's magnitude; the seeded candidates have no
    valid pair within 1e-5 of an IoU threshold (asserted first)."""
    from focalformer3d_tpu_torch.core import merge_augs as ma

    rng = np.random.RandomState(8)
    n, objects = 600, 150
    obj = np.zeros((objects, 9), np.float32)
    obj[:, :2] = rng.uniform(-50, 50, (objects, 2))
    obj[:, 2] = rng.uniform(-2, 0, objects)
    obj[:, 3:6] = rng.uniform(0.5, 5.0, (objects, 3))
    obj[:, 6] = rng.uniform(-np.pi, np.pi, objects)
    obj[:, 7:9] = rng.uniform(-3, 3, (objects, 2))
    boxes = obj[rng.randint(0, objects, (4, n))]
    boxes[..., :2] += rng.normal(0, 0.2, (4, n, 2))
    boxes[..., 6] += rng.normal(0, 0.05, (4, n))
    boxes = boxes.astype(np.float32)
    scores = rng.uniform(0.01, 1, (4, n)).astype(np.float32)
    labels = rng.randint(0, 10, (4, n)).astype(np.int32)
    valid = np.zeros((4, n), bool)
    valid[:, :200] = True  # the eval step keeps max_out 200 of each pass
    cfg = ma.TTAConfig(num_classes=10)
    assert _decided((boxes.reshape(-1, 9), scores.reshape(-1),
                     labels.reshape(-1), valid.reshape(-1)), cfg)
    cpu = [torch.from_numpy(x) for x in (boxes, scores, labels, valid)]
    ref = ma.merge_aug_boxes(cfg, *cpu)
    got = ma.merge_aug_boxes(cfg, *(x.to(dev) for x in cpu))
    for k in ("mask", "labels", "scores"):
        assert torch.equal(got[k].cpu(), ref[k]), k
    err = (got["bboxes"].cpu() - ref["bboxes"]).abs() \
        / ref["bboxes"].abs().clamp(min=1)
    assert float(err.max()) <= 1e-5
    assert 150 <= int(ref["mask"].sum()) <= 500


def test_deformformer3d_cli_entry_points_on_card(tmp_path, dev):
    """The train CLI (``--synthetic``, one step) and the benchmark CLI
    (two scans on ``cuda``) on DeformFormer3D_L, on the card."""
    from focalformer3d_tpu_torch.tools import benchmark
    from focalformer3d_tpu_torch.tools import train as train_cli

    k1.reset_launch_count()
    run = train_cli.main(["DeformFormer3D_L", "--synthetic", "--epochs", "1",
                          "--iters-per-epoch", "1", "--batch-size", "2",
                          "--work-dir", str(tmp_path / "w"),
                          "--no-tensorboard"])
    assert run.opt_state.count == 1
    assert (k1.launch_count("forward"), k1.launch_count("dx"),
            k1.launch_count("wgrad")) == (16, 15, 16)
    with open(tmp_path / "w" / "train_log.jsonl") as f:
        recs = [json.loads(x) for x in f]
    assert np.isfinite([r["loss"] for r in recs if r["mode"] == "train"]) \
        .all()
    benchmark.main(["DeformFormer3D_L", "--engines", "cuda", "--samples",
                    "2", "--warmup", "1", "--big-batch", "0"])


# ---------------------------------------------------------------------------
# the camera path (FocalFormer3D_LC, DeformFormer3D_C_R50)
# ---------------------------------------------------------------------------

def _camera_batch(cfg, seed, n_points, device="cpu"):
    b = synthetic.make_batch(
        np.random.RandomState(seed), batch_size=1, n_points=n_points,
        n_boxes=6, max_gts=8, num_classes=cfg.decoder.num_classes,
        pc_range=cfg.voxel.point_cloud_range, mode="radial",
        with_images=True, img_hw=cfg.lss.img_scale)
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


def _camera_run(cfg, model, batch):
    vox = (tdet.preprocess_points(cfg, batch["points"], batch["points_mask"])
           if cfg.input_pts else None)
    img = {k: batch[k] for k in ("imgs", "lidar2img", "img_aug", "bev_aug")}
    with torch.no_grad():
        return model(vox, img_data=img)


@pytest.mark.parametrize("make,block", [
    ("_tiny_lc", "imgpts_neck.cam_lss"),
    ("_tiny_lc_proj", "imgpts_neck.fusion_blocks.0.I2P_block")])
def test_tiny_lc_on_card_matches_cpu_plain(dev, make, block):
    """The tiny LC and LC_Proj models (``tests/test_torch_camera_cli.py``,
    float32) on engine ``cuda`` against the same weights on the CPU's
    plain engine: the camera block's output (the LSS BEV; I2P's decorated
    LiDAR map) within 1e-4 (float32 throughout; ``index_add_`` in atomic
    order, I2P's grid and projection in float64), the head outputs within
    1e-2 of scale (K1's bf16 operands, as the Tiny_L slice)."""
    import test_torch_camera_cli

    cfg = getattr(test_torch_camera_cli, make)()["model"]
    cpu_cfg = dataclasses.replace(cfg, sparse_engine="plain")
    ref_m = tdet.FocalFormer3D(cpu_cfg).eval()
    ref_m.load_state_dict(make_fake_state_dict(ref_m, 0), strict=True)
    m = tdet.FocalFormer3D(dataclasses.replace(cfg, sparse_engine="cuda"))
    m.load_state_dict(ref_m.state_dict(), strict=True)
    m = m.eval().to(dev)
    bevs = {}
    for name, mod in (("cpu", ref_m), ("card", m)):
        mod.get_submodule(block).register_forward_hook(
            lambda _m, a, out, name=name: bevs.update(
                {name: out[0] if isinstance(out, tuple) else out}))
    batch = _camera_batch(cfg, 0, 3000)
    ref = _camera_run(cpu_cfg, ref_m, batch)
    got = _camera_run(m.cfg, m, {k: v.to(dev) for k, v in batch.items()})
    err = float((bevs["card"].cpu() - bevs["cpu"]).abs().max()
                / bevs["cpu"].abs().max())
    assert err <= 1e-4, err
    for k in ("center", "height", "dim", "rot", "vel", "heatmap",
              "dense_heatmap"):
        r = ref[k].float()
        e = float((got[k].float().cpu() - r).abs().max()
                  / r.abs().max().clamp(min=1e-3))
        assert e <= 1e-2, (k, e)


@pytest.mark.parametrize("engine", ["cuda", "cuda_mxu", "cuda_zrun"])
def test_lc_launches_equal_the_lidar_models(dev, engine):
    """FocalFormer3D_LC and _LC_Proj at full width (bf16, one radial
    200k-point scan and its six 448 x 800 cameras) launch per scan exactly
    what FocalFormer3D_L launches on the same scan, its point branch:
    ``LAUNCHES_PER_SCAN``; finite boxes, 200 kept."""
    from focalformer3d_tpu_torch.configs import with_compute_dtype

    counts = {}
    for name in ("FocalFormer3D_L", "FocalFormer3D_LC",
                 "FocalFormer3D_LC_Proj"):
        cfg = with_compute_dtype(dataclasses.replace(
            get_config(name)["model"], sparse_engine=engine), "bfloat16")
        m = tdet.FocalFormer3D(cfg).eval()
        m.load_state_dict(make_fake_state_dict(m, 0), strict=True)
        m = m.to(dev)
        batch = _camera_batch(cfg, 0, 200000, dev)
        for k in (k1, k2, k3):
            k.reset_launch_count()
        out = _camera_run(cfg, m, batch)
        counts[name] = (k1.launch_count(), k2.launch_count(),
                        k3.launch_count())
        dec = m.get_bboxes(out, 200)
        assert torch.isfinite(dec["bboxes"]).all()
        assert int(dec["mask"].sum()) == 200
        del m, out
        torch.cuda.empty_cache()
    assert set(counts.values()) == {LAUNCHES_PER_SCAN[engine]}


def test_camera_only_launches_no_kernel(dev):
    """DeformFormer3D_C_R50 at full width on the card: no K1, K2 or K3
    launch; finite boxes; the outputs depend on the images."""
    from focalformer3d_tpu_torch.configs import with_compute_dtype

    cfg = with_compute_dtype(get_config("DeformFormer3D_C_R50")["model"],
                             "bfloat16")
    m = tdet.FocalFormer3D(cfg).eval()
    m.load_state_dict(make_fake_state_dict(m, 0), strict=True)
    m = m.to(dev)
    batch = _camera_batch(cfg, 1, 30000, dev)
    for k in (k1, k2, k3):
        k.reset_launch_count()
    out = _camera_run(cfg, m, batch)
    dark = _camera_run(cfg, m, dict(batch, imgs=torch.zeros_like(
        batch["imgs"])))
    assert (k1.launch_count(), k2.launch_count(), k3.launch_count()) == \
        (0, 0, 0)
    dec = m.get_bboxes(out, 200)
    assert torch.isfinite(dec["bboxes"]).all()
    assert not torch.equal(out["dense_heatmap"], dark["dense_heatmap"])


# ---------------------------------------------------------------------------
# training on the kernel engines: dW at L3 and conv_out widths, K3 with a
# gradient, one full-width step per engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("geom", ["subm", "conv_out"])
def test_wgrad_at_l3_and_conv_out_widths(dev, geom):
    """dW at (128, 128), the widths ``cuda_mxu`` training gives it at L3
    (K = 27) and conv_out (K = 3), on real rulebooks: within 1e-3 of
    ``wgrad_plain``, two runs equal bit for bit, one launch each."""
    coords, valid = _voxels(4)
    rules, ov = _rules(coords.to(dev), valid.to(dev), geom)
    K = rules.shape[0]
    assert K == (27 if geom == "subm" else 3)
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    x = torch.where(valid.to(dev)[:, None], torch.randn(
        coords.shape[0], 128, device=dev, generator=g), 0.0)[None]
    cot = torch.where(ov[:, None], torch.randn(
        rules.shape[1], 128, device=dev, generator=g), 0.0)[None]
    xb = x.bfloat16()
    n0 = k1.launch_count("wgrad")
    dw = k1.conv_wgrad(xb, cot, rules[None])
    again = k1.conv_wgrad(xb, cot, rules[None])
    torch.cuda.synchronize()
    assert k1.launch_count("wgrad") == n0 + 2
    assert dw.shape == (K, 128, 128)
    assert _rel(dw, k1.wgrad_plain(xb, cot, rules[None])) <= 1e-3
    assert torch.equal(dw, again)


@pytest.mark.parametrize("geom", list(GEOMS))
@pytest.mark.parametrize("cin,cout", [(16, 16), (64, 128), (128, 128)])
def test_zrun_conv_train_vs_plain(dev, geom, cin, cout):
    """``zrun_conv_train`` (K3 forward, K1's dx and the dW kernel on the
    rulebook the codes encode) against autograd through
    ``apply_conv_bf16_plain`` on ``zrun_rules``: output, dx and dW within
    1e-3 of scale; one K3, dx and dW launch each."""
    coords, valid = _voxels(8)
    coords, valid = coords.to(dev), valid.to(dev)
    table = tsc.build_table_csr(coords, valid, SHAPE)
    if GEOMS[geom] is None:
        ks, st, pad = 3, 1, 1
        oc, ov = coords, valid
    else:
        ks, st, pad = GEOMS[geom]
        oc, ov = tsc.build_downsample(coords, valid, SHAPE, ks, st, pad,
                                      4000)[:2]
    codes = tzr.build_zplan(table, SHAPE, oc, ov, ks, st, pad)[None]
    v_in = coords.shape[0]
    rules, rules_t = backward_index(codes, v_in, "cuda_zrun", st != 1)
    g = torch.Generator(device=dev)
    g.manual_seed(9)
    x = torch.where(valid[:, None], torch.randn(v_in, cin, device=dev,
                                                generator=g), 0.0)[None]
    w = torch.randn(rules.shape[1], cin, cout, device=dev, generator=g) * 0.2
    cot = torch.randn(1, ov.shape[0], cout, device=dev, generator=g)
    res = {}
    for tag in ("kernel", "plain"):
        xx = x.clone().requires_grad_(True)
        ww = w.clone().requires_grad_(True)
        n0 = (k3.launch_count(), k1.launch_count("dx"),
              k1.launch_count("wgrad"))
        with torch.enable_grad():
            if tag == "kernel":
                y = k3.zrun_conv_train(xx, codes, rules, rules_t, ww,
                                       ov[None])
            else:
                y = k1.apply_conv_bf16_plain(xx, rules, ww, ov[None])
            y.backward(cot)
        torch.cuda.synchronize()
        n = (k3.launch_count() - n0[0], k1.launch_count("dx") - n0[1],
             k1.launch_count("wgrad") - n0[2])
        assert n == ((1, 1, 1) if tag == "kernel" else (0, 0, 0))
        res[tag] = (y.detach(), xx.grad, ww.grad)
    for name, got, ref in zip(("out", "dx", "dW"), res["kernel"],
                              res["plain"]):
        assert _rel(got, ref) <= 1e-3, name
    assert torch.all(res["kernel"][1][0][~valid] == 0)


@pytest.mark.parametrize("engine", ENGINES)
def test_full_width_train_step_per_engine(dev, engine):
    """One float32 FocalFormer3D_L training step at batch 2 on two radial
    200k-point scans on each kernel engine: finite losses, every parameter
    and batch-norm running mean moved, and the launches of
    ``train_step``'s accounting exactly (``STEP_LAUNCHES``; a new model's
    first step builds its index eagerly, block by block; a training head
    always runs eagerly, its 7 blocks)."""
    from focalformer3d_tpu_torch.training import optim

    all_cfg = get_config("FocalFormer3D_L")
    cfg = dataclasses.replace(all_cfg["model"], sparse_engine=engine)
    batch = synthetic.make_batch(
        np.random.RandomState(10), batch_size=2, n_points=200000,
        n_boxes=24, max_gts=32, num_classes=cfg.decoder.num_classes,
        pc_range=cfg.voxel.point_cloud_range, mode="radial")
    m = tdet.FocalFormer3D(cfg)
    m.load_state_dict(make_fake_state_dict(m, 0), strict=True)
    m = m.to(dev)
    before = {k: v.detach().clone() for k, v in m.state_dict().items()}
    tx = optim.make_optimizer(total_steps=10)
    state = tx.init(m.named_parameters())
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    train_step.reset_kernel_launches()
    met = train_step.make_train_step(cfg, all_cfg["loss"], tx)(m, state, b,
                                                               gen)
    torch.cuda.synchronize()
    assert train_step.kernel_launches() == {
        **STEP_LAUNCHES[engine], "index_graph_replay": 0,
        "index_graph_capture": 0, "index_eager": INDEX_BLOCKS[engine][1],
        "decoder_graph_replay": 0, "decoder_graph_capture": 0,
        "decoder_eager": 7}
    assert all(np.isfinite(float(v)) for v in met.values())
    after = m.state_dict()
    still = [k for k in [n for n, _ in m.named_parameters()]
             + [n for n in after if n.endswith("running_mean")]
             if torch.equal(after[k], before[k])]
    assert not still, still[:5]
    del m, state, b
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Waymo: hard voxelization, the HardVFE and the test CLI
# ---------------------------------------------------------------------------

def test_hard_voxelize_and_hard_vfe_on_card_match_cpu(dev):
    """``hard_voxelize`` at Tiny_Waymo_L's caps (a 4000-point radial scan
    overflows its 512 voxels and 5 point slots) on the card equals the
    CPU bit for bit; the HardVFE on the card is within 1e-5 of the CPU's
    scale, in eval and in a training call (its running statistics too)."""
    from focalformer3d_tpu_torch.models.vfe import HardVFE
    from focalformer3d_tpu_torch.ops.voxelize import hard_voxelize

    cfg = get_config("Tiny_Waymo_L")["model"]
    pts, mask = _radial(cfg, 4, 4000)
    got = hard_voxelize(cfg.voxel, pts[0].to(dev), mask[0].to(dev))
    ref = hard_voxelize(cfg.voxel, pts[0], mask[0])
    for k, v in ref.items():
        assert torch.equal(got[k].cpu(), v), k
    assert int(ref["voxel_mask"].sum()) == 512 and int(
        ref["num_points"].max()) == 5
    vfe = HardVFE(5, (64,))
    vfe.load_state_dict({k: torch.from_numpy(v.numpy()) for k, v in
                         make_fake_state_dict(vfe, 2).items()}, strict=True)
    card = HardVFE(5, (64,)).to(dev)
    card.load_state_dict(vfe.state_dict())
    for train in (False, True):
        vfe.train(train)
        card.train(train)
        want = vfe(ref["voxels"][None], ref["num_points"][None])
        out = card(got["voxels"][None], got["num_points"][None])
        assert float((out.cpu() - want).abs().max()
                     / want.abs().max()) <= 1e-5, train
    for k in ("running_mean", "running_var"):
        a = getattr(card.vfe_layers[0].norm, k).cpu()
        b = getattr(vfe.vfe_layers[0].norm, k)
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-5, k


def test_test_cli_on_a_waymo_directory_matches_cpu(dev, tmp_path):
    """The test CLI (Tiny_Waymo_L, random weights from a seed) on a
    directory of ``synthetic_dirs.write_waymo``: engine ``cuda`` on the card
    (K1, 11 launches a frame) against ``--device cpu`` on the plain
    engine, the best 50 boxes of each frame (all 32 that Tiny_Waymo_L
    keeps) within 1e-2 (``_top_boxes_close``, as for Tiny_L), the same
    ground truth with its LEVEL_2-only flags, and finite L1 / L2 metrics."""
    from focalformer3d_tpu_torch.tools import test as test_cli

    cfg_all = get_config("Tiny_Waymo_L")
    synthetic_dirs.write_waymo(
        tmp_path, seed=3, frames=2, points=3000,
        pc_range=cfg_all["model"].voxel.point_cloud_range,
        classes=cfg_all["class_names"], boxes=6)
    runs = {}
    for device, engine in (("cuda", "cuda"), ("cpu", "plain")):
        k1.reset_launch_count()
        runs[device] = test_cli.main([
            "Tiny_Waymo_L", "--data-root", str(tmp_path), "--device",
            device, "--engine", engine, "--limit", "2", "--max-points",
            "6000", "--seed", "3"])
        assert k1.launch_count() == (22 if device == "cuda" else 0)
        assert all(np.isfinite(v) for v in runs[device].metrics.values())
    assert set(runs["cuda"].predictions) == set(runs["cpu"].predictions)
    for tok, ref in runs["cpu"].predictions.items():
        assert len(ref["scores"]) >= 30 and ref["boxes"].shape[1] == 7
        _top_boxes_close(runs["cuda"].predictions[tok], ref)
        g, h = runs["cuda"].ground_truth[tok], runs["cpu"].ground_truth[tok]
        assert set(g) == set(h) == {"boxes", "labels", "l2_only"}
        for k in g:
            np.testing.assert_array_equal(g[k], h[k])


def test_two_rank_step_on_one_card_matches_world_size_1(dev, tmp_path):
    """Data parallel on the card: two ``tools/dryrun_ddp`` workers over
    gloo, both on this card, each a Tiny_L step at batch 1 on engine
    ``plain`` (float32: the batch statistics' and gradients' all-reduces
    on CUDA tensors, SyncBN's backward), against this process's
    world-size-1 step at batch 2, tensor by tensor at
    ``tests/test_torch_train_step.py``'s tolerances
    (``dryrun_ddp.compare``); the ranks end with the same parameters bit
    for bit. ``test_full_width_two_rank_step_holds_the_floor`` runs
    ``plain`` and the kernel engines at full width, where a change of the
    sums' order alone flips bf16 roundings and top-k picks, against the
    reversed batch's floor."""
    from focalformer3d_tpu_torch.tools import dryrun_ddp as dd

    cfg = get_config("Tiny_L")["model"]
    inputs = dd.step_inputs(cfg, seed=5, batch_size=2, n_points=2000,
                            n_boxes=4, max_gts=8, mode="radial")
    np.savez(tmp_path / "inputs.npz", **inputs)
    torch.cuda.empty_cache()
    dd.spawn(2, ["--init-method", f"file://{tmp_path}/rendezvous",
                 "--device", "cuda:0", "--config", "Tiny_L", "--engines",
                 "plain", "--inputs", str(tmp_path / "inputs.npz"),
                 "--weights-seed", "4", "--out", str(tmp_path)], 600,
             str(tmp_path))
    ranks = [torch.load(dd.result_path(str(tmp_path), "plain", r),
                        weights_only=True) for r in range(2)]
    ws1 = dd.one_step("Tiny_L", "plain", inputs, 4, dev)
    report = dd.compare(ranks[0], ws1)
    assert report["ok"], report
    assert ranks[0]["collectives"]["grad"] == 1
    for k in ranks[0]["state"]:
        assert torch.equal(ranks[0]["state"][k], ranks[1]["state"][k]), k


# ---------------------------------------------------------------------------
# the index build as CUDA graph replays (models/sparse_encoder.IndexGraphs)
# at the FocalFormer3D_L geometry
# ---------------------------------------------------------------------------

# index-build blocks a forward, (eval, training), per engine
INDEX_BLOCKS = {"cuda": (4, 6), "cuda_mxu": (8, 8), "cuda_zrun": (4, 6)}
# ``index_downsample`` calls a forward, (eval, training), per engine
INDEX_LAUNCHES = {"cuda": (2, 3), "cuda_mxu": (0, 0), "cuda_zrun": (2, 3)}


def _l_encoder(dev, engine, train):
    from focalformer3d_tpu_torch.models.sparse_encoder import SparseEncoder

    cfg = get_config("FocalFormer3D_L")["model"]
    assert cfg.sparse_shape == (41, 1440, 1440)
    assert cfg.capacities == (160000, 245760, 188416, 77824)
    enc = SparseEncoder(
        in_channels=cfg.voxel_feature_dim, sparse_shape=cfg.sparse_shape,
        output_channels=cfg.sparse_out_channels,
        encoder_channels=cfg.encoder_channels,
        down_paddings=cfg.down_paddings, capacities=cfg.capacities,
        out_capacity=cfg.out_capacity, engine=engine,
        dense_from=cfg.sparse_dense_from_eval,
        train_dense_from=cfg.sparse_dense_from)
    return cfg, enc.to(dev).train(train)


def _l_voxels(cfg, dev, seed, batch_size, train):
    batch = synthetic.make_batch(
        np.random.RandomState(seed), batch_size=batch_size,
        n_points=200000, n_boxes=12, max_gts=16,
        num_classes=cfg.decoder.num_classes,
        pc_range=cfg.voxel.point_cloud_range, mode="radial")
    return tdet.preprocess_points(
        cfg, torch.from_numpy(batch["points"]).to(dev),
        torch.from_numpy(batch["points_mask"]).to(dev), train=train)


def _block_tensors(blocks):
    """Copies of every tensor the index build's blocks yield: each level's
    valid, meta and sites, each index and each backward index."""
    out = []
    for lvl, index, bwd in blocks:
        out += [lvl.valid, lvl.meta, lvl.sites(), index, *(bwd or ())]
    return [t.clone() for t in out]


def _assert_same(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and torch.equal(g, w), i


@pytest.mark.parametrize("engine,train,batch_size", [
    ("cuda", False, 1), ("cuda", False, 4), ("cuda", True, 2),
    ("cuda_mxu", False, 1), ("cuda_mxu", True, 2),
    ("cuda_zrun", False, 1), ("cuda_zrun", True, 2)])
def test_index_graph_replays_equal_the_eager_build(dev, engine, train,
                                                   batch_size):
    """Two different scans, each of ``batch_size`` 200k-point sweeps, in
    turn: the first call builds the index eagerly, the second captures it,
    every later one replays it; each call's metas, sites, valid flags,
    rulebooks (z-run codes) and, in training, transposed rulebooks equal
    the eager build of its own scan bit for bit (a replay on stale inputs
    would give the other scan's). The counters read one forward's blocks
    a call, K2 one launch a block (none on ``cuda_zrun``), the index build
    one table a call and its downsamples (``INDEX_LAUNCHES``)."""
    from focalformer3d_tpu_torch.models.sparse_encoder import INDEX_BLOCKS \
        as counts

    cfg, enc = _l_encoder(dev, engine, train)
    scans = [_l_voxels(cfg, dev, seed, batch_size, train) for seed in (0, 1)]
    want = [_block_tensors(enc._index_build(v["coords"], v["voxel_mask"],
                                            engine)) for v in scans]
    n = INDEX_BLOCKS[engine][train]
    assert len(want[0]) == len(want[1]) and n == len(
        enc._index_specs(engine == "cuda_mxu"))
    counts.reset()
    k2.reset_launch_count()
    for call in range(4):
        v = scans[call % 2]
        blocks, replayed = enc._index_blocks(v["coords"], v["voxel_mask"],
                                             engine)
        assert replayed == (call > 0)
        _assert_same(_block_tensors(blocks), want[call % 2])
    torch.cuda.synchronize()
    assert counts.counts == {"index_eager": n, "index_graph_capture": n,
                             "index_graph_replay": 3 * n}
    assert k2.launch_count() == (0 if engine == "cuda_zrun" else 4 * n)
    assert k2.launch_count("table") == 4
    assert k2.launch_count("downsample") == 4 * INDEX_LAUNCHES[engine][train]


def test_levels_of_a_replay_outlive_the_next_replay(dev):
    """A forward's ``levels=`` on a replayed index build are copies: a
    replay on another scan leaves them as the eager forward's, and the
    BEV of a replay equals the eager forward's bit for bit."""
    cfg, enc = _l_encoder(dev, "cuda", False)
    enc.load_state_dict(make_fake_state_dict(enc, 2), strict=True)
    scans = [_l_voxels(cfg, dev, seed, 1, False) for seed in (2, 3)]
    a, b = ((v["features"], v["coords"], v["voxel_mask"]) for v in scans)
    with torch.no_grad():
        eager_levels, got_levels = [], []
        bev = enc(*a, levels=eager_levels)
        enc(*b)
        bev_replayed = enc(*a, levels=got_levels)
        enc(*b)
        enc(*b)
    assert torch.equal(bev_replayed, bev)
    assert len(got_levels) == len(eager_levels) == 3
    for got, ref in zip(got_levels, eager_levels):
        assert got.shape == ref.shape
        _assert_same([got.valid, got.meta, got.coords],
                     [ref.valid, ref.meta, ref.coords])


@pytest.mark.parametrize("engine", ["cuda", "cuda_mxu", "cuda_zrun"])
@pytest.mark.parametrize("train", [False, True])
def test_index_build_never_syncs(dev, engine, train):
    """The index build reads no device value on the host: its eager run
    and its replay under ``set_sync_debug_mode("error")`` raise nothing
    (its capture, between them, would have failed on a sync)."""
    cfg, enc = _l_encoder(dev, engine, train)
    v = _l_voxels(cfg, dev, 4, 2 if train else 1, train)
    for call in range(3):
        if call != 1:
            torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in enc._index_blocks(v["coords"], v["voxel_mask"],
                                       engine)[0]:
                pass
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_index_graph_counters_per_step_and_scan(dev):
    """``train_step.kernel_launches``' index counters on FocalFormer3D_L:
    three training steps at batch 2 (eager 6, then capture and replay 6,
    then replay 6), then three eval scans (eager 4, capture and replay 4,
    replay 4); a step's or scan's kernel launches stay as many whether its
    index build runs eagerly or replays. The head's counters: eager 7 a
    training step, and at eval eager 7, then capture and replay 7, then
    replay 7."""
    from focalformer3d_tpu_torch.training import optim

    all_cfg = get_config("FocalFormer3D_L")
    cfg = all_cfg["model"]
    m = tdet.FocalFormer3D(cfg)
    m.load_state_dict(make_fake_state_dict(m, 0), strict=True)
    m = m.to(dev)
    tx = optim.make_optimizer(total_steps=10)
    state = tx.init(m.named_parameters())
    step = train_step.make_train_step(cfg, all_cfg["loss"], tx)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    batch = synthetic.make_batch(
        np.random.RandomState(12), batch_size=2, n_points=200000,
        n_boxes=24, max_gts=32, num_classes=cfg.decoder.num_classes,
        pc_range=cfg.voxel.point_cloud_range, mode="radial")
    b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}

    head = ("decoder_eager", "decoder_graph_capture", "decoder_graph_replay")

    def index_counts(run):
        train_step.reset_kernel_launches()
        run()
        torch.cuda.synchronize()
        got = train_step.kernel_launches()
        heads.append(tuple(got.pop(k) for k in head))
        return ({k: got.pop(k) for k in ("index_eager",
                                         "index_graph_capture",
                                         "index_graph_replay")}, got)

    heads = []
    steps = [index_counts(lambda: step(m, state, b, gen)) for _ in range(3)]
    assert [c for c, _ in steps] == [
        {"index_eager": 6, "index_graph_capture": 0, "index_graph_replay": 0},
        {"index_eager": 0, "index_graph_capture": 6, "index_graph_replay": 6},
        {"index_eager": 0, "index_graph_capture": 0, "index_graph_replay": 6}]
    assert steps[0][1] == steps[1][1] == steps[2][1]
    assert heads == [(7, 0, 0)] * 3
    m.eval()
    pts, mask = (x.to(dev) for x in _radial(cfg, 5, 200000))
    with torch.no_grad():
        scans = [index_counts(lambda: m.get_bboxes(m(tdet.preprocess_points(
            cfg, pts, mask)), 200)) for _ in range(3)]
    assert [c for c, _ in scans] == [
        {"index_eager": 4, "index_graph_capture": 0, "index_graph_replay": 0},
        {"index_eager": 0, "index_graph_capture": 4, "index_graph_replay": 4},
        {"index_eager": 0, "index_graph_capture": 0, "index_graph_replay": 4}]
    assert scans[0][1] == scans[1][1] == scans[2][1]
    assert heads[3:] == [(7, 0, 0), (0, 7, 7), (0, 0, 7)]
    del m, state, b
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the eval head as CUDA graph replays (models/focal_decoder._block_runs) at
# the published widths
# ---------------------------------------------------------------------------

def _head_inputs(dev, name, batch_size, seeds=(0, 1), **delta):
    """The bf16 detector ``name`` (its decoder's fields changed by
    ``delta``) on the card with seeded weights, its head's graphs dropped,
    and the head's arguments on radial 200k-point scans, ``batch_size`` a
    call, one call a seed: (head, [(lidar_feat, stage_feats)])."""
    from focalformer3d_tpu_torch.configs import with_compute_dtype

    base = get_config(name)["model"]
    cfg = with_compute_dtype(dataclasses.replace(
        base, decoder=dataclasses.replace(base.decoder, **delta)),
        "bfloat16")
    m = tdet.FocalFormer3D(cfg).eval()
    m.load_state_dict(make_fake_state_dict(m, 0), strict=True)
    m = m.to(dev)
    head = m.pts_bbox_head
    args = []
    hook = head.register_forward_pre_hook(lambda mod, a: args.append(
        (a[0].clone(), [t.clone() for t in a[1]])))
    with torch.no_grad():
        for seed in seeds:
            batch = synthetic.make_batch(
                np.random.RandomState(seed), batch_size=batch_size,
                n_points=200000, n_boxes=12, max_gts=16,
                num_classes=cfg.decoder.num_classes,
                pc_range=cfg.voxel.point_cloud_range, mode="radial")
            m(tdet.preprocess_points(
                cfg, torch.from_numpy(batch["points"]).to(dev),
                torch.from_numpy(batch["points_mask"]).to(dev)))
    hook.remove()
    head._graphs.clear()
    return head, args


def _eager_head(head, lidar_feat, stage_feats):
    """The head's blocks run through eagerly, past its graphs: copies of
    the output dict."""
    with torch.no_grad():
        out = list(head._blocks(lidar_feat, head._maps(stage_feats), None,
                                None, None, None))[-1]
    return {k: v.clone() for k, v in out.items()}


def _assert_same_dict(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def _head_counts():
    from focalformer3d_tpu_torch.models.focal_decoder import DECODER_BLOCKS

    torch.cuda.synchronize()
    return dict(DECODER_BLOCKS.counts)


@pytest.mark.parametrize("name,batch_size,n", [
    ("FocalFormer3D_L", 1, 7), ("FocalFormer3D_L", 4, 7),
    ("FocalFormer3D_Waymo_L", 1, 8)])
def test_head_replays_equal_the_eager_head(dev, name, batch_size, n):
    """Two scans' head inputs in turn, four calls: the first runs eagerly,
    the second captures (a graph a block of ``_block_spans``), the others
    replay. Every returned dict equals the eager head's on its own inputs
    bit for bit, read after the last call: a replay on stale inputs would
    give the other scan's, and a dict left in the graphs' pool would hold
    the last call's. The counters read one forward's blocks a call; a
    replay launches no model-path kernel."""
    from focalformer3d_tpu_torch.models.focal_decoder import DECODER_BLOCKS

    head, args = _head_inputs(dev, name, batch_size)
    assert len(head._block_spans()) == n
    want = [_eager_head(head, *a) for a in args]
    assert not torch.equal(want[0]["dense_heatmap"], want[1]["dense_heatmap"])
    train_step.reset_kernel_launches()
    outs = []
    with torch.no_grad():
        for call in range(4):
            outs.append(head(*args[call % 2]))
    assert _head_counts() == {"decoder_eager": n, "decoder_graph_capture": n,
                              "decoder_graph_replay": 3 * n}
    got = train_step.kernel_launches()
    assert all(got[k] == 0 for k in got if k not in DECODER_BLOCKS.counts)
    for call, out in enumerate(outs):
        _assert_same_dict(out, want[call % 2])
        assert out["dense_heatmap"].shape[:2] == (batch_size,
                                                  head.cfg.total_stages)


def test_head_replay_reads_the_loaded_weights(dev):
    """FocalFormer3D_L's head, captured, then ``load_state_dict`` of other
    weights: the next call replays (the graphs read the parameters in
    place) and equals the eager head on the new weights bit for bit."""
    head, args = _head_inputs(dev, "FocalFormer3D_L", 1, seeds=(0,))
    with torch.no_grad():
        for _ in range(2):
            old = head(*args[0])
    head.load_state_dict(make_fake_state_dict(head, 5), strict=True)
    want = _eager_head(head, *args[0])
    n = len(head._block_spans())
    before = _head_counts()
    with torch.no_grad():
        got = head(*args[0])
    after = _head_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "decoder_eager": 0, "decoder_graph_capture": 0,
        "decoder_graph_replay": n}
    _assert_same_dict(got, want)
    assert not torch.equal(got["dense_heatmap"], old["dense_heatmap"])


def test_head_in_training_or_with_grad_stays_eager(dev):
    """A captured head runs eagerly with grad enabled, with the GT given,
    and in training mode (``decoder_eager`` counts their blocks); at eval
    without grad it replays again."""
    head, args = _head_inputs(dev, "FocalFormer3D_L", 1, seeds=(0,))
    lidar_feat, stage_feats = args[0]
    n = len(head._block_spans())
    B = lidar_feat.shape[0]
    gt = (torch.zeros((B, 4, 9), device=dev),
          torch.zeros((B, 4), dtype=torch.int32, device=dev),
          torch.zeros((B, 4), dtype=torch.bool, device=dev))
    with torch.no_grad():
        for _ in range(2):
            head(lidar_feat, stage_feats)
    before = _head_counts()
    out = head(lidar_feat, stage_feats)
    assert out["heatmap"].requires_grad
    with torch.no_grad():
        head(lidar_feat, stage_feats, *gt)
        head.train()
        try:
            head(lidar_feat, stage_feats)
        finally:
            head.eval()
        head(lidar_feat, stage_feats)
    after = _head_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "decoder_eager": 3 * n, "decoder_graph_capture": 0,
        "decoder_graph_replay": n}


@pytest.mark.parametrize("name,delta", [
    ("FocalFormer3D_L", {}),
    ("FocalFormer3D_L", dict(mask_heatmap_mode="boxcls", heatmap_box=True)),
    ("FocalFormer3D_Waymo15_L", {})])
def test_head_never_syncs_and_each_mode_replays(dev, name, delta):
    """The eval head reads no device value on the host: its eager call and
    its replays under ``set_sync_debug_mode("error")`` raise nothing (the
    capture between them would have failed on a sync). The ``boxcls`` mask
    mode (its dense box heads and points-in-boxes masks) and
    ``classaware_reg`` (FocalFormer3D_Waymo15_L) capture too, and every
    call equals the eager head bit for bit."""
    head, args = _head_inputs(dev, name, 1, seeds=(0,), **delta)
    assert head.cfg.classaware_reg == (name == "FocalFormer3D_Waymo15_L")
    want = _eager_head(head, *args[0])
    n = len(head._block_spans())
    before = _head_counts()
    with torch.no_grad():
        for call in range(4):
            if call != 1:
                torch.cuda.set_sync_debug_mode("error")
            try:
                out = head(*args[0])
            finally:
                torch.cuda.set_sync_debug_mode(0)
            _assert_same_dict(out, want)
    after = _head_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "decoder_eager": n, "decoder_graph_capture": n,
        "decoder_graph_replay": 3 * n}


# ---------------------------------------------------------------------------
# the kernels at every conv of a full-size scan and training batch
# ---------------------------------------------------------------------------

def _full_scan(dev, name):
    """``name``'s bf16 config on engine ``cuda`` and the voxels of its
    radial scan (seed 0) at the benchmark's size (``FULL``)."""
    from focalformer3d_tpu_torch.configs import with_compute_dtype

    cfg = with_compute_dtype(dataclasses.replace(
        get_config(name)["model"], sparse_engine="cuda"), "bfloat16")
    return cfg, tdet.preprocess_points(
        cfg, *kt.radial_scan(cfg, 0, dev, FULL[name]))


@pytest.mark.parametrize("name", list(FULL))
def test_k2_rulebooks_at_every_conv_of_a_full_scan(dev, name):
    """K2's rulebooks at every conv of ``cuda_mxu``'s meta chain on a
    full-size radial scan (FocalFormer3D_L; _Waymo_L on its 1536 x 1536
    grid) equal ``decode_rules`` and ``build_conv_rules`` exactly."""
    cfg, vox = _full_scan(dev, name)
    for conv, src, dst, ks, st, pad in kt.walk(
            cfg, vox, True, len(cfg.encoder_channels)):
        args = (src.meta, dst.colz, src.capacity, ks, st, pad, src.shape,
                dst.shape[2])
        got = k2.plan_rules(*args)[0]
        table = tsc.VoxelTable(src.sites()[0], src.valid[0], src.meta[0])
        assert torch.equal(got, tpb.decode_rules(
            dst.colz[0], src.capacity, src.meta[0], *args[3:])), conv
        assert torch.equal(got, tsc.build_conv_rules(
            table, src.shape, dst.sites()[0], dst.valid[0], ks, st,
            pad)), conv


def _encoder(dev, name, train, **caps):
    """``name``'s sparse encoder on the card (engine ``cuda``; the index
    build takes the engine as an argument), at eval or in training."""
    from focalformer3d_tpu_torch.models.sparse_encoder import SparseEncoder

    cfg = dataclasses.replace(get_config(name)["model"], **caps)
    enc = SparseEncoder(
        in_channels=cfg.voxel_feature_dim, sparse_shape=cfg.sparse_shape,
        output_channels=cfg.sparse_out_channels,
        encoder_channels=cfg.encoder_channels,
        down_paddings=cfg.down_paddings, capacities=cfg.capacities,
        out_capacity=cfg.out_capacity, engine="cuda",
        dense_from=cfg.sparse_dense_from_eval,
        train_dense_from=cfg.sparse_dense_from)
    return cfg, enc.to(dev).train(train)


def _index_build_against_plain(enc, coords, valid):
    """The encoder's index build on ``cuda`` (the index kernels and K2)
    against ``plain``'s (the torch functions), both on the card, block by
    block: each level's valid flags, metas and sites, each rulebook and,
    in training, each transposed rulebook (``transpose_rules`` of the
    torch rulebook for a strided conv), bit for bit; and each downsample's
    overflow count against ``build_downsample``'s. Returns the launches of
    the ``cuda`` build and the overflow counts."""
    blocks = enc._index_specs(False)
    k2.reset_launch_count()
    got = list(enc._index_build(coords, valid, "cuda"))
    launches = {k: k2.launch_count(k) for k in ("rules", "table",
                                                 "downsample")}
    want = list(enc._index_build(coords, valid, "plain"))
    assert len(got) == len(want) == len(blocks)
    overflow = []
    src = want[0][0]
    for i, ((lg, ig, bg), (lw, iw, _)) in enumerate(zip(got, want)):
        assert lg.shape == lw.shape, i
        _assert_same([lg.valid, lg.meta, lg.coords, ig],
                     [lw.valid, lw.meta, lw.coords, iw])
        if bg is not None:
            tw = iw if blocks[i] is None else torch.stack(
                [tsc.transpose_rules(r, src.capacity) for r in iw])
            _assert_same(list(bg), [iw, tw])
        src = lw
    lvl = want[0][0]
    for ks, st, pad, cap in filter(None, blocks):
        out = k2.index_downsample(lvl.coords, lvl.valid, lvl.shape, ks, st,
                                  pad, cap)
        for b in range(lvl.valid.shape[0]):
            ref = tsc.build_downsample(lvl.coords[b], lvl.valid[b],
                                       lvl.shape, ks, st, pad, cap)
            assert torch.equal(out[3][b], ref[3])
        overflow.append(out[3])
        lvl = Level(out[2], out[1], out[4], coords=out[0])
    return launches, overflow


@pytest.mark.parametrize("name", list(FULL))
@pytest.mark.parametrize("train", [False, True])
def test_index_kernels_at_every_block_of_a_full_scan(dev, name, train):
    """The ``cuda`` engine's index build on the card (``index_table``,
    ``index_downsample``, K2 on the packed output sites) at every block of
    a full-size radial scan at eval (dense from L2, batch 1) and of a
    training batch of two (dense from L3; the training voxel cap) of
    FocalFormer3D_L and _Waymo_L (1536 x 1536) equals the torch functions
    bit for bit (``_index_build_against_plain``), with one table, a
    downsample a strided conv and K2 a block."""
    cfg, enc = _encoder(dev, name, train)
    if train:
        batch = kt.train_batch(cfg, dev, FULL[name])
        vox = tdet.preprocess_points(cfg, batch["points"],
                                     batch["points_mask"], train=True)
    else:
        vox = tdet.preprocess_points(cfg, *kt.radial_scan(cfg, 0, dev,
                                                          FULL[name]))
    launches, _ = _index_build_against_plain(enc, vox["coords"],
                                             vox["voxel_mask"])
    n = INDEX_BLOCKS["cuda"][train]
    assert launches == {"rules": n, "table": 1,
                        "downsample": INDEX_LAUNCHES["cuda"][train]}


def test_index_kernels_when_l1_overflows_its_capacity(dev):
    """FocalFormer3D_L at eval on a batch of two full-size scans with L1's
    capacity cut to 150 000 (each scan has some 240 000 L1 sites) and L2's
    to 40 000: both downsamples drop sites, and the kernels still equal
    the torch functions bit for bit, overflow counts included (the next
    level's meta keeps the dropped sites, its table the kept ones)."""
    cfg, enc = _encoder(dev, "FocalFormer3D_L", False,
                        capacities=(160000, 150000, 40000, 77824))
    batch = kt.train_batch(cfg, dev)
    vox = tdet.preprocess_points(cfg, batch["points"], batch["points_mask"])
    _, overflow = _index_build_against_plain(enc, vox["coords"],
                                             vox["voxel_mask"])
    assert all(bool((o > 0).all()) for o in overflow), overflow


@pytest.mark.parametrize("shape", [(41, 40, 36), (41, 200, 176),
                                   (64, 96, 80)])
def test_index_kernels_on_ragged_batches_and_grid_edges(dev, shape):
    """``index_table`` and ``index_downsample`` on the card against
    ``build_table_csr`` and ``build_downsample`` on the card, sample by
    sample, on a batch of four of different counts (one empty, one full)
    whose samples hold the grid's corners and a voxel on each face, at
    each strided geometry of the encoder, with a capacity that holds every
    output site and one that drops some: one tile of the scans (1 440
    columns) and many (35 200, 7 680, not multiples of a tile)."""
    from test_torch_index_kernels import DOWN_GEOMS, _batch

    D, H, W = shape
    cap = min(D * H * W // 4, 60000)
    counts = (cap // 2, 0, 37, cap)
    coords, valid = (t.to(dev) for t in _batch(counts, shape, cap))
    meta = k2.index_table(coords, valid, shape)
    for b in range(len(counts)):
        _assert_same([meta[b]], [tsc.build_table_csr(coords[b], valid[b],
                                                     shape).meta])
    for ks, st, pad in DOWN_GEOMS.values():
        out_shape = tsc.conv_out_shape(shape, ks, st, pad)
        for out_cap in (4 * cap, cap // 3):
            oc, ov, oshape, overflow, ometa = k2.index_downsample(
                coords, valid, shape, ks, st, pad, out_cap)
            assert oshape == out_shape
            for b in range(len(counts)):
                ref = tsc.build_downsample(coords[b], valid[b], shape, ks,
                                           st, pad, out_cap)
                _assert_same([oc[b], ov[b], overflow[b], ometa[b]],
                             [ref[0], ref[1], ref[3], ref[4]])
            assert bool(overflow[3] > 0) == (out_cap < cap), (ks, out_cap)


@pytest.mark.parametrize("name", list(FULL))
def test_k1_at_every_conv_of_a_full_scan(dev, name):
    """K1 at the convs of ``cuda`` (K2's rulebooks, L0-L1) and the
    four more of ``cuda_mxu`` (K2's rulebooks: L2, L3, conv_out) on a
    full-size radial scan, at the model's widths: within 1e-3 of the plain
    version's scale on production's route and on the other one (the phase
    probe in full mode); two runs equal bit for bit."""
    cfg, vox = _full_scan(dev, name)
    coord = kt.walk(cfg, vox, False, 2)
    mxu = kt.walk(cfg, vox, True, len(cfg.encoder_channels))
    jobs = [(c, coord, "cuda") for c in kt.convs(cfg, coord)]
    jobs += [(c, mxu, "cuda_mxu") for c in kt.convs(cfg, mxu)
             if c[1] >= len(coord)]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for (conv, g, c, cout, _), geoms, engine in jobs:
        _, src, dst, ks, st, pad = geoms[g]
        rules = conv_index(src, dst, ks, st, pad, engine)
        feats, w, bias = kt.rand_conv(gen, dev, src.capacity, c,
                                      rules.shape[1], cout)
        args = (feats, rules, w, dst.valid, bias)
        ref = k1.apply_conv_plain(feats.float(), rules, w.float(), dst.valid,
                                  bias)
        got = k1.sparse_conv(*args)
        assert torch.equal(got, k1.sparse_conv(*args)), conv
        assert _rel(got, ref) <= 1e-3, conv
        other = 1 - k1.route_for(*k1.kernel_widths(c, cout))
        assert _rel(k1.sparse_conv_probe(*args, route=other), ref) <= 1e-3, \
            conv


@pytest.mark.parametrize("name", list(FULL))
def test_k3_at_every_conv_of_a_full_scan(dev, name):
    """K3 at every conv of ``cuda_zrun`` (L0-L1) on a full-size radial
    scan, at the model's widths: within 1e-3 of its plain version's scale
    on both routes; two runs equal bit for bit."""
    cfg, vox = _full_scan(dev, name)
    geoms = kt.walk(cfg, vox, False, 2)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    for conv, g, c, cout, _ in kt.convs(cfg, geoms):
        _, src, dst, ks, st, pad = geoms[g]
        codes = conv_index(src, dst, ks, st, pad, "cuda_zrun")
        feats, w, bias = kt.rand_conv(gen, dev, src.capacity, c,
                                      3 * codes.shape[1], cout)
        args = (feats, codes, w, dst.valid, bias)
        ref = tzr.apply_conv_zrun_plain(feats.float(), codes, w.float(),
                                        dst.valid, bias)
        assert torch.equal(k3.zrun_conv(*args), k3.zrun_conv(*args)), conv
        for route in k1.ROUTE_NAMES:
            assert _rel(k3.zrun_conv(*args, route=route), ref) <= 1e-3, (
                conv, route)


@pytest.mark.parametrize("name,engine", [
    ("FocalFormer3D_L", "cuda"), ("FocalFormer3D_L", "cuda_mxu"),
    ("FocalFormer3D_L", "cuda_zrun"), ("FocalFormer3D_Waymo_L", "cuda")])
def test_training_convs_at_every_conv_of_a_full_batch(dev, name, engine):
    """Every sparse conv of a float32 training batch (two radial full-size
    scans, the training voxel cap) on ``engine``: ``cuda`` and
    ``cuda_zrun`` up to the training dense boundary L3, ``cuda_mxu`` every
    level and conv_out. The engine's differentiable conv
    (``sparse_conv_train`` on the rulebook and its transpose;
    ``zrun_conv_train`` on the z-run codes) against autograd through
    ``apply_conv_bf16_plain`` on the rulebook it reads: output, dx and dW
    within 1e-3 of scale (conv_input takes a dx only where its features
    train, the Waymo HardVFE's); dW's two runs equal bit for bit."""
    cfg = dataclasses.replace(get_config(name)["model"], sparse_engine=engine)
    batch = kt.train_batch(cfg, dev, FULL[name])
    vox = tdet.preprocess_points(cfg, batch["points"], batch["points_mask"],
                                 train=True)
    B = vox["coords"].shape[0]
    mxu = engine == "cuda_mxu"
    geoms = kt.walk(cfg, vox, mxu, len(cfg.encoder_channels) if mxu
                    else cfg.sparse_dense_from, batch=B)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    for conv, g, c, cout, _ in kt.convs(cfg, geoms):
        _, src, dst, ks, st, pad = geoms[g]
        index = conv_index(src, dst, ks, st, pad, engine)
        rules, rules_t = backward_index(index, src.capacity, engine, st != 1)
        K = rules.shape[1]
        x = torch.where(src.valid[..., None], torch.randn(
            B, src.capacity, c, device=dev, generator=gen), 0.0)
        w = (torch.randn(K, c, cout, device=dev, generator=gen)
             * (2.0 / (K * c)) ** 0.5)
        cot = torch.where(dst.valid[..., None], torch.randn(
            B, dst.capacity, cout, device=dev, generator=gen), 0.0)
        need_dx = cfg.vfe_type == "HardVFE" or conv != "conv_input"
        res = {}
        for side in ("kernel", "plain"):
            xx = x.clone().requires_grad_(need_dx)
            ww = w.clone().requires_grad_(True)
            with torch.enable_grad():
                if side == "plain":
                    y = k1.apply_conv_bf16_plain(xx, rules, ww, dst.valid)
                elif engine == "cuda_zrun":
                    y = k3.zrun_conv_train(xx, index, rules, rules_t, ww,
                                           dst.valid)
                else:
                    y = k1.sparse_conv_train(xx, rules, rules_t, ww,
                                             dst.valid)
                y.backward(cot)
            res[side] = (y.detach(), xx.grad, ww.grad)
        for what, got, ref in zip(("out", "dx", "dW"), res["kernel"],
                                  res["plain"]):
            assert (got is None) == (ref is None) == (what == "dx"
                                                      and not need_dx)
            if got is not None:
                assert _rel(got, ref) <= 1e-3, (conv, what)
        xb = x.bfloat16()
        assert torch.equal(k1.conv_wgrad(xb, cot, rules),
                           k1.conv_wgrad(xb, cot, rules)), conv


@pytest.mark.parametrize("name", list(FULL))
def test_full_width_bev_matches_the_plain_engine(dev, name):
    """The encoder's BEV of the full-width bf16 model on a full-size
    radial scan on each kernel engine against the plain engine with the
    same weights (dense from the eval boundary; the all-sparse
    ``cuda_mxu`` against dense from L4): within 1e-2 of scale."""
    from focalformer3d_tpu_torch.models.sparse_encoder import SparseEncoder

    cfg, vox = _full_scan(dev, name)
    m = tdet.FocalFormer3D(cfg).eval()
    m.load_state_dict(make_fake_state_dict(m, 0), strict=True)
    m = m.to(dev)
    enc = m.pts_middle_encoder
    plain = SparseEncoder(
        in_channels=cfg.voxel_feature_dim, sparse_shape=cfg.sparse_shape,
        output_channels=cfg.sparse_out_channels,
        encoder_channels=cfg.encoder_channels,
        down_paddings=cfg.down_paddings, capacities=cfg.capacities,
        out_capacity=cfg.out_capacity, engine="plain").to(dev).eval()
    plain.load_state_dict(enc.state_dict(), strict=True)
    ref = {}
    with torch.no_grad():
        feats = (m.pts_voxel_encoder(vox["voxels"], vox["num_points"])
                 if cfg.vfe_type == "HardVFE" else vox["features"])
        args = (feats, vox["coords"], vox["voxel_mask"])
        for engine in ENGINES:
            enc.engine = engine
            dense_from = 4 if engine == "cuda_mxu" \
                else cfg.sparse_dense_from_eval
            if dense_from not in ref:
                plain.dense_from = dense_from
                ref[dense_from] = plain(*args)
            assert _rel(enc(*args), ref[dense_from]) <= 1e-2, engine


# ---------------------------------------------------------------------------
# the CLIs at full width: train, benchmark, get_flops
# ---------------------------------------------------------------------------

def test_train_cli_keeps_last_and_resumes_on_card(dev, tmp_path):
    """The train CLI on FocalFormer3D_L (``--synthetic``, 2 epochs of 2
    steps at batch 2, ``--keep-last 1``), called with TF32 allowed, as a
    process of its own starts: it turns TF32 off, logs four finite losses
    and keeps ``epoch_2`` alone; a second call resumes at epoch 2, step 4,
    with the parameters, buffers and moments bit for bit."""
    from focalformer3d_tpu_torch.tools import train as train_cli
    from focalformer3d_tpu_torch.training import checkpoint as ckpt

    argv = ["FocalFormer3D_L", "--synthetic", "--epochs", "2",
            "--iters-per-epoch", "2", "--keep-last", "1", "--log-interval",
            "1", "--batch-size", "2", "--work-dir", str(tmp_path),
            "--no-tensorboard"]
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    for f in flags:
        f.allow_tf32 = True
    run = train_cli.main(argv)
    assert not any(f.allow_tf32 for f in flags)
    losses = [r["loss"] for r in _train_log(tmp_path)]
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert ckpt.list_epochs(str(tmp_path)) == [2]
    again = train_cli.main(argv)
    assert run.opt_state.count == again.opt_state.count == 4
    assert again.start_epoch == 2
    got = again.model.state_dict()
    for k, v in run.model.state_dict().items():
        assert torch.equal(got[k], v), k
    for a, b in zip(run.opt_state.mu + run.opt_state.nu,
                    again.opt_state.mu + again.opt_state.nu):
        assert torch.equal(a, b)


@pytest.mark.parametrize("argv", [
    ["FocalFormer3D_L", "--samples", "3", "--warmup", "1"],
    ["FocalFormer3D_L", "--train", "--samples", "2", "--batch-size", "2"],
    ["FocalFormer3D_Waymo_L", "--samples", "3", "--warmup", "1",
     "--n-points", "180000", "--big-batch", "0"]],
    ids=["inference", "train", "waymo"])
def test_benchmark_cli_on_card(dev, capsys, argv):
    """The benchmark CLI on the three kernel engines prints one JSON line
    with a finite time per engine; at inference a stage split and each
    level's occupancy per engine after it (_Waymo_L's split holds its
    ``HardVFE`` stage)."""
    from focalformer3d_tpu_torch.tools import benchmark

    benchmark.main([*argv, "--engines", ",".join(ENGINES)])
    out = capsys.readouterr().out.splitlines()
    recs = [json.loads(x) for x in out if x.startswith("{")]
    assert len(recs) == 1 and sorted(recs[0]["engines"]) == sorted(ENGINES)
    key = "ms_per_step" if "--train" in argv else "ms_per_scan"
    assert all(np.isfinite(r[key]["median"])
               for r in recs[0]["engines"].values())
    if "--train" not in argv:
        split = [x for x in out if x.startswith("stage split")]
        assert len(split) == 3 and len(
            [x for x in out if x.startswith("occupancy")]) == 3
        assert all(("HardVFE" in x) == (argv[0] == "FocalFormer3D_Waymo_L")
                   for x in split)


def test_get_flops_on_card_counts_as_the_cpu(dev):
    """``tools/get_flops`` on FocalFormer3D_L (its float32 config, the JAX
    tool's 200k-point scan) on each kernel engine, a counted forward and a
    timed one: each forward the engine's launches a scan; L0 and L1 count
    the same on every engine; on ``cuda`` the sparse FLOPs equal 2 x hits
    x C x Cout over the scan's convs, hits counted on their rulebooks, and
    the card's count equals ``--device cpu``'s op by op but for
    ``F.one_hot``'s range check (``get_flops.count_differs``).
    FocalFormer3D_LC and _Waymo_L count on the card with ``cuda``'s
    launches."""
    from focalformer3d_tpu_torch.tools import get_flops

    reps = {}
    for engine in ENGINES:
        train_step.reset_kernel_launches()
        reps[engine] = get_flops.main(["FocalFormer3D_L", "--engine", engine,
                                       "--repeat", "1"])
        assert _kernel_launches() == _eval_launches(engine, 2)
        assert reps[engine]["forward_ms"] > 0
    levels = {e: {lv: r["sparse_conv"]["levels"][lv] for lv in ("L0", "L1")}
              for e, r in reps.items()}
    assert levels["cuda_mxu"] == levels["cuda_zrun"] == levels["cuda"]
    cfg = get_config("FocalFormer3D_L")["model"]
    pts, mask, _ = get_flops.make_inputs(cfg, 200000, dev)
    geoms = kt.walk(cfg, tdet.preprocess_points(cfg, pts, mask), False, 2)
    flops = 0
    for _, g, c, cout, n in kt.convs(cfg, geoms):
        _, src, dst, ks, st, pad = geoms[g]
        rules = conv_index(src, dst, ks, st, pad, "cuda")
        hits = int(((rules < src.capacity) & dst.valid[:, None]).sum())
        flops += n * 2 * hits * c * cout
    assert reps["cuda"]["sparse_conv"]["flops"] == flops == sum(
        r["flops"] for r in levels["cuda"].values())
    cpu = get_flops.main(["FocalFormer3D_L", "--engine", "cuda", "--device",
                          "cpu"])
    differ, only = get_flops.count_differs(reps["cuda"], cpu)
    assert not differ and only, differ
    for name in ("FocalFormer3D_LC", "FocalFormer3D_Waymo_L"):
        train_step.reset_kernel_launches()
        get_flops.main([name])
        assert _kernel_launches() == _eval_launches("cuda", 1), name


# ---------------------------------------------------------------------------
# written dataset directories at a real sample's size through the CLIs
# ---------------------------------------------------------------------------

NUSC_METRICS = {"mAP", "mATE", "mASE", "mAOE", "mAVE", "nds_no_attr"}


def _nuscenes_dir(root, name, seed, **kw):
    """6 samples of a 30k-point key frame and 9 sweeps each (~290k points,
    a real 10-sweep sample's size) in ``name``'s range and classes."""
    cfg_all = get_config(name)
    return synthetic_dirs.write_nuscenes(
        root, seed=seed, samples=6, points=30000, sweeps=9,
        pc_range=cfg_all["model"].voxel.point_cloud_range,
        classes=cfg_all["class_names"], **kw)


def _test_cli(argv, engine, passes, n_samples=6):
    """The test CLI with the model-path launches counted from zero: what
    ``passes`` eval scans launch on ``engine`` (none for no engine), the
    metrics' keys, and ``n_samples`` tokens of at most 500 finite boxes in
    the submission. Returns its run."""
    from focalformer3d_tpu_torch.tools import test as test_cli

    train_step.reset_kernel_launches()
    out = argv[argv.index("--data-root") + 1] + "/sub.json"
    res = test_cli.main([*argv, "--out", out])
    want = (_eval_launches(engine, passes) if engine
            else dict.fromkeys(KERNELS, 0))
    assert _kernel_launches() == want, argv
    classes = get_config(argv[0])["class_names"]
    assert set(res.metrics) == NUSC_METRICS | {f"AP_{c}" for c in classes}
    with open(out) as fh:
        sub = json.load(fh)["results"]
    assert len(sub) == n_samples
    for token, anns in sub.items():
        vals = [x for a in anns for k in ("translation", "size", "rotation",
                                          "velocity") for x in a[k]]
        vals += [a["detection_score"] for a in anns]
        assert len(anns) <= 500 and np.isfinite(vals).all(), token
    return res


def _png_shows(path, points, boxes):
    """``browse_dataset``'s PNG read back at its size: a red pixel at
    every box corner in the drawn range, a non-white one at every point
    in it."""
    from focalformer3d_tpu_torch.tools import browse_dataset as bd
    from focalformer3d_tpu_torch.utils import png

    rgb = png.read_png(path)
    assert rgb.shape == (bd.SIZE, bd.SIZE, 3)
    x0, y0, x1, y1 = bd.PC_RANGE
    canvas = png.Canvas(bd.SIZE, bd.SIZE, (x0, x1), (y0, y1))
    xy, corners = bd.bev_geometry(points, boxes)
    r, c = canvas.to_pixel(corners.reshape(-1, 2))
    keep = canvas.inside(r, c)
    assert keep.any() and (rgb[r[keep], c[keep]] == png.RED).all()
    r, c = canvas.to_pixel(xy)
    keep = canvas.inside(r, c)
    assert keep.any() and (rgb[r[keep], c[keep]] != png.WHITE).any(-1).all()


def test_nuscenes_directory_through_the_clis_on_card(dev, tmp_path, capsys):
    """FocalFormer3D_L through the CLIs on a written nuScenes directory
    (``_nuscenes_dir``) with its GT database. The train CLI (2 epochs of 2
    steps at batch 2, GT-paste, ``Fading`` at epoch 1): four finite
    losses, ``epoch_2``, K1 forward / dx / dW 16 / 15 / 16 a step, 10
    native point loads (the first batch, drawn as the JAX CLI draws it,
    and four steps' of 2), no ``ObjectSample`` after Fading. The test CLI
    on its checkpoint (``_test_cli``) over the 6 samples on each kernel
    engine, then with ``--tta`` (the double flip, 4 passes a sample) on
    ``cuda`` and ``cuda_mxu`` and ``--tta-ensemble`` of the two caches (no
    launch). ``analyze_logs`` reads the train log and the printed lines as
    logged, prints their mean s/it and draws the curves;
    ``browse_dataset`` draws a synthetic scene and the directory's samples
    under both pipelines; matplotlib is never imported."""
    from focalformer3d_tpu_torch.data import native
    from focalformer3d_tpu_torch.tools import analyze_logs, browse_dataset
    from focalformer3d_tpu_torch.tools import create_data
    from focalformer3d_tpu_torch.tools import train as train_cli
    from focalformer3d_tpu_torch.training import checkpoint as ckpt
    from focalformer3d_tpu_torch.utils import png

    root, work = str(tmp_path / "nusc"), str(tmp_path / "work")
    ann = _nuscenes_dir(root, "FocalFormer3D_L", 20)
    create_data.create_gt_database(ann, root, root)
    train_step.reset_kernel_launches()
    native.reset_call_count()
    capsys.readouterr()
    run = train_cli.main([
        "FocalFormer3D_L", "--data-root", root, "--epochs", "2",
        "--iters-per-epoch", "2", "--batch-size", "2", "--log-interval", "1",
        "--work-dir", work, "--no-tensorboard"])
    with open(tmp_path / "train_cli.log", "w") as fh:
        fh.write(capsys.readouterr().out)
    recs = _train_log(work)
    assert len(recs) == 4 and np.isfinite([r["loss"] for r in recs]).all()
    assert 2 in ckpt.list_epochs(work)
    assert _kernel_launches() == {k: 4 * n for k, n in
                                  STEP_LAUNCHES["cuda"].items()}
    assert native.call_count() == 10
    assert not any(type(t).__name__ == "ObjectSample"
                   for t in run.pipeline.transforms)
    base = ["FocalFormer3D_L", "--data-root", root, "--limit", "6"]
    ckpt_args = ["--checkpoint", f"{work}/epoch_2"]
    for engine in ENGINES:
        _test_cli([*base, *ckpt_args, "--engine", engine], engine, 6)
    caches = {"cuda": str(tmp_path / "tta_A"),
              "cuda_mxu": str(tmp_path / "tta_B")}
    for engine, cache in caches.items():
        res = _test_cli([*base, *ckpt_args, "--engine", engine, "--tta",
                         "--tta-cache-dir", cache], engine, 4 * 6)
        assert res.passes == 4
    _test_cli([*base, "--tta-ensemble", *caches.values()], None, 0)

    logged = [(r["time"], r["loss"]) for r in recs]
    printed = [(float(f"{t:.2f}"), float(f"{x:.4f}")) for t, x in logged]
    logs = {f"{work}/train_log.jsonl": logged,
            str(tmp_path / "train_cli.log"): printed}
    for path, want in logs.items():
        rows = analyze_logs.parse(path)
        assert [(r["s_per_it"], r["loss"]) for r in rows] == want, path
    curves = str(tmp_path / "curves.png")
    analyze_logs.main([*logs, "--plot-out", curves])
    out = capsys.readouterr().out.splitlines()
    for path, want in logs.items():
        times = [t for t, _ in want]
        assert (f"{path}: {len(times)} log points, avg "
                f"{sum(times) / len(times):.3f}s/it") in out
    assert png.read_png(curves).ndim == 3
    for flags in (["--synthetic"], ["--data-root", root],
                  ["--data-root", root, "--train-pipeline"]):
        out = str(tmp_path / "browse.png")
        browse_dataset.main(flags + ["--out", out])
        _png_shows(out, *browse_dataset.load_sample(
            browse_dataset.parse_args(flags)))
    assert "matplotlib" not in sys.modules


def _fixture_digests():
    """The committed fixtures of ``tests/torch_images/`` through the
    port's decoder, resize, crop, flip and rotate on this machine: each
    result's SHA-256 equals Pillow's (``digests.json``)."""
    import hashlib
    import pathlib

    from focalformer3d_tpu_torch.data import image_io

    root = pathlib.Path(__file__).resolve().parent / "torch_images"
    digests = json.loads((root / "digests.json").read_text())
    for name, rec in digests["files"].items():
        img = image_io.imread(root / name)
        got = {"decode": img}
        chain = rec.get("chain")
        if chain:
            out = got["resize"] = image_io.resize(img, chain["resize"])
            out = got["crop"] = image_io.crop(out, chain["crop"])
            out = got["flip"] = image_io.flip_lr(out)
            got["rotate"] = image_io.rotate(out, chain["rotate"])
            got["scale"] = image_io.resize(img, chain["scale"])
        for step, arr in got.items():
            assert hashlib.sha256(arr.tobytes()).hexdigest() == rec[step], (
                name, step)


def test_camera_directory_through_the_clis_on_card(dev, tmp_path):
    """The image fixtures' digests on this machine (``_fixture_digests``),
    then FocalFormer3D_LC through the CLIs on a written directory
    (``_nuscenes_dir`` with six 1600 x 900 JPEG cameras a sample): the
    train CLI (2 epochs of 2 steps at batch 2 with its frozen branches:
    four finite losses, an eval scan's launches a step (the frozen point
    branch) and nothing else, six decodes
    a sample of the first batch and four steps'), the test CLI over the 6
    samples on ``cuda_mxu`` and with ``--tta`` on FocalFormer3D_LC_TTA over
    2 samples on ``cuda`` (``_test_cli``; 12 passes a sample), six decodes
    a sample."""
    from focalformer3d_tpu_torch.data import image_io
    from focalformer3d_tpu_torch.tools import train as train_cli

    _fixture_digests()
    root, work = str(tmp_path / "nusc"), str(tmp_path / "work")
    _nuscenes_dir(root, "FocalFormer3D_LC", 21, cameras=True,
                  img_hw=(900, 1600))
    train_step.reset_kernel_launches()
    image_io.reset_call_count()
    train_cli.main(["FocalFormer3D_LC", "--data-root", root, "--epochs", "2",
                    "--iters-per-epoch", "2", "--batch-size", "2",
                    "--log-interval", "1", "--work-dir", work,
                    "--no-tensorboard"])
    losses = [r["loss"] for r in _train_log(work)]
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert _kernel_launches() == _eval_launches("cuda", 4)
    assert image_io.call_count() == 6 * 2 * 5
    tta = get_config("FocalFormer3D_LC_TTA")["tta"]
    for name, engine, n, passes, extra in (
            ("FocalFormer3D_LC", "cuda_mxu", 6, 1, []),
            ("FocalFormer3D_LC_TTA", "cuda", 2,
             4 * len(tta["pts_scale_ratio"]), ["--tta"])):
        image_io.reset_call_count()
        res = _test_cli([name, "--data-root", root, "--checkpoint",
                         f"{work}/epoch_2", "--limit", str(n), "--engine",
                         engine, *extra], engine, n * passes, n)
        assert res.passes == passes and image_io.call_count() == 6 * n


@pytest.mark.parametrize("name,must_move", [
    ("FocalFormer3D_LC", ()),
    ("FocalFormer3D_LC_Proj", ("imgpts_neck.shared_conv_img.",
                               "imgpts_neck.fusion_blocks.0.I2P_block."))])
def test_camera_frozen_train_steps_on_card(dev, name, must_move):
    """Two float32 steps of a camera config at full width on ``cuda``,
    batch 2 (two radial 200k-point scans, six 448 x 800 cameras each),
    with the config's freeze flags: finite metrics, an eval scan's
    launches a step (the frozen point branch at the eval boundary: K1
    forward 11, K2 4, the index build's 1 + 2) and no dx or dW; the
    frozen image, LSS and point branches bit-identical; half or more of
    the trainable parameters moved, every one under ``must_move`` (LC_Proj:
    ``shared_conv_img`` and I2P) among them."""
    from focalformer3d_tpu_torch.training import optim

    all_cfg = get_config(name)
    cfg = dataclasses.replace(all_cfg["model"], sparse_engine="cuda")
    batch = synthetic.make_batch(
        np.random.RandomState(10), batch_size=2, n_points=200000,
        n_boxes=24, max_gts=32, num_classes=cfg.decoder.num_classes,
        pc_range=cfg.voxel.point_cloud_range, mode="radial",
        with_images=True, img_hw=cfg.lss.img_scale)
    b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    m = tdet.FocalFormer3D(cfg)
    m.load_state_dict(make_fake_state_dict(m, 0), strict=True)
    m = m.to(dev).train()
    tx = optim.make_optimizer(total_steps=10)
    state = tx.init(m.named_parameters())
    step = train_step.make_train_step(cfg, all_cfg["loss"], tx)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    before = {k: v.detach().clone() for k, v in m.state_dict().items()}
    train_step.reset_kernel_launches()
    with torch.enable_grad():
        for _ in range(2):
            met = step(m, state, b, gen)
            assert all(np.isfinite(float(v)) for v in met.values())
    assert _kernel_launches() == _eval_launches("cuda", 2)
    after = m.state_dict()
    frozen = [k for k in after if k.startswith((
        "img_backbone.", "img_neck.", "imgpts_neck.cam_lss.",
        "pts_middle_encoder.", "pts_backbone.", "pts_neck.",
        "imgpts_neck.shared_conv_pts."))]
    assert frozen and all(torch.equal(after[k], before[k]) for k in frozen)
    trainable = [n for n, p in m.named_parameters() if p.requires_grad]
    still = {k for k in trainable if torch.equal(after[k], before[k])}
    assert 2 * len(still) <= len(trainable)
    assert not [k for k in still if k.startswith(must_move)]
    del m, state, b
    torch.cuda.empty_cache()


def test_camera_train_cli_loads_the_image_branch_on_card(dev, tmp_path):
    """The train CLI: DeformFormer3D_C_R50 one step (no K1 launch; its
    checkpoint holds an image branch), then FocalFormer3D_LC 2 steps at
    batch 2 with ``--load-img-from`` it: the image branch as loaded, bit
    for bit; two finite losses; K1 forward 11 a step."""
    from focalformer3d_tpu_torch.tools import train as train_cli
    from focalformer3d_tpu_torch.training import checkpoint as ckpt

    common = ["--synthetic", "--epochs", "1", "--log-interval", "1",
              "--no-tensorboard"]
    train_step.reset_kernel_launches()
    train_cli.main(["DeformFormer3D_C_R50", "--batch-size", "1",
                    "--iters-per-epoch", "1", "--work-dir",
                    str(tmp_path / "c"), *common])
    assert not any(_kernel_launches().values())
    run = train_cli.main([
        "FocalFormer3D_LC", "--batch-size", "2", "--iters-per-epoch", "2",
        "--work-dir", str(tmp_path / "lc"), "--load-img-from",
        str(tmp_path / "c" / "epoch_1"), *common])
    assert _kernel_launches()["forward"] == 22
    losses = [r["loss"] for r in _train_log(tmp_path / "lc")]
    assert len(losses) == 2 and np.isfinite(losses).all()
    src = ckpt.load_payload(str(tmp_path / "c" / "epoch_1"))["state_dict"]
    got = run.model.state_dict()
    img = [n for n, _ in run.model.named_parameters() if n.startswith((
        "img_backbone.", "img_neck.", "imgpts_neck.cam_lss."))]
    assert img and all(torch.equal(got[k].cpu(), src[k]) for k in img)


def test_waymo_directory_through_the_clis_on_card(dev, tmp_path):
    """A Waymo directory of 6 frames of 180k points (``write_waymo``)
    through the CLIs: the train CLI on FocalFormer3D_Waymo_L (2 epochs of
    2 steps at batch 2: four finite losses, K1 forward / dx / dW 16 / 16 /
    16 a step, conv_input's dx too since the HardVFE trains), then on
    DeformFormer3D_Waymo15_L for one epoch (its ``load_interval`` 5 leaves
    2 of the 6 frames: one step); the test CLI on the first checkpoint
    over the 6 frames on each kernel engine: the L1 / L2 mAP / mAPH and
    per-class keys, all finite, and 6 frames' launches."""
    from focalformer3d_tpu_torch.tools import test as test_cli
    from focalformer3d_tpu_torch.tools import train as train_cli

    cfg_all = get_config("FocalFormer3D_Waymo_L")
    classes = cfg_all["class_names"]
    root, work = str(tmp_path / "waymo"), str(tmp_path / "work")
    synthetic_dirs.write_waymo(
        root, seed=30, frames=6, points=180000,
        pc_range=cfg_all["model"].voxel.point_cloud_range, classes=classes)
    common = ["--data-root", root, "--batch-size", "2", "--log-interval",
              "1", "--max-points", "200000", "--no-tensorboard"]
    for name, steps, extra in (
            ("FocalFormer3D_Waymo_L", 4, ["--epochs", "2",
                                          "--iters-per-epoch", "2",
                                          "--work-dir", work]),
            ("DeformFormer3D_Waymo15_L", 1, ["--epochs", "1", "--work-dir",
                                             work + "_15"])):
        train_step.reset_kernel_launches()
        train_cli.main([name, *common, *extra])
        losses = [r["loss"] for r in _train_log(extra[-1])]
        assert len(losses) == steps and np.isfinite(losses).all(), name
        assert _kernel_launches() == {
            **{k: n * steps for k, n in STEP_LAUNCHES["cuda"].items()},
            "dx": 16 * steps}, name
    keys = {f"L{lv}/{m}" for lv in (1, 2) for m in ("mAP", "mAPH")}
    keys |= {f"L{lv}/{c}_{m}" for lv in (1, 2) for c in classes
             for m in ("AP", "APH")}
    for engine in ENGINES:
        train_step.reset_kernel_launches()
        res = test_cli.main(["FocalFormer3D_Waymo_L", "--data-root", root,
                             "--checkpoint", f"{work}/epoch_2", "--engine",
                             engine, "--max-points", "200000"])
        assert _kernel_launches() == _eval_launches(engine, 6)
        assert res.samples == 6 and set(res.metrics) == keys
        assert np.isfinite(list(res.metrics.values())).all()


# ---------------------------------------------------------------------------
# data parallel at full width: two gloo ranks on this card
# ---------------------------------------------------------------------------

def test_full_width_two_rank_step_holds_the_floor(dev, tmp_path):
    """FocalFormer3D_L's float32 step at full width (dropouts off, the
    denoising groups' noise fixed) on two ``tools/dryrun_ddp`` workers
    over gloo on this card, batch 1 each, on ``plain``, ``cuda`` and
    ``cuda_mxu``: per rank ``train_step``'s launches of a step exactly;
    the ranks' gradients and state equal bit for bit; against this
    process's world-size-1 step at batch 2 every gradient and the state
    after the update within tolerance and no tighter than twice what the
    reversed batch moves them, the loss within 1e-5 on ``plain`` and
    bf16's unit roundoff on a kernel engine
    (``dryrun_ddp.compare_to_floor``: at full width a change of the sums'
    order alone flips top-k picks and bf16 roundings). Each of
    ``dryrun_ddp.FAULTS``, planted in both workers, fails that gate."""
    from focalformer3d_tpu_torch.tools import dryrun_ddp as dd

    engines = ("plain", "cuda", "cuda_mxu")
    cfg = get_config("FocalFormer3D_L")["model"]
    inputs = dd.step_inputs(cfg, seed=10, batch_size=2, n_points=200000,
                            n_boxes=24, max_gts=32, mode="radial")
    np.savez(tmp_path / "inputs.npz", **inputs)
    swapped = {k: v[::-1].copy() for k, v in inputs.items()}
    refs = {}
    for engine in engines:
        refs[engine] = [dd.one_step("FocalFormer3D_L", engine, x, 0, dev)
                        for x in (inputs, swapped)]
        torch.cuda.empty_cache()
    dd.spawn(2, ["--init-method", f"file://{tmp_path}/rendezvous",
                 "--device", "cuda:0", "--config", "FocalFormer3D_L",
                 "--engines", ",".join(engines), "--inputs",
                 str(tmp_path / "inputs.npz"), "--weights-seed", "0",
                 "--out", str(tmp_path), "--plant", ",".join(dd.FAULTS)],
             600, str(tmp_path))
    for engine in engines:
        ranks = [torch.load(dd.result_path(str(tmp_path), engine, r),
                            weights_only=True) for r in range(2)]
        for r in ranks:
            assert r["world"] == 2
            assert {k: r["launches"][k] for k in KERNELS} == \
                STEP_LAUNCHES[engine], engine
        for part in ("grads", "state"):
            for k in ranks[0][part]:
                assert torch.equal(ranks[0][part][k], ranks[1][part][k]), k
        report = dd.compare_to_floor(ranks[0], *refs[engine])
        assert report["ok"], (engine, report)
        for fault in dd.FAULTS:
            got = torch.load(dd.result_path(str(tmp_path), engine, 0, fault),
                             weights_only=True)
            assert not dd.compare_to_floor(got, *refs[engine])["ok"], (
                engine, fault)


@pytest.mark.parametrize("backend,world,steps", [("gloo", 2, 2),
                                                 ("nccl", 1, 1)])
def test_train_cli_data_parallel_on_card(dev, tmp_path, backend, world,
                                         steps):
    """The train CLI under torchrun's environment on FocalFormer3D_L
    (``--synthetic``, global batch 2): world size 2 over gloo, both ranks
    on ``cuda:0`` (NCCL takes one rank a card), and world size 1 over
    NCCL. Every rank exits 0; rank 0 alone prints its losses, logs and
    saves ``epoch_1``."""
    from focalformer3d_tpu_torch.tools import dryrun_ddp as dd

    work, logs = tmp_path / "work", tmp_path / "logs"
    logs.mkdir()
    extra = ["--device", "cuda:0"] if backend == "gloo" else []
    out = dd.spawn(world, [
        "FocalFormer3D_L", "--synthetic", "--epochs", "1",
        "--iters-per-epoch", str(steps), "--batch-size", "2",
        "--log-interval", "1", "--dist-backend", backend, "--work-dir",
        str(work), "--no-tensorboard", *extra], 600, str(logs),
        module="focalformer3d_tpu_torch.tools.train",
        env={"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port())})
    losses = [r["loss"] for r in _train_log(work)]
    assert len(losses) == steps and np.isfinite(losses).all()
    assert sorted(os.listdir(work)) == ["epoch_1", "train_log.jsonl"]
    assert out[0].count("loss=") == steps and "device: cuda:0" in out[0]
    assert not any("loss=" in o or "saved" in o for o in out[1:])

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
on the CPU (1e-3).
"""
import dataclasses

import numpy as np
import pytest
import torch

from focalformer3d_tpu_torch.configs import get_config
from focalformer3d_tpu_torch.data import synthetic
from focalformer3d_tpu_torch.models import detector as tdet
from focalformer3d_tpu_torch.ops import plan_builder as tpb
from focalformer3d_tpu_torch.ops import plan_builder_cuda as k2
from focalformer3d_tpu_torch.ops import sparse_conv as tsc
from focalformer3d_tpu_torch.ops import sparse_conv_cuda as k1
from focalformer3d_tpu_torch.ops import sparse_conv_zrun as tzr
from focalformer3d_tpu_torch.ops import sparse_conv_zrun_cuda as k3
from focalformer3d_tpu_torch.utils.ref_keys import make_fake_state_dict

pytestmark = pytest.mark.cuda
SHAPE = (41, 40, 36)
GEOMS = {
    "subm": None,
    "down_p111": (3, 2, (1, 1, 1)),
    "down_p011": (3, 2, (0, 1, 1)),
    "conv_out": ((3, 1, 1), (2, 1, 1), 0),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


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
    from focalformer3d_tpu_torch.training import losses, optim, train_step

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

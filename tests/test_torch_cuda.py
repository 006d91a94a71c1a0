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
CPU (exactly), and the Tiny_L slice's encoder on each kernel engine against
the plain engine (1e-2, bf16 scale).
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

"""On-card checks of the PyTorch port (marker ``cuda``; skipped without one).

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has PyTorch with CUDA and no JAX. ``tests/conftest.py``
imports JAX, so run it there with

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_cuda.py

It holds the K1 kernel against its plain PyTorch version (1e-3 of the output
scale, the bf16-operand / f32-accumulate contract), the index build and the
voxelizer on the card against the same functions on the CPU (exactly), and
the Tiny_L slice's encoder on the kernel engine against the plain engine
(1e-2, bf16 scale).
"""
import dataclasses

import numpy as np
import pytest
import torch

from focalformer3d_tpu_torch.configs import get_config
from focalformer3d_tpu_torch.data import synthetic
from focalformer3d_tpu_torch.models import detector as tdet
from focalformer3d_tpu_torch.ops import sparse_conv as tsc
from focalformer3d_tpu_torch.ops import sparse_conv_cuda as k1
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
@pytest.mark.parametrize("cin,cout", [(5, 16), (16, 32), (32, 64), (8, 24)])
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

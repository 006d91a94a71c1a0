"""Parity: the PyTorch port's voxelization against the JAX package.

Same numpy inputs through ``focalformer3d_tpu.ops.voxelize`` /
``models.detector.preprocess_points`` and their counterparts in
``focalformer3d_tpu_torch``. Voxel coords, masks and CSR order must match
exactly. Features are per-voxel means: the port sums each voxel directly,
JAX takes a difference of two float32 prefix sums over all sorted points,
which cancels. So the port is held to 1e-6 of the feature scale against its
own float64 run, and to JAX within JAX's cancellation bound, two float32
ulps of the largest possible prefix sum: 2 * 2**-23 * sum|x| per column.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focalformer3d_tpu.configs import get_config as jax_get_config
from focalformer3d_tpu.data import synthetic
from focalformer3d_tpu.models import detector as jdet
from focalformer3d_tpu.ops import voxelize as jvox
from focalformer3d_tpu_torch.configs import get_config
from focalformer3d_tpu_torch.data import synthetic as tsynthetic
from focalformer3d_tpu_torch.models import detector as tdet
from focalformer3d_tpu_torch.ops import voxelize as tvox

torch.set_num_threads(2)


def _points(cfg, n, seed, mode):
    rng = np.random.RandomState(seed)
    batch = synthetic.make_batch(
        rng, batch_size=2, n_points=n, n_boxes=4, max_gts=8,
        num_classes=cfg.decoder.num_classes,
        pc_range=cfg.voxel.point_cloud_range, mode=mode,
    )
    mask = batch["points_mask"].copy()
    mask[:, -n // 10:] = False  # padded tail
    return batch["points"], mask


def _check_features(got, ref, valid_points):
    """Per-column bound of JAX's prefix-sum difference (see docstring)."""
    atol = 2 * 2.0 ** -23 * np.abs(valid_points).sum(0)
    assert np.all(np.abs(got - ref) <= atol[None, :]), (
        np.abs(got - ref).max(0), atol)


def _vcfgs(max_voxels):
    jcfg = jax_get_config("Tiny_L")["model"]
    tcfg = get_config("Tiny_L")["model"]
    return (dataclasses.replace(jcfg.voxel, max_voxels=max_voxels),
            dataclasses.replace(tcfg.voxel, max_voxels=max_voxels), tcfg)


def test_point_voxel_coords_exact():
    jv, tv, tcfg = _vcfgs(512)
    pts, mask = _points(tcfg, 4000, 0, "uniform")
    jc, jvalid = jvox.point_voxel_coords(jv, jnp.asarray(pts[0]),
                                         jnp.asarray(mask[0]))
    tc, tvalid = tvox.point_voxel_coords(tv, torch.from_numpy(pts[0]),
                                         torch.from_numpy(mask[0]))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))


@pytest.mark.parametrize("mode,n,max_voxels", [
    ("uniform", 3000, 512),   # capacity overflow: voxels past 512 dropped
    ("uniform", 3000, 4096),  # everything fits
    ("radial", 6000, 4096),   # dense rings: the first-P-points cap bites
])
def test_hard_voxelize_simple(mode, n, max_voxels):
    jv, tv, tcfg = _vcfgs(max_voxels)
    pts, mask = _points(tcfg, n, 1, mode)
    jout = jax.jit(lambda p, m: jvox.hard_voxelize_simple(jv, p, m))(
        jnp.asarray(pts[0]), jnp.asarray(mask[0]))
    tout = tvox.hard_voxelize_simple(tv, torch.from_numpy(pts[0]),
                                     torch.from_numpy(mask[0]))
    jmask = np.asarray(jout["voxel_mask"])
    assert jmask.sum() > 100
    np.testing.assert_array_equal(tout["voxel_mask"].numpy(), jmask)
    np.testing.assert_array_equal(tout["coords"].numpy(),
                                  np.asarray(jout["coords"]))
    _check_features(tout["features"].numpy(), np.asarray(jout["features"]),
                    pts[0][mask[0]])
    f64 = tvox.hard_voxelize_simple(tv, torch.from_numpy(pts[0]).double(),
                                    torch.from_numpy(mask[0]))["features"]
    np.testing.assert_allclose(tout["features"].numpy(), f64.numpy(),
                               rtol=0, atol=1e-6 * np.abs(f64.numpy()).max())


def test_preprocess_points_test_cap():
    """Batched entry point, with the max_voxels_test cap of inference."""
    jcfg = jax_get_config("Tiny_L")["model"]
    jcfg = dataclasses.replace(
        jcfg, voxel=dataclasses.replace(jcfg.voxel, max_voxels_test=700))
    tcfg = get_config("Tiny_L")["model"]
    tcfg = dataclasses.replace(
        tcfg, voxel=dataclasses.replace(tcfg.voxel, max_voxels_test=700))
    pts, mask = _points(tcfg, 3000, 2, "uniform")
    jout = jax.jit(lambda p, m: jdet.preprocess_points(jcfg, p, m))(
        jnp.asarray(pts), jnp.asarray(mask))
    tout = tdet.preprocess_points(tcfg, torch.from_numpy(pts),
                                  torch.from_numpy(mask))
    assert tout["features"].shape == (2, 700, 5)
    for k in ("coords", "voxel_mask"):
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]))
    for b in range(2):
        _check_features(tout["features"][b].numpy(),
                        np.asarray(jout["features"][b]), pts[b][mask[b]])


@pytest.mark.parametrize("mode", ["radial", "uniform"])
def test_synthetic_batch_matches_jax_package(mode):
    """The port's scan generator draws what the JAX package's does."""
    kw = dict(batch_size=2, n_points=5000, n_boxes=6, max_gts=8,
              num_classes=10, mode=mode)
    ref = synthetic.make_batch(np.random.RandomState(7), **kw)
    got = tsynthetic.make_batch(np.random.RandomState(7), **kw)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)

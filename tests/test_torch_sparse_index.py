"""Parity: the PyTorch port's sparse index build against the JAX package.

Same numpy voxel sets through ``focalformer3d_tpu.ops.sparse_conv`` (the
exact ``voxel`` engine) and ``focalformer3d_tpu_torch.ops.sparse_conv``.
Everything here is integer, so everything must match exactly: bit helpers,
column meta (int32 two's-complement words), subm and strided rulebooks,
downsample coords / valid flags / meta, and the dense scatter.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focalformer3d_tpu.ops import sparse_conv as jsc
from focalformer3d_tpu_torch.ops import sparse_conv as tsc

torch.set_num_threads(2)


def _voxel_set(seed, shape, n, capacity):
    """n unique voxels of a D x H x W grid in CSR order, padded."""
    D, H, W = shape
    rng = np.random.RandomState(seed)
    keys = np.sort(rng.choice(D * H * W, size=n, replace=False))
    # CSR key = (y*W + x)*D + z
    z, yx = keys % D, keys // D
    coords = np.stack([z, yx // W, yx % W], -1).astype(np.int32)
    coords = np.pad(coords, ((0, capacity - n), (0, 0)))
    valid = np.arange(capacity) < n
    return coords, valid


def _tables(coords, valid, shape):
    jt = jsc.build_table_csr(jnp.asarray(coords), jnp.asarray(valid), shape)
    tt = tsc.build_table_csr(torch.from_numpy(coords),
                             torch.from_numpy(valid), shape)
    return jt, tt


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


# deep grids exercise the high z word (z >= 32) and bit 31 of the low one
SHAPES = [(25, 16, 16), (41, 12, 10), (64, 6, 6)]


def test_bit_helpers():
    rng = np.random.RandomState(0)
    w0 = rng.randint(-2 ** 31, 2 ** 31, size=512, dtype=np.int64)
    w1 = rng.randint(-2 ** 31, 2 ** 31, size=512, dtype=np.int64)
    w0[:3] = [-1, -2 ** 31, 2 ** 31 - 1]
    w0, w1 = w0.astype(np.int32), w1.astype(np.int32)
    z = rng.randint(0, 64, size=512).astype(np.int32)
    z[:4] = [0, 31, 32, 63]
    jw0, jw1, jz = jnp.asarray(w0), jnp.asarray(w1), jnp.asarray(z)
    u0, u1 = tsc._u32(torch.from_numpy(w0)), tsc._u32(torch.from_numpy(w1))
    tz = torch.from_numpy(z)
    _eq(tsc._test_bit(u0, u1, tz), jsc._test_bit(jw0, jw1, jz))
    _eq(tsc._rank(u0, u1, tz), jsc._rank(jw0, jw1, jz))
    _eq(tsc._popcount(u0), jax.lax.population_count(jw0))
    for tw, jw in zip(tsc._zbit(tz), jsc._zbit(jz)):
        _eq(tsc._i32(tw), jw)
    for tw, jw in zip(tsc._low_mask(tz), jsc._low_mask(jz)):
        _eq(tsc._i32(tw), jw)
    _eq(tsc._i32(u0), jw0)


@pytest.mark.parametrize("shape", SHAPES)
def test_table_meta(shape):
    coords, valid = _voxel_set(1, shape, 400, 512)
    jt, tt = _tables(coords, valid, shape)
    _eq(tt.meta, jt.meta)


@pytest.mark.parametrize("shape", SHAPES)
def test_subm_rules(shape):
    coords, valid = _voxel_set(2, shape, 400, 512)
    jt, tt = _tables(coords, valid, shape)
    jr = jsc.build_subm_rules(jt, shape, 3, use_positions=True)
    tr = tsc.build_subm_rules(tt, shape, 3)
    assert tr.dtype == torch.int32 and tr.shape == (27, 512)
    _eq(tr, jr)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("ks,stride,pad,cap", [
    (3, 2, (1, 1, 1), 640),             # down0 / down1 geometry
    (3, 2, (0, 1, 1), 640),             # down2 geometry
    ((3, 1, 1), (2, 1, 1), 0, 640),     # conv_out geometry
    (3, 2, (1, 1, 1), 100),             # output capacity overflow
])
def test_downsample_and_strided_rules(shape, ks, stride, pad, cap):
    coords, valid = _voxel_set(3, shape, 400, 512)
    jt, tt = _tables(coords, valid, shape)
    joc, jov, jshape, jof, jmeta = jsc.build_downsample(
        jnp.asarray(coords), jnp.asarray(valid), shape, ks, stride, pad, cap)
    toc, tov, tshape, tof, tmeta = tsc.build_downsample(
        torch.from_numpy(coords), torch.from_numpy(valid), shape, ks, stride,
        pad, cap)
    assert tshape == tuple(jshape)
    _eq(toc, joc)
    _eq(tov, jov)
    _eq(tmeta, jmeta)
    assert int(tof) == int(jof)
    jr = jsc.build_conv_rules(jt, shape, joc, jov, ks, stride, pad,
                              use_positions=True)
    tr = tsc.build_conv_rules(tt, shape, toc, tov, ks, stride, pad)
    _eq(tr, jr)
    # the output set's meta indexes the next level: its subm rulebook
    _eq(tsc.build_subm_rules(tsc.table_from_meta(toc, tov, tmeta), tshape),
        jsc.build_subm_rules(jsc.table_from_meta(joc, jov, jmeta), jshape,
                             3, use_positions=True))


@pytest.mark.parametrize("D,Do,kz,sz,pz", [
    (41, 21, 3, 2, 1),   # stride-2 word-parallel branch
    (40, 40, 3, 1, 1),   # generic branch (Do > 32)
    (64, 32, 3, 2, 1),   # stride 2 at the full 64-bit depth
])
def test_downsample_bits(D, Do, kz, sz, pz):
    rng = np.random.RandomState(4)
    hi_bits = max(D - 32, 0)
    w0 = rng.randint(-2 ** 31, 2 ** 31, size=256, dtype=np.int64)
    w1 = rng.randint(0, 2 ** hi_bits, size=256, dtype=np.int64)
    w0, w1 = w0.astype(np.int32), w1.astype(np.int32)
    j0, j1 = jsc._downsample_bits(jnp.asarray(w0), jnp.asarray(w1), D, Do,
                                  kz, sz, pz)
    t0, t1 = tsc._downsample_bits(tsc._u32(torch.from_numpy(w0)),
                                  tsc._u32(torch.from_numpy(w1)), D, Do, kz,
                                  sz, pz)
    _eq(tsc._i32(t0), j0)
    _eq(tsc._i32(t1), j1)


def test_compress_even_bits():
    rng = np.random.RandomState(5)
    w = rng.randint(0, 2 ** 32, size=256, dtype=np.int64)
    j = jsc._compress_even_bits(jnp.asarray(w.astype(np.uint32)))
    t = tsc._compress_even_bits(torch.from_numpy(w))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j).astype(np.int64))


def test_conv_out_shape():
    for args in [((41, 1440, 1440), 3, 2, (1, 1, 1)),
                 ((11, 360, 360), 3, 2, (0, 1, 1)),
                 ((5, 180, 180), (3, 1, 1), (2, 1, 1), 0)]:
        assert tsc.conv_out_shape(*args) == tuple(jsc.conv_out_shape(*args))
    with pytest.raises(ValueError):
        tsc.conv_out_shape((1, 4, 4), 3, 2, 0)


def test_to_dense():
    shape = (7, 9, 8)
    coords, valid = _voxel_set(6, shape, 150, 200)
    feats = np.random.RandomState(6).randn(200, 3).astype(np.float32)
    j = jsc.to_dense(jnp.asarray(feats), jnp.asarray(coords),
                     jnp.asarray(valid), shape)
    t = tsc.to_dense(torch.from_numpy(feats), torch.from_numpy(coords),
                     torch.from_numpy(valid), shape)
    assert t.shape == (7, 9, 8, 3)
    _eq(t, j)

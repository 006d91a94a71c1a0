"""Parity: the port's meta-chain index build (K2's plain version) against JAX.

Same numpy voxel sets through ``focalformer3d_tpu.ops`` and
``focalformer3d_tpu_torch.ops``. Integers must match exactly:
``downsample_meta`` (meta, shape, total), ``colz_from_coords``,
``colz_from_meta`` (level 0, strided levels, conv_out, capacity overflow),
``decode_rules`` against ``plan_builder.decode_rules`` and
``sparse_conv.build_conv_rules``, and the K2 wrapper's CPU path against
``decode_rules``. The conv over the port's rules (K1's wrapper on the CPU:
bf16 operands, f32 accumulation) is held against the JAX MXU plan
(``build_plan_mxu``) applied by the Pallas kernel in interpret mode, at 1e-3
of the output scale, as ``tests/test_plan_builder.py`` runs it. K2 itself
runs only on a card (``tests/test_torch_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focalformer3d_tpu.ops import plan_builder as jpb
from focalformer3d_tpu.ops import sparse_conv as jsc
from focalformer3d_tpu.ops import sparse_conv_pallas as scp
from focalformer3d_tpu_torch.ops import plan_builder as tpb
from focalformer3d_tpu_torch.ops import plan_builder_cuda as k2
from focalformer3d_tpu_torch.ops import sparse_conv as tsc
from focalformer3d_tpu_torch.ops import sparse_conv_cuda as k1

torch.set_num_threads(2)

SHAPES = [(25, 16, 16), (41, 12, 10), (64, 6, 6)]
# (kernel, stride, padding): the encoder's subm, down0/down1, down2, conv_out
GEOMS = {
    "subm": (3, 1, 1),
    "down_p111": (3, 2, (1, 1, 1)),
    "down_p011": (3, 2, (0, 1, 1)),
    "conv_out": ((3, 1, 1), (2, 1, 1), 0),
}


def _voxel_set(seed, shape, n, capacity):
    """n unique voxels of a D x H x W grid in CSR order, padded."""
    D, H, W = shape
    rng = np.random.RandomState(seed)
    keys = np.sort(rng.choice(D * H * W, size=n, replace=False))
    z, yx = keys % D, keys // D
    coords = np.stack([z, yx // W, yx % W], -1).astype(np.int32)
    coords = np.pad(coords, ((0, capacity - n), (0, 0)))
    return coords, np.arange(capacity) < n


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _out_sites(coords, valid, shape, geom, cap):
    """Output sites of one geometry: (JAX coords, JAX valid, out shape,
    torch coords, torch valid), from each package's build_downsample (which
    the index tests hold equal)."""
    ks, st, pad = GEOMS[geom]
    if geom == "subm":
        return (jnp.asarray(coords), jnp.asarray(valid), shape,
                torch.from_numpy(coords), torch.from_numpy(valid))
    joc, jov, oshape = jsc.build_downsample(
        jnp.asarray(coords), jnp.asarray(valid), shape, ks, st, pad, cap)[:3]
    toc, tov = tsc.build_downsample(
        torch.from_numpy(coords), torch.from_numpy(valid), shape, ks, st,
        pad, cap)[:2]
    return joc, jov, tuple(oshape), toc, tov


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("geom", ["down_p111", "down_p011", "conv_out"])
def test_downsample_meta(shape, geom):
    ks, st, pad = GEOMS[geom]
    coords, valid = _voxel_set(1, shape, 400, 512)
    jt = jsc.build_table_csr(jnp.asarray(coords), jnp.asarray(valid), shape)
    tt = tsc.build_table_csr(torch.from_numpy(coords),
                             torch.from_numpy(valid), shape)
    jmeta, jshape, jtotal = jsc.downsample_meta(jt.meta, shape, ks, st, pad)
    tmeta, tshape, ttotal = tsc.downsample_meta(tt.meta, shape, ks, st, pad)
    assert tshape == tuple(jshape) and int(ttotal) == int(jtotal)
    _eq(tmeta, jmeta)
    # the meta chain agrees with the coordinate-list downsample
    _eq(tmeta, tsc.build_downsample(torch.from_numpy(coords),
                                    torch.from_numpy(valid), shape, ks, st,
                                    pad, 640)[4])


def test_colz_from_coords_and_back():
    coords, valid = _voxel_set(2, (41, 12, 10), 300, 384)
    got = tpb.colz_from_coords(torch.from_numpy(coords),
                               torch.from_numpy(valid), 10)
    assert got.dtype == torch.int32
    _eq(got, jpb.colz_from_coords(jnp.asarray(coords), jnp.asarray(valid),
                                  10))
    _eq(tpb.coords_from_colz(got, 10), np.where(valid[:, None], coords, 0))


@pytest.mark.parametrize("shape,geom,cap", [
    (SHAPES[0], "subm", 512),         # level 0: the table's own meta
    (SHAPES[1], "down_p111", 640),    # strided levels
    (SHAPES[2], "down_p111", 640),
    (SHAPES[1], "down_p011", 640),
    (SHAPES[0], "conv_out", 640),
    (SHAPES[1], "down_p111", 100),    # output capacity overflow
])
def test_colz_from_meta(shape, geom, cap):
    coords, valid = _voxel_set(3, shape, 400, 512)
    tt = tsc.build_table_csr(torch.from_numpy(coords),
                             torch.from_numpy(valid), shape)
    if geom == "subm":
        meta, w = tt.meta, shape[2]
        want = tpb.colz_from_coords(torch.from_numpy(coords),
                                    torch.from_numpy(valid), w)
    else:
        ks, st, pad = GEOMS[geom]
        meta, oshape, _ = tsc.downsample_meta(tt.meta, shape, ks, st, pad)
        w = oshape[2]
        toc, tov = tsc.build_downsample(
            torch.from_numpy(coords), torch.from_numpy(valid), shape, ks,
            st, pad, cap)[:2]
        want = tpb.colz_from_coords(toc, tov, w)
    # d is the input level's depth where the encoder calls it
    got = tpb.colz_from_meta(meta, cap, d=shape[0])
    _eq(got, want)  # the scatter-built site list
    _eq(got, jpb.colz_from_meta(jnp.asarray(meta.numpy()), cap, d=shape[0]))
    if geom == "subm":
        _eq(tpb.colz_from_meta(meta, cap), want)  # the default d = 64


@pytest.mark.parametrize("shape", SHAPES[:2])
@pytest.mark.parametrize("geom", list(GEOMS))
def test_decode_rules(shape, geom):
    ks, st, pad = GEOMS[geom]
    coords, valid = _voxel_set(4, shape, 400, 512)
    jt = jsc.build_table_csr(jnp.asarray(coords), jnp.asarray(valid), shape)
    tt = tsc.build_table_csr(torch.from_numpy(coords),
                             torch.from_numpy(valid), shape)
    joc, jov, oshape, toc, tov = _out_sites(coords, valid, shape, geom, 448)
    out_w = oshape[2]
    tcolz = tpb.colz_from_coords(toc, tov, out_w)
    got = tpb.decode_rules(tcolz, 512, tt.meta, ks, st, pad, shape, out_w)
    assert got.dtype == torch.int32
    _eq(got, jpb.decode_rules(None, jpb.colz_from_coords(joc, jov, out_w),
                              512, jt.meta, ks, st, pad, shape, out_w))
    _eq(got, jsc.build_conv_rules(jt, shape, joc, jov, ks, st, pad,
                                  use_positions=True))
    _eq(got, tsc.build_conv_rules(tt, shape, toc, tov, ks, st, pad))
    # the K2 wrapper, batched, on the CPU: decode_rules, no launch
    n0 = k2.launch_count()
    batched = k2.plan_rules(tt.meta[None].contiguous(), tcolz[None], 512,
                            ks, st, pad, shape, out_w)
    assert k2.launch_count() == n0
    _eq(batched[0], got.numpy())


def test_plan_rules_checks():
    coords, valid = _voxel_set(5, (25, 16, 16), 100, 128)
    tt = tsc.build_table_csr(torch.from_numpy(coords),
                             torch.from_numpy(valid), (25, 16, 16))
    colz = tpb.colz_from_coords(torch.from_numpy(coords),
                                torch.from_numpy(valid), 16)[None]
    meta = tt.meta[None].contiguous()
    with pytest.raises(TypeError):
        k2.plan_rules(meta.long(), colz, 128, in_shape=(25, 16, 16))
    with pytest.raises(ValueError):  # meta of another grid
        k2.plan_rules(meta, colz, 128, in_shape=(25, 16, 8))
    with pytest.raises(ValueError):
        k2.plan_rules(meta, colz[:, ::2], 128, in_shape=(25, 16, 16))


# the two not-slow geometries of tests/test_plan_builder.py
PLAN_GEOMS = [
    (13, 32, 32, 300, 384, 3, 1, (1, 1, 1)),
    (13, 32, 32, 300, 384, 3, 2, (1, 1, 1)),
]


@pytest.mark.parametrize("geom", PLAN_GEOMS)
def test_conv_over_k2_rules_vs_pallas_mxu(geom):
    D, H, W, n, cap, ks, st, pad = geom
    shape = (D, H, W)
    coords, valid = _voxel_set(6, shape, n, cap)
    jc, jv = jnp.asarray(coords), jnp.asarray(valid)
    jt = jsc.build_table_csr(jc, jv, shape)
    tt = tsc.build_table_csr(torch.from_numpy(coords),
                             torch.from_numpy(valid), shape)
    if st == 1:
        jmeta_o, jcolz = None, jpb.colz_from_coords(jc, jv, W)
        out_w, tout_valid = W, torch.from_numpy(valid)
        tcolz = tpb.colz_from_coords(torch.from_numpy(coords), tout_valid, W)
    else:
        jmeta_o, oshape, jtotal = jsc.downsample_meta(jt.meta, shape, ks, st,
                                                      pad)
        out_w = oshape[2]
        jcolz = jpb.colz_from_meta(jmeta_o, cap, d=D)
        tmeta_o, _, ttotal = tsc.downsample_meta(tt.meta, shape, ks, st, pad)
        tcolz = tpb.colz_from_meta(tmeta_o, cap, d=D)
        tout_valid = torch.arange(cap) < min(int(ttotal), cap)
    jout_valid = jcolz >= 0
    _eq(tcolz, jcolz)
    window = min(256, scp._padded_rows(cap))
    plan = jpb.build_plan_mxu(jt.meta, jcolz, cap, ks, st, pad, shape, out_w,
                              tile=64, window=window, overflow_capacity=8192)
    jrules = jsc.build_conv_rules(
        jt, shape, jnp.stack([jnp.where(jout_valid, jcolz & 63, 0),
                              jnp.where(jout_valid, (jcolz >> 6) // out_w, 0),
                              jnp.where(jout_valid, (jcolz >> 6) % out_w, 0)],
                             -1),
        jout_valid, ks, st, pad, use_positions=True)
    plan_t = plan if st == 1 else scp.build_tile_plan(
        scp.transpose_rules(jrules, cap, ks), cap, ks, 64, window, 8192)
    rng = np.random.RandomState(7)
    K, cin, cout = 27, 8, 16
    feats = rng.randint(-8, 9, (cap, cin)).astype(np.float32) * 0.25
    feats[n:] = 0
    w = rng.randint(-8, 9, (K, cin, cout)).astype(np.float32) / 16
    bias = rng.randn(cout).astype(np.float32)
    ref = scp.apply_conv_pallas_batched(
        jnp.asarray(feats)[None], jax.tree.map(lambda a: a[None], plan),
        jax.tree.map(lambda a: a[None], plan_t), jnp.asarray(w),
        jout_valid[None], bias=jnp.asarray(bias), kernel_size=ks,
        interpret=True)[0]
    rules = k2.plan_rules(tt.meta[None].contiguous(), tcolz[None], cap, ks,
                          st, pad, shape, out_w)
    got = k1.sparse_conv(torch.from_numpy(feats)[None].bfloat16(), rules,
                         torch.from_numpy(w).bfloat16(), tout_valid[None],
                         torch.from_numpy(bias))[0]
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-3 * np.abs(ref).max())

"""Parity: the sparse-conv apply (K1) of the PyTorch port.

``apply_conv_plain`` (the kernel's plain version) against the exact JAX
engine ``sparse_conv.apply_conv`` in float32 (1e-5 of the output scale),
and the wrapper's CPU path (bf16 operands, f32 accumulation: K1's rounding)
against the JAX Pallas kernel run in interpret mode, as
``tests/test_sparse_pallas.py`` runs it (1e-3). Geometries: submanifold,
(3,3,3)/s2/p1 and (3,3,3)/s2/p(0,1,1), on rulebooks from the port's index
build (which the index tests hold equal to JAX's). The kernel itself runs
only on a card: ``tests/test_torch_cuda.py`` holds it against this plain
version there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focalformer3d_tpu.ops import sparse_conv as jsc
from focalformer3d_tpu.ops import sparse_conv_pallas as scp
from focalformer3d_tpu_torch.ops import sparse_conv as tsc
from focalformer3d_tpu_torch.ops import sparse_conv_cuda as k1

torch.set_num_threads(2)

SHAPE = (9, 16, 16)
GEOMS = {
    "subm": None,
    "down_p111": (3, 2, (1, 1, 1)),
    "down_p011": (3, 2, (0, 1, 1)),
}


def _setup(geom, seed, cin=8, cout=16, n=300, cap=384, cap_out=320):
    """CSR voxel set, rules of one geometry, bf16-representable values."""
    D, H, W = SHAPE
    rng = np.random.RandomState(seed)
    keys = np.sort(rng.choice(D * H * W, size=n, replace=False))
    z, yx = keys % D, keys // D
    coords = np.stack([z, yx // W, yx % W], -1).astype(np.int32)
    coords = torch.from_numpy(np.pad(coords, ((0, cap - n), (0, 0))))
    valid = torch.arange(cap) < n
    table = tsc.build_table_csr(coords, valid, SHAPE)
    if GEOMS[geom] is None:
        rules = tsc.build_subm_rules(table, SHAPE, 3)
        out_valid, ks = valid, 3
    else:
        ks, stride, pad = GEOMS[geom]
        oc, out_valid = tsc.build_downsample(coords, valid, SHAPE, ks,
                                             stride, pad, cap_out)[:2]
        rules = tsc.build_conv_rules(table, SHAPE, oc, out_valid, ks, stride,
                                     pad)
    feats = rng.randint(-8, 9, (cap, cin)).astype(np.float32) * 0.25
    feats[n:] = 0
    w = rng.randint(-8, 9, (27, cin, cout)).astype(np.float32) / 16
    bias = rng.randn(cout).astype(np.float32)
    return (torch.from_numpy(feats), rules, torch.from_numpy(w), out_valid,
            torch.from_numpy(bias), ks, cap)


@pytest.mark.parametrize("geom", list(GEOMS))
def test_plain_vs_exact_engine_f32(geom):
    rng = np.random.RandomState(7)
    f, rules, w, ov, b, _, _ = _setup(geom, 1)
    f = f + torch.from_numpy(rng.randn(*f.shape).astype(np.float32)) * 0.1
    ref = jsc.apply_conv(jnp.asarray(f.numpy()), jnp.asarray(rules.numpy()),
                         jnp.asarray(w.numpy()), jnp.asarray(ov.numpy()),
                         jnp.asarray(b.numpy()))
    got = k1.apply_conv_plain(f[None], rules[None], w, ov[None], b)[0]
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("geom", list(GEOMS))
def test_wrapper_cpu_vs_pallas_interpret_bf16(geom):
    f, rules, w, ov, b, ks, cap = _setup(geom, 2, cin=5)
    cap_out = rules.shape[1]
    jr = jnp.asarray(rules.numpy())
    plan = scp.build_tile_plan(jr, cap, ks, tile=16, window=64,
                               overflow_capacity=4096)
    plan_t = plan
    if GEOMS[geom] is not None:
        plan_t = scp.build_tile_plan(scp.transpose_rules(jr, cap, ks),
                                     cap_out, ks, tile=16, window=64,
                                     overflow_capacity=4096)
    ref = scp.apply_conv_pallas_batched(
        jnp.asarray(f.numpy())[None], jax.tree.map(lambda a: a[None], plan),
        jax.tree.map(lambda a: a[None], plan_t), jnp.asarray(w.numpy()),
        jnp.asarray(ov.numpy())[None], bias=jnp.asarray(b.numpy()),
        kernel_size=ks, interpret=True,
    )[0]
    n0 = k1.launch_count()
    got = k1.sparse_conv(f[None].bfloat16(), rules[None], w.bfloat16(),
                         ov[None], b)[0]
    assert got.dtype == torch.float32 and k1.launch_count() == n0
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-3 * np.abs(ref).max())


def test_wrapper_checks():
    f, rules, w, ov, b, _, _ = _setup("subm", 3)
    f, w = f[None].bfloat16(), w.bfloat16()
    with pytest.raises(TypeError):
        k1.sparse_conv(f.float(), rules[None], w, ov[None], b)
    with pytest.raises(TypeError):
        k1.sparse_conv(f, rules[None].long(), w, ov[None], b)
    with pytest.raises(TypeError):
        k1.sparse_conv(f, rules[None], w, ov[None], b.double())
    with pytest.raises(ValueError):
        k1.sparse_conv(f, rules[None], w[:, :4], ov[None], b)
    with pytest.raises(ValueError):
        k1.sparse_conv(f, rules[None, :26], w, ov[None], b)
    with pytest.raises(ValueError):
        k1.sparse_conv(f, rules[None], w, ov[None, :-1], b)
    with pytest.raises(ValueError):  # not contiguous
        k1.sparse_conv(f, rules[None].transpose(1, 2).contiguous()
                       .transpose(1, 2), w, ov[None], b)


def test_pad_channels():
    x = torch.ones(2, 3, 5)
    p = k1.pad_channels(x, 2)
    assert p.shape == (2, 3, 16) and p[..., 5:].abs().sum() == 0
    w = torch.ones(27, 5, 16)
    assert k1.pad_channels(w, 1).shape == (27, 16, 16)
    x32 = torch.ones(4, 32)
    assert k1.pad_channels(x32, 1) is x32

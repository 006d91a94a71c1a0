"""Parity: K1's backward in the PyTorch port against the JAX package.

- The transposed rulebook: ``transpose_rules`` (scatter) and
  ``transposed_conv_rules`` (decode from the output meta) equal JAX's bit
  for bit, on rulebooks from the port's index build (held equal to JAX's
  by ``tests/test_torch_sparse_index.py``); a submanifold rulebook is its
  own transpose, as the training encoder assumes.
- ``sparse_conv_train`` (K1's ``torch.autograd.Function``) on CPU tensors,
  where its kernels run their plain versions, against the VJP of JAX's
  ``apply_conv_pallas_batched`` run in interpret mode, as
  ``tests/test_sparse_pallas.py`` runs it: dx, dW and db for submanifold
  and strided convs. Features and weights are bf16-representable, the
  cotangent is any float32, so dx checks the bf16 rounding of the
  cotangent that both packages apply; the rest differs only in the order
  of float32 sums: 1e-5 of each gradient's scale.
- The plain version (``apply_conv_bf16_plain``) gives the Function's
  gradients; invalid rows give and receive no gradient.
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
    "conv_out": ((3, 1, 1), (2, 1, 1), 0),
}
TOL = 1e-5


def _voxels(seed, n=300, cap=384):
    D, H, W = SHAPE
    rng = np.random.RandomState(seed)
    keys = np.sort(rng.choice(D * H * W, size=n, replace=False))
    z, yx = keys % D, keys // D
    coords = np.stack([z, yx // W, yx % W], -1).astype(np.int32)
    coords = torch.from_numpy(np.pad(coords, ((0, cap - n), (0, 0))))
    return coords, torch.arange(cap) < n


def _geometry(geom, seed, cap_out=320):
    """(rules, out_valid, out meta, out shape, kernel size, coords, valid)
    of one conv on a CSR voxel set."""
    coords, valid = _voxels(seed)
    table = tsc.build_table_csr(coords, valid, SHAPE)
    if GEOMS[geom] is None:
        return (tsc.build_subm_rules(table, SHAPE, 3), valid, table.meta,
                SHAPE, 3, coords, valid)
    ks, stride, pad = GEOMS[geom]
    oc, ov, oshape, _, ometa = tsc.build_downsample(coords, valid, SHAPE, ks,
                                                    stride, pad, cap_out)
    rules = tsc.build_conv_rules(table, SHAPE, oc, ov, ks, stride, pad)
    return rules, ov, ometa, oshape, ks, coords, valid


def _j(t):
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("geom", list(GEOMS))
def test_transpose_rules_bit_exact(geom):
    rules, _, _, _, ks, coords, _ = _geometry(geom, 1)
    cap = coords.shape[0]
    got = tsc.transpose_rules(rules, cap)
    ref = scp.transpose_rules(_j(rules), cap, ks)
    assert got.dtype == torch.int32 and got.shape == (rules.shape[0], cap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("geom", ["down_p111", "down_p011", "conv_out"])
def test_transposed_conv_rules_bit_exact(geom):
    rules, ov, ometa, oshape, ks, coords, valid = _geometry(geom, 2)
    _, stride, pad = GEOMS[geom]
    cap_out = ov.shape[0]
    got = tsc.transposed_conv_rules(ometa, oshape, coords, valid, cap_out,
                                    ks, stride, pad)
    ref = jsc.transposed_conv_rules(_j(ometa), oshape, _j(coords),
                                    _j(valid), cap_out, ks, stride, pad)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # decode and scatter give the same transposed rulebook
    assert torch.equal(got, tsc.transpose_rules(rules, coords.shape[0]))


@pytest.mark.parametrize("seed", [3, 4])
def test_subm_rules_are_their_own_transpose(seed):
    rules, _, _, _, _, coords, _ = _geometry("subm", seed)
    assert torch.equal(tsc.transpose_rules(rules, coords.shape[0]), rules)


def _operands(rng, cap, cap_out, K, cin, cout, valid):
    f = rng.randint(-8, 9, (2, cap, cin)).astype(np.float32) * 0.25
    f = np.where(valid[None, :, None], f, 0.0).astype(np.float32)
    w = rng.randint(-8, 9, (K, cin, cout)).astype(np.float32) / 16
    b = rng.randn(cout).astype(np.float32)
    cot = rng.randn(2, cap_out, cout).astype(np.float32)
    return f, w, b, cot


def _port_grads(fn, f, w, b, cot):
    ff = torch.from_numpy(f).requires_grad_(True)
    ww = torch.from_numpy(w).requires_grad_(True)
    bb = torch.from_numpy(b).requires_grad_(True)
    with torch.enable_grad():  # other test modules may turn grad mode off
        out = fn(ff, ww, bb)
        out.backward(torch.from_numpy(cot))
    return out.detach(), ff.grad, ww.grad, bb.grad


@pytest.mark.parametrize("geom", ["subm", "down_p111", "conv_out"])
@pytest.mark.parametrize("cin,cout", [(8, 16), (16, 32)])
def test_vjp_matches_pallas_interpret(geom, cin, cout):
    rules, ov, _, _, ks, coords, valid = _geometry(geom, 5)
    cap, cap_out, K = coords.shape[0], ov.shape[0], rules.shape[0]
    rng = np.random.RandomState(6)
    f, w, b, cot = _operands(rng, cap, cap_out, K, cin, cout, valid.numpy())
    rules_t = tsc.transpose_rules(rules, cap)
    rb, rtb = rules[None].repeat(2, 1, 1), rules_t[None].repeat(2, 1, 1)
    ovb = ov[None].repeat(2, 1)

    plan = scp.build_tile_plan(_j(rules), cap, ks, tile=16, window=64,
                               overflow_capacity=4096)
    plan_t = scp.build_tile_plan(_j(rules_t), cap_out, ks, tile=16,
                                 window=64, overflow_capacity=4096)
    plans = [jax.tree.map(lambda a: jnp.stack([a, a]), p)
             for p in (plan, plan_t)]

    def jfwd(ff, ww, bb):
        return scp.apply_conv_pallas_batched(
            ff, plans[0], plans[1], ww, jnp.asarray(ovb.numpy()), bias=bb,
            kernel_size=ks, interpret=True)

    ref, vjp = jax.vjp(jfwd, jnp.asarray(f), jnp.asarray(w), jnp.asarray(b))
    ref_grads = vjp(jnp.asarray(cot))

    n0 = [k1.launch_count(kind) for kind in ("forward", "dx", "wgrad")]
    got = _port_grads(
        lambda ff, ww, bb: k1.sparse_conv_train(ff, rb, rtb, ww, ovb, bb),
        f, w, b, cot)
    assert [k1.launch_count(kind) for kind in ("forward", "dx", "wgrad")] \
        == n0  # CPU tensors: the plain versions, no launch
    for name, g, r in zip(("out", "dx", "dW", "db"), got,
                          (ref,) + tuple(ref_grads)):
        r = np.asarray(r)
        assert g.dtype == torch.float32 and g.shape == r.shape, name
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=TOL * np.abs(r).max(), err_msg=name)


@pytest.mark.parametrize("geom", ["subm", "down_p011"])
def test_plain_version_and_invalid_rows(geom):
    """``apply_conv_bf16_plain``'s autograd gives the Function's gradients;
    the cotangent at invalid output rows changes nothing, and padded input
    rows get zero dx."""
    rules, ov, _, _, _, coords, valid = _geometry(geom, 7)
    cap, cap_out, K = coords.shape[0], ov.shape[0], rules.shape[0]
    rng = np.random.RandomState(8)
    f, w, b, cot = _operands(rng, cap, cap_out, K, 16, 16, valid.numpy())
    f = f + rng.randn(*f.shape).astype(np.float32) * 0.01  # not bf16-exact
    rb = rules[None].repeat(2, 1, 1)
    rtb = tsc.transpose_rules(rules, cap)[None].repeat(2, 1, 1)
    ovb = ov[None].repeat(2, 1)
    fn = lambda ff, ww, bb: k1.sparse_conv_train(ff, rb, rtb, ww, ovb, bb)
    got = _port_grads(fn, f, w, b, cot)
    plain = _port_grads(
        lambda ff, ww, bb: k1.apply_conv_bf16_plain(ff, rb, ww, ovb, bb),
        f, w, b, cot)
    for name, g, p in zip(("out", "dx", "dW", "db"), got, plain):
        np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=0,
                                   atol=TOL * p.abs().max().item(),
                                   err_msg=name)
    noisy = np.where(ovb.numpy()[..., None], cot, 1e6).astype(np.float32)
    again = _port_grads(fn, f, w, b, noisy)
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    assert torch.all(got[1][:, ~valid] == 0)


def test_wgrad_wrapper_checks():
    rules, ov, _, _, _, coords, _ = _geometry("subm", 9)
    x = torch.zeros(1, coords.shape[0], 16, dtype=torch.bfloat16)
    g = torch.zeros(1, ov.shape[0], 16)
    r = rules[None]
    assert k1.conv_wgrad(x, g, r).shape == (27, 16, 16)
    with pytest.raises(TypeError):
        k1.conv_wgrad(x.float(), g, r)
    with pytest.raises(TypeError):
        k1.conv_wgrad(x, g.bfloat16(), r)
    with pytest.raises(TypeError):
        k1.conv_wgrad(x, g, r.long())
    with pytest.raises(ValueError):
        k1.conv_wgrad(x, g[:, :-1], r)
    with pytest.raises(ValueError):
        k1.conv_wgrad(x, g, rules)
    with pytest.raises(ValueError):  # not contiguous
        k1.conv_wgrad(x, g.transpose(1, 2).contiguous().transpose(1, 2), r)

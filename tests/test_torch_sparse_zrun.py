"""Parity: the port's z-run plans and K3's plain version against JAX.

``build_zplan`` codes, expanded to their 27 (or 3) taps by ``zrun_rules``,
must equal ``sparse_conv.build_conv_rules`` of both packages exactly, on
random sets and on hand-built columns that hold every (z0, z0+1, z0+2)
presence pattern, including 0b101 (z0 and z0+2 present, z0+1 absent), whose
second row is anchor + 1. ``apply_conv_zrun_plain`` (and K3's wrapper on the
CPU) is held against ``sparse_conv_zrun.apply_conv_zrun`` run in interpret
mode, as ``tests/test_sparse_zrun.py`` runs it, on bf16-representable
values: the JAX kernel rounds each per-tap partial product to bf16 and the
port does not, so the bound is 2**-8 of the output scale. K3 itself runs
only on a card (``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focalformer3d_tpu.ops import sparse_conv as jsc
from focalformer3d_tpu.ops import sparse_conv_pallas as scp
from focalformer3d_tpu.ops import sparse_conv_zrun as scz
from focalformer3d_tpu_torch.ops import sparse_conv as tsc
from focalformer3d_tpu_torch.ops import sparse_conv_zrun as tzr
from focalformer3d_tpu_torch.ops import sparse_conv_zrun_cuda as k3

torch.set_num_threads(2)

GEOMS = {
    "subm": (3, 1, (1, 1, 1)),
    "down_p111": (3, 2, (1, 1, 1)),
    "down_p011": (3, 2, (0, 1, 1)),
    "conv_out": ((3, 1, 1), (2, 1, 1), 0),
}
# hand-built columns (y, x, z list) with every presence pattern of a subm
# conv: runs, isolated voxels, gaps of one (0b101), both z edges
PATTERN_COLS = [
    (0, 0, [0, 1, 2]),
    (0, 1, [3, 4]),
    (0, 2, [2, 4]),
    (0, 3, [5]),
    (1, 0, [0]),
    (1, 1, [0, 2, 4, 6]),
    (1, 2, [6, 7]),
    (2, 0, [1, 2, 3, 4, 5]),
]


def _random_set(seed, shape, n, cap):
    D, H, W = shape
    rng = np.random.RandomState(seed)
    keys = np.sort(rng.choice(D * H * W, size=n, replace=False))
    z, yx = keys % D, keys // D
    coords = np.stack([z, yx // W, yx % W], -1).astype(np.int32)
    return np.pad(coords, ((0, cap - n), (0, 0))), np.arange(cap) < n


def _pattern_set(cap=32):
    pts = sorted((y, x, z) for (y, x, zs) in PATTERN_COLS for z in zs)
    coords = np.zeros((cap, 3), np.int32)
    coords[:len(pts)] = [(z, y, x) for (y, x, z) in pts]
    return coords, np.arange(cap) < len(pts)


def _case(name):
    """(coords, valid, shape) of a named voxel set, CSR-ordered."""
    if name == "patterns":
        return (*_pattern_set(), (8, 4, 4))
    shape = {"deep": (41, 12, 10), "flat": (9, 16, 16)}[name]
    return (*_random_set(1, shape, 400, 512), shape)


def _plan(coords, valid, shape, geom, cap_out=448):
    """Tables, output sites, z-run codes and both packages' rulebooks."""
    ks, st, pad = GEOMS[geom]
    c, v = torch.from_numpy(coords), torch.from_numpy(valid)
    tt = tsc.build_table_csr(c, v, shape)
    jt = jsc.build_table_csr(jnp.asarray(coords), jnp.asarray(valid), shape)
    if geom == "subm":
        toc, tov = c, v
    else:
        toc, tov = tsc.build_downsample(c, v, shape, ks, st, pad, cap_out)[:2]
    codes = tzr.build_zplan(tt, shape, toc, tov, ks, st, pad)
    jrules = jsc.build_conv_rules(jt, shape, jnp.asarray(toc.numpy()),
                                  jnp.asarray(tov.numpy()), ks, st, pad,
                                  use_positions=True)
    return jt, tt, toc, tov, codes, jrules


@pytest.mark.parametrize("case", ["patterns", "deep", "flat"])
@pytest.mark.parametrize("geom", list(GEOMS))
def test_zrun_codes_expand_to_rules(case, geom):
    coords, valid, shape = _case(case)
    jt, tt, toc, tov, codes, jrules = _plan(coords, valid, shape, geom)
    ks, st, pad = GEOMS[geom]
    kz, ky, kx = tsc._as_triple(ks)
    assert codes.dtype == torch.int32
    assert codes.shape == (ky * kx, toc.shape[0])
    rules = tzr.zrun_rules(codes, tt.capacity)
    np.testing.assert_array_equal(rules.numpy(), np.asarray(jrules))
    np.testing.assert_array_equal(
        rules.numpy(), tsc.build_conv_rules(tt, shape, toc, tov, ks, st,
                                            pad).numpy())
    assert torch.all(codes[:, ~tov] == 0)


def test_zrun_gap_pattern_reads_anchor_plus_one():
    """z0 and z0+2 present, z0+1 absent (pattern 0b101): tap dz=2 reads
    anchor + 1, the row right after tap dz=0's, not anchor + 2."""
    coords, valid, shape = _case("patterns")
    _, tt, toc, _, codes, _ = _plan(coords, valid, shape, "subm")
    R = codes.shape[0]
    hits = ((codes & 7) == 0b101).nonzero().tolist()
    assert hits  # columns (0, 2) and (1, 1) hold gaps of one
    rules = tzr.zrun_rules(codes, tt.capacity)
    col_z = {(y, x): zs for (y, x, zs) in PATTERN_COLS}
    for r, j in hits:
        anchor = int(codes[r, j]) >> 3
        assert int(rules[r, j]) == anchor
        assert int(rules[R + r, j]) == tt.capacity
        assert int(rules[2 * R + r, j]) == anchor + 1
        z = int(toc[j, 0])
        y, x = int(toc[j, 1]) - 1 + r // 3, int(toc[j, 2]) - 1 + r % 3
        assert z - 1 in col_z[(y, x)] and z not in col_z[(y, x)]
        assert tuple(coords[anchor]) == (z - 1, y, x)
        assert tuple(coords[anchor + 1]) == (z + 1, y, x)


def _bf16_vals(rng, shape, scale):
    return rng.randint(-8, 9, size=shape).astype(np.float32) * scale


@pytest.mark.parametrize("case,geom", [
    ("patterns", "subm"),
    ("flat", "down_p111"),
    ("flat", "conv_out"),
])
def test_apply_conv_zrun_plain_vs_jax(case, geom):
    coords, valid, shape = _case(case)
    jt, tt, toc, tov, codes, jrules = _plan(coords, valid, shape, geom, 256)
    ks, st, pad = GEOMS[geom]
    cap_in, cap_out = coords.shape[0], toc.shape[0]
    K = jrules.shape[0]
    rng = np.random.RandomState(5)
    feats = _bf16_vals(rng, (cap_in, 8), 0.25) * valid[:, None]
    w = _bf16_vals(rng, (K, 8, 12), 1 / 16)
    bias = rng.randn(12).astype(np.float32)
    # JAX's z-run kernel, interpret mode (its plan needs a tile window)
    jtoc, jtov = jnp.asarray(toc.numpy()), jnp.asarray(tov.numpy())
    window = min(64, scp._padded_rows(cap_in))
    zplan = scz.build_zplan(jt, shape, jtoc, jtov, ks, st, pad, tile=16,
                            window=window, overflow_capacity=4096)
    plan = scp.build_tile_plan(jrules, cap_in, ks, tile=16, window=window,
                               overflow_capacity=4096)
    plan_t = plan if geom == "subm" else scp.build_tile_plan(
        scp.transpose_rules(jrules, cap_in, ks), cap_out, ks, tile=16,
        window=min(64, scp._padded_rows(cap_out)), overflow_capacity=4096)
    ref = np.asarray(scz.apply_conv_zrun(
        jnp.asarray(feats), zplan, plan, plan_t, jnp.asarray(w), jtov,
        bias=jnp.asarray(bias), interpret=True))
    tol = 2.0 ** -8 * np.abs(ref).max()
    got = tzr.apply_conv_zrun_plain(
        torch.from_numpy(feats)[None], codes[None], torch.from_numpy(w),
        tov[None], torch.from_numpy(bias))[0]
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=tol)
    # K3's wrapper on the CPU: bf16 operands, f32 accumulation, no launch
    n0 = k3.launch_count()
    wrapped = k3.zrun_conv(torch.from_numpy(feats)[None].bfloat16(),
                           codes[None].contiguous(),
                           torch.from_numpy(w).bfloat16(), tov[None],
                           torch.from_numpy(bias))[0]
    assert wrapped.dtype == torch.float32 and k3.launch_count() == n0
    np.testing.assert_allclose(wrapped.numpy(), ref, rtol=0, atol=tol)


def test_zrun_conv_checks():
    coords, valid, shape = _case("patterns")
    _, tt, toc, tov, codes, _ = _plan(coords, valid, shape, "subm")
    f = torch.zeros(1, coords.shape[0], 16, dtype=torch.bfloat16)
    w = torch.zeros(27, 16, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # 9 codes need 27 taps of weights
        k3.zrun_conv(f, codes[None], w[:9], tov[None])
    with pytest.raises(TypeError):
        k3.zrun_conv(f, codes[None].long(), w, tov[None])
    with pytest.raises(ValueError):  # kz must be 3
        tzr.build_zplan(tt, shape, toc, tov, (1, 3, 3), 1, (0, 1, 1))

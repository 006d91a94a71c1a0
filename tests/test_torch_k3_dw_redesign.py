"""Host-side parts of the redesigned K3 and dW kernels, on the CPU.

The kernels themselves run only on a card (``tests/test_torch_cuda.py``);
what surrounds them is plain Python and torch and is held here against
independent numpy versions:

- ``pack_zrun_weights``: K3's shared-memory image of W, element by element
  against the byte offsets the kernel computes (``kb32_offset`` of
  ``csrc/mma_sm90.cuh``, z tap dz of BEV tap r in K-blocks dz * C / 16 ..),
  and its round trip through ``unpack_zrun_weights``;
- ``zrun_hit_shares``: the share of (tile, BEV tap), (64-row group, BEV
  tap), (16-row strip, BEV tap) and (site, BEV tap) pairs with a z tap,
  against a numpy loop, with a ragged V_out and an all-miss tile;
- ``split_bf16``: hi and lo are bf16 values and ``hi + lo`` lies within
  2^-16 of |g| of g;
- ``wgrad_plain`` (the dW kernel's plain version, with the split) against
  dW computed exactly in float64;
- ``wgrad_slices``: the dW launch's slices of the site list.
"""
import numpy as np
import pytest
import torch

from focalformer3d_tpu_torch.ops import sparse_conv_cuda as k1
from focalformer3d_tpu_torch.ops import sparse_conv_zrun as tzr
from focalformer3d_tpu_torch.ops import sparse_conv_zrun_cuda as k3


def _kb32_offset(rows, row, j, h):
    """``kb32_offset`` of ``csrc/mma_sm90.cuh``."""
    return (j * rows + row) * 32 + ((h ^ ((row >> 2) & 1)) << 4)


@pytest.mark.parametrize("R,C,cout", [(9, 16, 16), (9, 32, 64), (1, 64, 32),
                                      (9, 128, 128), (3, 16, 24)])
def test_pack_zrun_weights_is_the_shared_memory_image(R, C, cout):
    rng = np.random.RandomState(R * C + cout)
    w = torch.from_numpy(rng.randn(3 * R, C, cout).astype(np.float32))
    w = w.bfloat16()
    packed = k3.pack_zrun_weights(w)
    assert packed.shape == (R, 3 * C // 16, cout, 16)
    assert packed.is_contiguous()
    assert torch.equal(k3.unpack_zrun_weights(packed), w)
    # W[dz * R + r][cc][n] sits where BEV tap r's 3C-deep operand holds
    # element dz * C + cc of row n
    image = packed.reshape(R, -1).float().numpy()
    wn = w.float().numpy()
    for r in range(R):
        for dz in range(3):
            for cc in range(0, C, 7):
                for n in range(0, cout, 5):
                    kk = dz * C + cc
                    off = _kb32_offset(cout, n, kk // 16, (kk % 16) // 8) \
                        + (kk % 8) * 2
                    assert image[r, off // 2] == wn[dz * R + r, cc, n]


def test_pack_zrun_weights_needs_three_z_taps():
    with pytest.raises(ValueError):
        k3.pack_zrun_weights(torch.zeros(26, 16, 16, dtype=torch.bfloat16))


def _shares_numpy(codes):
    B, R, v_out = codes.shape
    hit = (codes & 7) != 0
    out = {}
    for name, rows in (("tile", 128), ("group64", 64), ("strip16", 16),
                       ("site", 1)):
        n_groups = -(-v_out // 128) * (128 // rows)
        held = total = 0
        for b in range(B):
            for r in range(R):
                for g in range(n_groups):
                    total += 1
                    held += bool(hit[b, r, g * rows:(g + 1) * rows].any())
        out[name] = held / total
    return out


@pytest.mark.parametrize("v_out,miss", [(300, 0.6), (129, 0.0), (1, 0.3),
                                        (640, 0.95)])
def test_zrun_hit_shares_vs_numpy(v_out, miss):
    rng = np.random.RandomState(v_out)
    anchor = rng.randint(0, 5000, size=(2, 9, v_out))
    pattern = rng.randint(1, 8, size=(2, 9, v_out))
    codes = np.where(rng.rand(2, 9, v_out) < miss, 0,
                     (anchor << 3) | pattern).astype(np.int32)
    if v_out >= 256:
        codes[:, :, 128:256] = 0  # a tile on which no BEV tap has a z tap
    got = k3.zrun_hit_shares(torch.from_numpy(codes))
    want = _shares_numpy(codes)
    assert set(got) == {"tile", "group64", "strip16", "site"}
    for name in want:
        assert got[name] == pytest.approx(want[name], abs=1e-6), name
    assert got["tile"] >= got["group64"] >= got["strip16"] >= got["site"]


def test_zrun_hit_shares_agree_with_the_rulebook():
    """A BEV tap has a hit where any of its three z taps has one in the
    rulebook the codes encode."""
    rng = np.random.RandomState(3)
    v_in = 900
    codes = np.where(rng.rand(1, 9, 700) < 0.5, 0,
                     (rng.randint(0, 800, (1, 9, 700)) << 3)
                     | rng.randint(1, 8, (1, 9, 700))).astype(np.int32)
    codes = torch.from_numpy(codes)
    rules = tzr.zrun_rules(codes, v_in)  # (1, 27, 700), dz-major
    bev_hit = (rules < v_in).reshape(1, 3, 9, 700).any(1)
    assert k3.zrun_hit_shares(codes) == k1.hit_shares_of(bev_hit)


def test_zrun_conv_routes_on_the_cpu():
    """On the CPU every route is the plain version; an unknown one is
    refused."""
    g = torch.Generator().manual_seed(0)
    f = torch.randn(1, 50, 16, generator=g).bfloat16()
    w = torch.randn(27, 16, 32, generator=g).bfloat16()
    codes = ((torch.randint(0, 45, (1, 9, 40), generator=g) << 3)
             | torch.randint(0, 8, (1, 9, 40), generator=g)).to(torch.int32)
    valid = torch.ones(1, 40, dtype=torch.bool)
    ref = tzr.apply_conv_zrun_plain(f, codes, w, valid)
    for route in k1.ROUTE_NAMES:
        assert torch.equal(k3.zrun_conv(f, codes, w, valid, route=route), ref)
    with pytest.raises(ValueError):
        k3.zrun_conv(f, codes, w, valid, route=2)


@pytest.mark.parametrize("scale", [1.0, 1e-20, 3e20])
def test_split_bf16(scale):
    rng = np.random.RandomState(1)
    g = torch.from_numpy((rng.randn(4096) * scale).astype(np.float32))
    g[:3] = torch.tensor([0.0, 1.0, -2.5]) * scale
    hi, lo = k1.split_bf16(g)
    assert hi.dtype == lo.dtype == torch.float32
    assert torch.equal(hi.bfloat16().float(), hi)
    assert torch.equal(lo.bfloat16().float(), lo)
    err = (g.double() - hi.double() - lo.double()).abs()
    assert torch.all(err <= 2.0 ** -16 * g.double().abs())
    assert torch.equal(hi, g.bfloat16().float())
    # the low part carries what bf16 alone drops
    assert float((g.double() - hi.double()).abs().max()) > float(err.max())


@pytest.mark.parametrize("B,K,c,cout", [(2, 27, 16, 32), (1, 3, 32, 16),
                                        (2, 8, 48, 24)])
def test_wgrad_plain_vs_exact(B, K, c, cout):
    """dW with the split against float64: within 2^-14 of sum |x| |g| per
    entry (the split loses at most 2^-16 |g| per product, f32 sums the
    rest), and much closer than a product with g rounded to bf16."""
    rng = np.random.RandomState(B * K + c)
    v_in, v_out = 300, 250
    x = torch.from_numpy(rng.randn(B, v_in, c).astype(np.float32)).bfloat16()
    g = torch.from_numpy(rng.randn(B, v_out, cout).astype(np.float32))
    rules = rng.randint(0, v_in, (B, K, v_out))
    rules[rng.rand(B, K, v_out) < 0.4] = v_in
    rules = torch.from_numpy(rules.astype(np.int32))
    got = k1.wgrad_plain(x, g, rules)
    assert torch.equal(k1.conv_wgrad(x, g, rules), got)  # CPU: plain

    xs = np.concatenate([x.float().numpy().astype(np.float64),
                         np.zeros((B, 1, c))], 1)
    gd = g.numpy().astype(np.float64)
    exact = np.zeros((K, c, cout))
    mag = np.zeros((K, c, cout))
    for k in range(K):
        for b in range(B):
            xr = xs[b][rules[b, k].numpy()]
            exact[k] += xr.T @ gd[b]
            mag[k] += np.abs(xr).T @ np.abs(gd[b])
    err = np.abs(got.numpy() - exact)
    assert np.all(err <= 2.0 ** -14 * mag)
    g_bf16 = g.bfloat16().float()
    coarse = np.abs(k1.wgrad_plain(x, g_bf16, rules).numpy() - exact).max()
    assert err.max() * 8 < coarse


@pytest.mark.parametrize("n_sites,K", [(0, 27), (1, 27), (5000, 27),
                                       (376832, 27), (155648, 27),
                                       (491520, 1), (300, 8)])
def test_wgrad_slices_cover_the_sites(n_sites, K):
    """Slices are multiples of 256 sites that cover the site list with the
    last one ragged, about ``WGRAD_BLOCKS`` blocks of (tap, slice) where
    the sites allow that, and fit the grid's second dimension."""
    n_slices, per = k1.wgrad_slices(n_sites, K)
    assert per % k1.WGRAD_SLICE_UNIT == 0 and per > 0
    assert 1 <= n_slices <= 65535
    assert n_slices * per >= n_sites
    assert (n_slices - 1) * per < max(n_sites, 1)
    target = -(-k1.WGRAD_BLOCKS // K)
    assert n_slices <= target
    if n_sites >= k1.WGRAD_SLICE_UNIT * target:
        assert n_slices >= 0.9 * target

"""Host-side parts of the redesigned K1 and kernel A, on the CPU.

The kernels themselves run only on a card (``tests/test_torch_cuda.py``);
what surrounds them is plain Python and torch and is held here against
independent numpy versions:

- ``hit_shares``: the share of (tile, tap), (64-row group, tap), (16-row
  strip, tap) and (site, tap) pairs with a hit, against a numpy loop,
  including an all-miss tile and V_out that is no multiple of 128;
- ``pack_weights``: the shared-memory image of W, element by element
  against the byte offsets the kernel computes (``kb32_offset`` of
  ``csrc/mma_sm90.cuh``), and its round trip through ``unpack_weights``;
- ``tile_schedule``: every tile of every sample exactly once, in the order
  the kernel's loop walks them;
- ``kernel_widths`` / ``route_for`` and kernel A's ``column_tile``.
"""
import numpy as np
import pytest
import torch

from focalformer3d_tpu_torch.ops import micro_dot
from focalformer3d_tpu_torch.ops import sparse_conv_cuda as k1


def _shares_numpy(rules, v_in):
    B, K, v_out = rules.shape
    hit = (rules >= 0) & (rules < v_in)
    out = {}
    for name, rows in (("tile", 128), ("group64", 64), ("strip16", 16),
                       ("site", 1)):
        n_groups = -(-v_out // 128) * (128 // rows)
        held = total = 0
        for b in range(B):
            for k in range(K):
                for g in range(n_groups):
                    total += 1
                    held += bool(hit[b, k, g * rows:(g + 1) * rows].any())
        out[name] = held / total
    return out


@pytest.mark.parametrize("v_out,miss", [(128, 0.5), (300, 0.9), (129, 0.0),
                                        (1, 0.3), (640, 0.97)])
def test_hit_shares_vs_numpy(v_out, miss):
    rng = np.random.RandomState(v_out)
    v_in = 77
    rules = rng.randint(0, v_in, size=(2, 5, v_out)).astype(np.int32)
    rules[rng.rand(2, 5, v_out) < miss] = v_in
    if v_out >= 256:
        rules[:, :, 128:256] = v_in  # a tile on which every tap misses
        rules[0, 2, 130] = -1  # a negative rule is a miss too
    got = k1.hit_shares(torch.from_numpy(rules), v_in)
    want = _shares_numpy(rules, v_in)
    assert set(got) == {"tile", "group64", "strip16", "site"}
    for name in want:
        assert got[name] == pytest.approx(want[name], abs=1e-6), name
    assert got["tile"] >= got["group64"] >= got["strip16"] >= got["site"]


def test_hit_shares_all_miss_and_all_hit():
    rules = torch.full((1, 27, 200), 50, dtype=torch.int32)
    assert set(k1.hit_shares(rules, 50).values()) == {0.0}
    got = k1.hit_shares(torch.zeros((1, 3, 256), dtype=torch.int32), 50)
    assert set(got.values()) == {1.0}


def _kb32_offset(rows, row, j, h):
    """``kb32_offset`` of ``csrc/mma_sm90.cuh``."""
    return (j * rows + row) * 32 + ((h ^ ((row >> 2) & 1)) << 4)


@pytest.mark.parametrize("K,C,cout", [(27, 16, 16), (3, 32, 64), (1, 64, 32),
                                      (27, 128, 128), (2, 48, 24)])
def test_pack_weights_is_the_shared_memory_image(K, C, cout):
    rng = np.random.RandomState(K * C + cout)
    w = torch.from_numpy(rng.randn(K, C, cout).astype(np.float32)).bfloat16()
    packed = k1.pack_weights(w)
    assert packed.shape == (K, C // 16, cout, 16) and packed.is_contiguous()
    assert torch.equal(k1.unpack_weights(packed), w)
    # W[k][cc][n] sits where the kernel reads element cc of row n of W[k]^T
    image = packed.reshape(K, -1).float().numpy()
    wn = w.float().numpy()
    for k in range(K):
        for cc in range(0, C, 5):
            for n in range(0, cout, 3):
                off = _kb32_offset(cout, n, cc // 16, (cc % 16) // 8) \
                    + (cc % 8) * 2
                assert image[k, off // 2] == wn[k, cc, n]


def test_pack_weights_rejects_ragged_widths():
    with pytest.raises(ValueError):
        k1.pack_weights(torch.zeros(27, 24, 16, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        k1.pack_weights(torch.zeros(27, 16, 12, dtype=torch.bfloat16))


@pytest.mark.parametrize("batch,v_out,grid", [(1, 1, 1), (2, 300, 4),
                                              (1, 5000, 264), (3, 129, 5),
                                              (2, 128, 7), (1, 1000, 3)])
def test_tile_schedule_visits_every_tile_once(batch, v_out, grid):
    blocks = k1.tile_schedule(batch, v_out, grid)
    assert len(blocks) == grid
    seen = [t for tiles in blocks for t in tiles]
    want = [(b, s) for b in range(batch) for s in range(0, v_out, k1.TILE)]
    assert sorted(seen) == want and len(set(seen)) == len(seen)
    # block i starts at tile i and strides by the grid, as the kernel does
    flat = {t: i for i, t in enumerate(want)}
    for i, tiles in enumerate(blocks):
        assert [flat[t] for t in tiles] == list(range(i, len(want), grid))


def test_kernel_widths_and_routes():
    assert k1.kernel_widths(5, 16) == (16, 16)
    assert k1.kernel_widths(8, 24) == (16, 32)
    assert k1.kernel_widths(64, 128) == (64, 128)
    assert k1.kernel_widths(256, 100) == (128, 128)
    for c in (16, 32, 64, 128):
        for cout in k1.COUTS:
            assert k1.route_for(c, cout) in k1.ROUTE_NAMES


@pytest.mark.parametrize("k,n,want", [(64, 128, 128), (64, 1536, 128),
                                      (1536, 128, 64), (1152, 128, 64),
                                      (80, 48, 16), (16, 32, 32),
                                      (6240, 16, 16), (6256, 16, 0)])
def test_column_tile(k, n, want):
    assert micro_dot.column_tile(k, n) == want


def test_dot_probe_rejects_unknown_route_and_deep_k():
    a = torch.zeros(1, 16, 16, dtype=torch.bfloat16)
    b = torch.zeros(16, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        micro_dot.dot_probe(a, b, 1, 1, 8, 0, route=2)
    deep = torch.zeros(1, 16, 6256, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        micro_dot.dot_probe(deep, torch.zeros(6256, 16, dtype=torch.bfloat16),
                            1, 1, 8, 0)
    for route in micro_dot.ROUTE_NAMES:  # on the CPU both are the plain one
        got = micro_dot.dot_probe(a + 1, b + 1, 2, 2, 8, 1, route=route)
        assert torch.equal(got, micro_dot.dot_probe_plain(a + 1, b + 1, 2, 8,
                                                          1))


def test_probe_takes_a_route_on_the_cpu():
    """On the CPU every route is the plain version; an unknown one is
    refused."""
    g = torch.Generator().manual_seed(0)
    f = torch.randn(1, 40, 16, generator=g).bfloat16()
    w = torch.randn(27, 16, 16, generator=g).bfloat16()
    rules = torch.randint(0, 41, (1, 27, 30), generator=g, dtype=torch.int32)
    valid = torch.ones(1, 30, dtype=torch.bool)
    ref = k1.sparse_conv_probe(f, rules, w, valid)
    for route in k1.ROUTE_NAMES:
        assert torch.equal(k1.sparse_conv_probe(f, rules, w, valid,
                                                route=route), ref)
    assert torch.equal(ref, k1.sparse_conv(f, rules, w, valid))
    with pytest.raises(ValueError):
        k1.sparse_conv_probe(f, rules, w, valid, route=2)

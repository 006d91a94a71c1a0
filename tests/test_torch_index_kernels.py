"""The index build's batched wrappers (``ops/plan_builder_cuda``) on the CPU.

``index_table`` and ``index_downsample`` launch CUDA kernels for tensors on
a card (``tests/test_torch_cuda.py`` holds them there against the torch
functions bit for bit); on the CPU they run those functions per sample.
Here: their argument checks, their CPU path against ``build_table_csr`` and
``build_downsample`` sample by sample (samples of different counts, an
empty one, voxels on every edge of the grid, a capacity that overflows),
and engine ``cuda``'s route to K2 (``conv_index``) against
``build_conv_rules``, through the encoder's levels as engine ``plain``
builds them.
"""
import numpy as np
import pytest
import torch

from focalformer3d_tpu_torch.models.sparse_encoder import (Level,
                                                           SparseEncoder,
                                                           conv_index)
from focalformer3d_tpu_torch.ops import plan_builder_cuda as pbc
from focalformer3d_tpu_torch.ops import sparse_conv as tsc

torch.set_num_threads(2)

SHAPE = (41, 20, 18)
CAP = 1200
# (kernel, stride, padding): down0 / down1, down2, conv_out
DOWN_GEOMS = {
    "down_p111": (3, 2, (1, 1, 1)),
    "down_p011": (3, 2, (0, 1, 1)),
    "conv_out": ((3, 1, 1), (2, 1, 1), 0),
}


def _sample(seed, n, shape=SHAPE, cap=CAP):
    """n unique voxels in CSR order, the grid's eight corners and a voxel
    on each face among them (n >= 14), padded to ``cap``; none for n = 0."""
    D, H, W = shape
    if n == 0:
        return np.zeros((cap, 3), np.int32), np.zeros(cap, bool)
    edges = [(z, y, x) for z in (0, D - 1) for y in (0, H - 1)
             for x in (0, W - 1)]
    edges += [(0, H // 2, W // 3), (D - 1, H // 3, W // 2),
              (D // 2, 0, W // 2), (D // 3, H - 1, W // 4),
              (D // 2, H // 2, 0), (D // 4, H // 3, W - 1)]
    keys = {(y * W + x) * D + z for z, y, x in edges}
    rng = np.random.RandomState(seed)
    while len(keys) < n:
        keys.add(int(rng.randint(D * H * W)))
    keys = np.sort(np.fromiter(keys, np.int64))
    z, yx = keys % D, keys // D
    coords = np.stack([z, yx // W, yx % W], -1).astype(np.int32)
    coords = np.pad(coords, ((0, cap - n), (0, 0)))
    return coords, np.arange(cap) < n


def _batch(counts, shape=SHAPE, cap=CAP):
    """A batch of samples of ``counts`` voxels each, as torch tensors."""
    parts = [_sample(7 + i, n, shape, cap) for i, n in enumerate(counts)]
    return (torch.from_numpy(np.stack([c for c, _ in parts])),
            torch.from_numpy(np.stack([v for _, v in parts])))


COUNTS = (900, 0, 37, 1200)


@pytest.mark.parametrize("case", [
    "coords_int64", "valid_uint8", "coords_strided", "valid_shape",
    "depth_65"])
@pytest.mark.parametrize("fn", ["table", "downsample"])
def test_wrappers_check_their_arguments(fn, case):
    coords, valid = _batch((40, 20))
    shape = SHAPE
    err = ValueError
    if case == "coords_int64":
        coords, err = coords.long(), TypeError
    elif case == "valid_uint8":
        valid, err = valid.to(torch.uint8), TypeError
    elif case == "coords_strided":
        coords = torch.cat([coords, coords], -1)[..., ::2]
    elif case == "valid_shape":
        valid = valid[:, :-1]
    else:
        shape = (65,) + SHAPE[1:]
    n0 = pbc.launch_count("table") + pbc.launch_count("downsample")
    with pytest.raises(err):
        if fn == "table":
            pbc.index_table(coords, valid, shape)
        else:
            pbc.index_downsample(coords, valid, shape, 3, 2, 1, 800)
    assert pbc.launch_count("table") + pbc.launch_count("downsample") == n0


def test_downsample_refuses_an_output_deeper_than_64():
    coords, valid = _batch((40,), shape=(64, 8, 8), cap=64)
    with pytest.raises(ValueError):  # (64 + 2 - 1) // 1 + 1 = 66 z levels
        pbc.index_downsample(coords, valid, (64, 8, 8), (1, 3, 3), 1,
                             (1, 1, 1), 64)


@pytest.mark.parametrize("shape", [SHAPE, (64, 9, 7)])
def test_batched_table_equals_build_table_csr(shape):
    coords, valid = _batch(COUNTS, shape)
    n0 = pbc.launch_count("table")
    meta = pbc.index_table(coords, valid, shape)
    assert pbc.launch_count("table") == n0  # CPU tensors: no launch
    assert meta.dtype == torch.int32
    assert meta.shape == (len(COUNTS), shape[1] * shape[2] + 1, 4)
    for b, n in enumerate(COUNTS):
        want = tsc.build_table_csr(coords[b], valid[b], shape).meta
        assert torch.equal(meta[b], want), b
        assert int(meta[b, -1, 2]) == n


@pytest.mark.parametrize("geom", list(DOWN_GEOMS))
@pytest.mark.parametrize("out_cap", [2400, 300])
def test_batched_downsample_equals_build_downsample(geom, out_cap):
    """Each sample's output sites, valid flags, overflow and meta; at 300
    the full samples overflow the output capacity."""
    ks, st, pad = DOWN_GEOMS[geom]
    coords, valid = _batch(COUNTS)
    n0 = pbc.launch_count("downsample")
    oc, ov, oshape, overflow, ometa = pbc.index_downsample(
        coords, valid, SHAPE, ks, st, pad, out_cap)
    assert pbc.launch_count("downsample") == n0
    assert overflow.dtype == torch.int64 and overflow.shape == (4,)
    for b in range(len(COUNTS)):
        want = tsc.build_downsample(coords[b], valid[b], SHAPE, ks, st, pad,
                                    out_cap)
        assert oshape == want[2]
        for got, ref in zip((oc[b], ov[b], overflow[b], ometa[b]),
                            (want[0], want[1], want[3], want[4])):
            assert got.dtype == ref.dtype and torch.equal(got, ref), b
    assert (int(overflow.max()) > 0) == (out_cap == 300)
    assert int(overflow[1]) == 0 and not ov[1].any()  # the empty sample


@pytest.mark.parametrize("geom", ["subm", *DOWN_GEOMS])
def test_cuda_route_equals_build_conv_rules_on_cpu(geom):
    """``conv_index(..., "cuda")`` (K2's plain version on the packed output
    sites) over levels built by the wrappers equals ``build_conv_rules``
    over the levels of the torch functions, sample by sample; both levels
    are equal bit for bit, overflow included."""
    coords, valid = _batch(COUNTS)
    levels = [Level.from_voxels(coords, valid, SHAPE, False, plain)
              for plain in (False, True)]
    if geom == "subm":
        ks, st, pad = 3, 1, 1
        dst = levels
    else:
        ks, st, pad = DOWN_GEOMS[geom]
        dst = [lvl.downsample(ks, st, pad, 300, plain)
               for lvl, plain in zip(levels, (False, True))]
    for a, b in ((levels[0], levels[1]), (dst[0], dst[1])):
        assert a.shape == b.shape
        for x, y in ((a.valid, b.valid), (a.meta, b.meta),
                     (a.coords, b.coords)):
            assert torch.equal(x, y)
    src = levels[1]
    got = conv_index(levels[0], dst[0], ks, st, pad, "cuda")
    assert got.dtype == torch.int32
    for b in range(len(COUNTS)):
        want = tsc.build_conv_rules(
            tsc.VoxelTable(src.coords[b], src.valid[b], src.meta[b]),
            SHAPE, dst[1].coords[b], dst[1].valid[b], ks, st, pad)
        assert torch.equal(got[b], want), b
    assert torch.equal(got, conv_index(src, dst[1], ks, st, pad, "plain"))


@pytest.mark.parametrize("train", [False, True])
def test_encoder_index_build_cuda_equals_plain_on_cpu(train):
    """The encoder's whole index build on ``cuda`` (the wrappers and K2's
    plain versions) equals ``plain``'s (the torch functions) block for
    block on a batch whose L1 overflows its capacity."""
    enc = SparseEncoder(in_channels=4, sparse_shape=SHAPE,
                        encoder_channels=((4, 4, 8), (8, 8, 8), (8, 8, 8),
                                          (8, 8)),
                        capacities=(CAP, 300, 200, 100), out_capacity=100,
                        dense_from=2, train_dense_from=3).train(train)
    coords, valid = _batch(COUNTS)
    blocks = {e: list(enc._index_build(coords, valid, e))
              for e in ("cuda", "plain")}
    assert len(blocks["cuda"]) == len(blocks["plain"]) == (6 if train else 4)
    for (lc, ic, _), (lp, ip, _) in zip(blocks["cuda"], blocks["plain"]):
        for x, y in ((lc.valid, lp.valid), (lc.meta, lp.meta),
                     (lc.coords, lp.coords), (ic, ip)):
            assert torch.equal(x, y)
    overflow = pbc.index_downsample(coords, valid, SHAPE, 3, 2, (1, 1, 1),
                                    300)[3]
    assert int(overflow.max()) > 0

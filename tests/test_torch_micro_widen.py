"""Parity: kernel C's plain version (the meta widening probe P9) against the
Pallas stencil ``widen_pallas`` (interpret mode on the CPU) and the XLA
``widen_concat`` of ``tools/micro_meta9.py``, bit for bit (int32 copies).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focalformer3d_tpu_torch.ops import micro_widen
from focalformer3d_tpu_torch.tools import micro_meta9
from tools import micro_meta9 as jax_probe

CPU = torch.device("cpu")


@pytest.mark.parametrize("fn", ["widen_pallas", "widen_concat"])
def test_widen_vs_jax(fn):
    W = 20
    meta = micro_meta9.meta_for(0, W)
    ref = np.asarray(getattr(jax_probe, fn)(jnp.asarray(meta), W))
    n0 = micro_widen.launch_count()
    got = micro_widen.widen_meta9(torch.from_numpy(meta), W)
    assert micro_widen.launch_count() == n0
    assert got.dtype == torch.int32 and got.shape == (W * W + W + 1, 36)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_widen_rows_are_the_nine_neighbours():
    W = 6
    meta = torch.from_numpy(micro_meta9.meta_for(1, W))
    got = micro_widen.widen_meta9(meta, W)
    # row r, tap (dy, dx) holds meta row r + dy*W + dx - (W + 1), or zeros
    for r in (0, W, W + 1, 17, W * W + W):
        for t in range(9):
            m = r + (t // 3) * W + t % 3 - (W + 1)
            want = meta[m] if 0 <= m < meta.shape[0] else torch.zeros(4)
            assert torch.equal(got[r, 4 * t:4 * t + 4], want.int())


@pytest.mark.parametrize("W", [W for W, _ in micro_meta9.SMALL_GRIDS])
def test_strided_view_equals_concat(W):
    """C's yardstick, one copy of a strided view of the padded meta, is
    ``widen_meta9_plain`` and the JAX ``widen_concat`` bit for bit."""
    meta = micro_meta9.meta_for(2, W)
    mp = micro_widen.padded_meta(torch.from_numpy(meta), W)
    n_rows = meta.shape[0] + W
    got = micro_meta9.strided_widen(mp, W, n_rows)
    assert got.shape == (n_rows, 36) and got.is_contiguous()
    assert torch.equal(got, micro_widen.widen_meta9_plain(
        torch.from_numpy(meta), W))
    ref = np.asarray(jax_probe.widen_concat(jnp.asarray(meta), W))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_run_small_on_cpu():
    rows = micro_meta9.run(CPU, "small")
    assert len(rows) == 10 and all(r["ok"] for r in rows)
    assert all(r["library_ms"] is None for r in rows)


def test_wrapper_checks():
    meta = torch.zeros(17, 4, dtype=torch.int32)
    with pytest.raises(TypeError):
        micro_widen.widen_meta9(meta.long(), 4)
    with pytest.raises(ValueError):
        micro_widen.widen_meta9(meta[:, :3].contiguous(), 4)
    with pytest.raises(ValueError):
        micro_widen.widen_meta9(meta, 0)


# kernel C's launch plan, and a model of how the kernel of
# csrc/micro_widen.cu maps its threads onto a tile (it runs only on a card)
TILE = micro_widen.TILE_ROWS
PLAN_SHAPES = [(1, 1), (2, 1), (5, 2), (10, 37), (37 * 37 + 1, 37),
               (TILE - 1, 1), (TILE + 1, 1), (TILE - 1, 37), (TILE + 1, 37),
               (TILE - 2, 1), (TILE - 37 + 1, 37),  # n_meta + W = TILE +- 1
               (129_601, 360), (518_401, 720), (2_073_601, 1440)]


@pytest.mark.parametrize("n_meta,W", PLAN_SHAPES)
def test_widen_plan_tiles_cover_rows_once(n_meta, W):
    plan = micro_widen.widen_plan(n_meta, W)
    R, n_rows = plan["tile_rows"], n_meta + W
    assert plan["route"] == micro_widen.DIRECT
    assert R % micro_widen.PASS_ROWS == 0
    starts = np.arange(plan["grid"]) * R
    stops = np.minimum(starts + R, n_rows)
    assert (stops > starts).all()  # no tile is empty
    covered = np.zeros(n_rows, np.int64)
    for a, b in zip(starts, stops):
        covered[a:b] += 1
    assert (covered == 1).all()


def _kernel_model(meta: np.ndarray, W: int):
    """The kernel's loads and stores, thread by thread: a block of 288
    threads takes a tile of rows; in each 32-row pass thread k reads meta
    row r + (t // 3 - 1) W + t % 3 - 1 (t = k % 9, r the pass's row k // 9;
    zeros outside the meta) and stores it to 16-byte chunk 9 r + t. Returns
    the output, the chunks each warp store covers, and per tile the meta
    rows its loads read."""
    n_meta = meta.shape[0]
    plan = micro_widen.widen_plan(n_meta, W)
    R, n_rows = plan["tile_rows"], n_meta + W
    out = np.full((n_rows * 9, 4), -1, np.int64)
    k = np.arange(288)
    row, t = k // 9, k % 9
    off = (t // 3 - 1) * W + t % 3 - 1
    warps, reads = [], []
    for tile in range(plan["grid"]):
        r0 = tile * R
        read = set()
        for p in range(r0, min(r0 + R, n_rows), micro_widen.PASS_ROWS):
            r = p + row
            live = r < n_rows
            m = r + off
            inside = live & (m >= 0) & (m < n_meta)
            chunk = r0 * 9 + (p - r0) * 9 + k  # the kernel's store address
            assert (chunk[live] == 9 * r[live] + t[live]).all()
            assert (out[chunk[live]] == -1).all()  # each chunk stored once
            out[chunk[live]] = np.where(inside[live, None],
                                        meta[np.clip(m[live], 0,
                                                     n_meta - 1)], 0)
            warps += [chunk[w:w + 32][live[w:w + 32]]
                      for w in range(0, 288, 32)]
            read |= set(m[inside].tolist())
        reads.append(read)
    return out.reshape(n_rows, 36), warps, reads, R


@pytest.mark.parametrize("n_meta,W", [s for s in PLAN_SHAPES
                                      if s[0] < 10_000])
def test_widen_kernel_model_equals_plain(n_meta, W):
    """The model of the kernel's threads writes every output chunk once and
    gives ``widen_meta9_plain`` exactly; every full warp store is 512
    contiguous bytes on a 512-byte boundary; each tile's loads fall in its
    three strips of R + 2 meta rows, rows r0 + (dy - 1) W - 1 onward."""
    meta = np.random.RandomState(3).randint(
        0, 2**30, size=(n_meta, 4)).astype(np.int32)
    got, warps, reads, R = _kernel_model(meta, W)
    ref = micro_widen.widen_meta9_plain(torch.from_numpy(meta), W)
    np.testing.assert_array_equal(got, ref.numpy())
    for chunks in warps:
        if len(chunks) == 32:
            assert chunks[0] % 32 == 0
            assert (np.diff(chunks) == 1).all()
    for tile, read in enumerate(reads):
        r0 = tile * R
        strips = set()
        for dy in range(3):
            start = r0 + (dy - 1) * W - 1
            strips |= set(range(start, start + R + 2))
        assert read <= strips


@pytest.mark.parametrize("W", [1, 360, 720, 1440])
def test_widen_plan_shared_bytes(W):
    plan = micro_widen.widen_plan(W * W + 1, W)
    assert plan["smem_bytes"] == 0 < 227 * 1024
    assert plan["grid"] * plan["tile_rows"] >= W * W + 1 + W


@pytest.mark.parametrize("route", [-1, 1, 2])
def test_widen_unknown_route_raises(route):
    meta = torch.zeros(17, 4, dtype=torch.int32)
    with pytest.raises(ValueError):
        micro_widen.widen_plan(17, 4, route)
    with pytest.raises(ValueError):
        micro_widen.widen_meta9(meta, 4, route=route)

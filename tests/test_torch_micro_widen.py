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

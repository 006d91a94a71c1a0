"""Parity: kernel B's plain versions (the gather probes P6, P7) against the
Pallas probes in interpret mode and the JAX functions they compute.

P6: the three Pallas kernels of ``tools/micro_gather_kernel.py``, run
through its ``run`` (interpret mode on the CPU) at T=16, K=27, 2 tiles, a
W=64 window, pack 4 and 1, against ``gather_taps`` with ``div = pack``
(the one-hot kernel) and ``div = 1`` (the takes), within one bf16 ulp of
the output's scale (the sums round once to bf16, in another order). P7:
``kernel`` and ``kernel2`` are local to ``tools/micro_gather2.py:main``;
they compute ``jnp.take(x, idx, axis=0)``, held exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focalformer3d_tpu_torch.ops import micro_gather
from focalformer3d_tpu_torch.tools import micro_gather2, micro_gather_kernel
from tools import micro_gather_kernel as jax_probe

CPU = torch.device("cpu")
KERNELS = {"ohdot": jax_probe._ohdot_kernel, "take": jax_probe._take_kernel,
           "takerow": jax_probe._takerow_kernel}


@pytest.mark.parametrize("pack", [4, 1])
@pytest.mark.parametrize("name", list(KERNELS))
def test_gather_taps_vs_pallas_interpret(name, pack):
    T, K, n_tiles, W, cl = 16, 27, 2, 64, 32
    rel, xw = micro_gather_kernel.operands(pack, n_tiles, T, K, W, cl, pack)
    wb = W // pack
    ref = jax_probe.run(KERNELS[name], jnp.asarray(rel),
                        jnp.asarray(xw, jnp.bfloat16), T, K, wb, pack,
                        n_tiles)
    ref = np.asarray(ref.astype(jnp.float32))
    div = pack if name == "ohdot" else 1
    n0 = micro_gather.launch_count("taps")
    got = micro_gather.gather_taps(torch.from_numpy(rel),
                                   torch.from_numpy(xw).to(torch.bfloat16),
                                   div)
    assert micro_gather.launch_count("taps") == n0
    assert got.dtype == torch.bfloat16 and got.shape == (n_tiles, T, cl)
    scale = np.abs(ref).max()
    ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=ulp)


def test_ohdot_and_take_are_two_functions_for_pack_gt_1():
    rel, xw = micro_gather_kernel.operands(0, 2, 16, 27, 64, 32, 4)
    rel, xw = torch.from_numpy(rel), torch.from_numpy(xw).bfloat16()
    assert not torch.equal(micro_gather.gather_taps(rel, xw, 4),
                           micro_gather.gather_taps(rel, xw, 1))


def test_gather_taps_misses_read_zero_rows():
    xw = torch.arange(8 * 8, dtype=torch.float32).reshape(8, 8).bfloat16()
    rel = torch.tensor([[[1, -3, 8, 40], [2, 2, 2, 2]]], dtype=torch.int32)
    got = micro_gather.gather_taps(rel, xw, 1)
    np.testing.assert_array_equal(got[0, 0].float().numpy(),
                                  xw[1].float().numpy())
    np.testing.assert_array_equal(got[0, 1].float().numpy(),
                                  4 * xw[2].float().numpy())


def test_gather_rows_vs_jnp_take():
    x, idx = micro_gather2.table_rows(3, 256, 32, 1024)
    ref = np.asarray(jnp.take(jnp.asarray(x, jnp.bfloat16),
                              jnp.asarray(idx), axis=0).astype(jnp.float32))
    n0 = micro_gather.launch_count("rows")
    got = micro_gather.gather_rows(torch.from_numpy(x).bfloat16(),
                                   torch.from_numpy(idx))
    assert micro_gather.launch_count("rows") == n0
    np.testing.assert_array_equal(got.float().numpy(), ref)


def test_row_gather_bound_reads_each_table_row_once():
    """The bound of a row gather reads each distinct row of the table once,
    however often it is gathered: 4 distinct rows of 16 bf16 values, 10
    int32 indices, 10 rows written."""
    x = torch.zeros(50, 16, dtype=torch.bfloat16)
    idx = torch.tensor([3, 3, 7, 7, 7, 9, 1, 1, 3, 9], dtype=torch.int32)
    assert micro_gather2.table_bytes(idx, 16) == 4 * 16 * 2
    row = micro_gather2._rows_case(CPU, "t", x, idx)
    want = (10 * 4 + 4 * 16 * 2 + 10 * 16 * 2) / 3.35e12 * 1e3
    assert row["bound_by"] == "bytes"
    assert row["bound_ms"] == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("module", [micro_gather_kernel, micro_gather2])
def test_run_small_on_cpu(module):
    rows = module.run(CPU, "small")
    assert rows and all(r["ok"] for r in rows)
    assert all(r["ms"] is None and r["library_ms"] is None for r in rows)


def test_wrapper_checks():
    rel = torch.zeros(2, 4, 3, dtype=torch.int32)
    xw = torch.zeros(8, 16, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        micro_gather.gather_taps(rel.long(), xw, 1)
    with pytest.raises(ValueError):  # rows not a multiple of 8 values
        micro_gather.gather_taps(rel, xw[:, :12].contiguous(), 1)
    with pytest.raises(ValueError):  # larger than shared memory
        micro_gather.gather_taps(
            rel, torch.zeros(1024, 128, dtype=torch.bfloat16), 1)
    with pytest.raises(ValueError):
        micro_gather.gather_taps(rel, xw, 0)
    with pytest.raises(TypeError):
        micro_gather.gather_rows(xw.float(), rel[0, 0])
    with pytest.raises(ValueError):
        micro_gather.gather_rows(xw, rel[0])


# ---------------------------------------------------------------------------
# the host-side choices of the redesigned kernels (the kernels run only on
# the card; tests/test_torch_cuda.py holds them)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [1, 2, 3, 4, 5, 7, 8, 16, 27, 100, 127, 128,
                               1000, 2**16 + 1, 2**30 + 3, 2**31 - 1])
def test_fast_div_magic_divides_every_int32(d):
    m, l = micro_gather.fast_div_magic(d)
    assert 0 < m < 2**32 and 0 <= l <= 31
    rng = np.random.RandomState(d % 1000)
    ns = np.concatenate([np.arange(min(3 * d + 3, 5000)),
                         [2**31 - 1, 2**31 - 2], d * np.arange(1, 50),
                         d * np.arange(1, 50) - 1,
                         rng.randint(0, 2**31 - 1, 2000)])
    ns = ns[(ns >= 0) & (ns < 2**31)].astype(np.uint64)
    got = (((ns * np.uint64(m)) >> np.uint64(32)) + ns) >> np.uint64(l)
    np.testing.assert_array_equal(got, ns // np.uint64(d))


def test_rows_lanes_cover_every_width():
    """Every width C % 8 == 0 up to 4096 maps to a lane group that divides
    32 and covers the row's 16-byte chunks with the fewest lanes, or to a
    whole warp from 32 chunks (512 B) on."""
    for C in range(8, 4097, 8):
        lanes, chunks = micro_gather.rows_lanes(C), C // 8
        assert lanes in (1, 2, 4, 8, 16, 32), C
        if chunks >= 32:
            assert lanes == 32, C
        else:
            assert lanes >= chunks and (lanes == 1 or lanes // 2 < chunks), C


def test_rows_plan_routes():
    for C in (8, 32, 512, 1000, 2048, 4096, 2**15):
        plan = micro_gather.rows_plan(C)
        assert plan["name"] == micro_gather.ROWS_ROUTE_NAMES[plan["route"]]
        bulk = micro_gather.rows_plan(C, micro_gather.ROWS_BULK)
        assert bulk["name"] == "bulk" and 1 <= bulk["bulk_rows"] <= 32
        # a block's row buffers and 32 mbarriers fit its shared memory
        assert 256 + bulk["bulk_rows"] * C * 2 <= micro_gather.SMEM_BYTES
    with pytest.raises(ValueError):
        micro_gather.rows_plan(64, route=2)


def test_taps_plan_every_window_fits():
    """Every window the wrapper accepts (L % 8 == 0, R * L * 2 <= 227 KB)
    gets a route, at P6's K and at the most taps the wrapper takes, whose
    shared memory fits 232 448 bytes, with stages of at least one row; the
    shared-memory route wherever the window, its zero row and two full
    stages fit."""
    S = micro_gather.SMEM_BYTES
    for L in range(8, micro_gather.MAX_WINDOW_BYTES // 2 + 1, 8):
        r_max = micro_gather.MAX_WINDOW_BYTES // (2 * L)
        for R in {1, max(1, r_max // 2), r_max}:
            for K in (1, 27, 28, micro_gather.MAX_TAPS):
                plan = micro_gather.taps_plan(R, L, K)
                assert plan["smem_bytes"] <= S, (R, L, K)
                assert plan["stage_rows"] >= 1
                assert plan["smem_bytes"] == micro_gather.taps_smem_bytes(
                    plan["route"], R, L, K, plan["stage_rows"])
                full = micro_gather.taps_smem_bytes(
                    micro_gather.TAPS_SMEM, R, L, K,
                    micro_gather.TAPS_STAGE_ROWS)
                assert (plan["name"] == "smem") == (full <= S), (R, L, K)


def test_taps_plan_at_p6_shapes():
    T, K = micro_gather_kernel.T, micro_gather_kernel.K
    for W, cl, _pack in micro_gather_kernel.CONFIGS:
        plan = micro_gather.taps_plan(W, cl, K)
        assert plan["name"] == "smem"
        assert plan["stage_rows"] == micro_gather.TAPS_STAGE_ROWS
        assert plan["smem_bytes"] == (W + 1) * cl * 2 + 2 * 64 * K * 4
        forced = micro_gather.taps_plan(W, cl, K, micro_gather.TAPS_GLOBAL)
        assert forced["name"] == "global"
        assert forced["smem_bytes"] == 2 * 64 * K * 4
    # 64-row stages start on 16-byte boundaries at any K: 64 * K * 4 bytes
    assert micro_gather.TAPS_STAGE_ROWS % 4 == 0
    assert T % micro_gather.TAPS_STAGE_ROWS == 0
    # a 227 KB window leaves no room: the global route, or a refusal
    assert micro_gather.taps_plan(908, 128, K)["name"] == "global"
    with pytest.raises(ValueError):
        micro_gather.taps_plan(908, 128, K, micro_gather.TAPS_SMEM)
    with pytest.raises(ValueError):
        micro_gather.taps_plan(8, 8, K, route=2)
    # stages shrink on the global route until two fit
    assert micro_gather.taps_plan(8, 16, micro_gather.MAX_TAPS)[
        "stage_rows"] == 4


def test_route_arguments_on_cpu():
    """On CPU tensors a forced route runs the plain version all the same;
    a route that is not one, or K past ``MAX_TAPS``, raises on any
    device."""
    rel, xw = micro_gather_kernel.operands(3, 2, 16, 27, 64, 32, 4)
    rel, xw = torch.from_numpy(rel), torch.from_numpy(xw).bfloat16()
    ref = micro_gather.gather_taps_plain(rel, xw, 4)
    for route in micro_gather.TAPS_ROUTE_NAMES:
        assert torch.equal(micro_gather.gather_taps(rel, xw, 4, route), ref)
    with pytest.raises(ValueError):
        micro_gather.gather_taps(rel, xw, 4, route=5)
    with pytest.raises(ValueError):
        micro_gather.gather_taps(
            torch.zeros(1, 1, micro_gather.MAX_TAPS + 1, dtype=torch.int32),
            xw, 1)
    x, idx = micro_gather2.table_rows(4, 100, 24, 300)
    x, idx = torch.from_numpy(x).bfloat16(), torch.from_numpy(idx)
    for route in micro_gather.ROWS_ROUTE_NAMES:
        assert torch.equal(micro_gather.gather_rows(x, idx, route),
                           micro_gather.gather_rows_plain(x, idx))
    with pytest.raises(ValueError):
        micro_gather.gather_rows(x, idx, route=-1)

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

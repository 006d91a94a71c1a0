"""Parity: kernel A's plain version (the dot-shape probe of P1a, P2, P3)
against the JAX functions the Pallas probes compute.

P1a's ``gk`` is local to ``tools/micro_mxu_probe.py:probe_matmuls`` and P2's
and P3's kernels run at import, so they are held against what they
compute: ``jnp.dot(..., preferred_element_type=float32)`` of the last
tile (``gk``) and the sum over r of ``jnp.dot(a + bfloat16(r), b)[:8]``
(P2, P3), on the same numpy inputs. Tolerance 1e-5 of the output's scale:
products of bf16 values are exact in f32 and only the order of the f32
sums differs. The kernel itself runs only on a card
(``tests/test_torch_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focalformer3d_tpu_torch.ops import cuda_build, micro_dot
from focalformer3d_tpu_torch.tools import micro_dotshape, micro_dotshape2

CPU = torch.device("cpu")


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_gk_is_the_last_tiles_product():
    a, b = micro_dotshape.operands(0, 4, 32, 16, 32)
    ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    ref = jnp.dot(ja[3], jb, preferred_element_type=jnp.float32)
    n0 = micro_dot.launch_count()
    got = micro_dot.dot_probe(_bf16(a), _bf16(b), 4, 1, 32, 3)
    assert micro_dot.launch_count() == n0  # the CPU runs the plain version
    assert got.dtype == torch.float32 and got.shape == (32, 32)
    _close(got, ref)


@pytest.mark.parametrize("seed,shape", list(enumerate(
    micro_dotshape.SMALL_SHAPES)) + [(9, (256, 64, 128, 27))])
def test_shifted_sums_vs_jax(seed, shape):
    m, k, n, reps = shape
    a, b = micro_dotshape.operands(seed, 1, m, k, n)
    ja, jb = jnp.asarray(a[0], jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)

    @jax.jit
    def outer(ja, jb):  # the body of micro_dotshape2._outer
        acc = jnp.zeros((8, n), jnp.float32)
        for r in range(reps):
            acc = acc + jnp.dot(ja + jnp.bfloat16(r), jb,
                                preferred_element_type=jnp.float32)[:8]
        return acc

    got = micro_dot.dot_probe(_bf16(a), _bf16(b), 3, reps, 8, 0)
    _close(got, outer(ja, jb))


@pytest.mark.parametrize("module", [micro_dotshape, micro_dotshape2])
def test_run_small_on_cpu(module):
    rows = module.run(CPU, "small")
    assert rows and all(r["ok"] for r in rows)
    assert all(r["kernel"] == "micro_dot" for r in rows)
    # nothing is timed on the CPU
    assert all(r["ms"] is None and r["rate"] is None for r in rows)


def test_launch_counter_counts_each_replay_of_a_capture():
    """Calls made while a graph is captured launch nothing; each replay of
    the graph counts them once."""
    counter = cuda_build.Launches("k")
    cuda_build.take_captured()
    counter.captured["k"] += 3  # three calls made while capturing
    taken = cuda_build.take_captured()
    assert counter.captured["k"] == 0 and counter.counts["k"] == 0
    cuda_build.add_replays(taken, 2)
    assert counter.counts["k"] == 6
    counter.reset()
    assert counter.counts["k"] == 0


def test_wrapper_checks():
    a, b = micro_dotshape.operands(0, 2, 32, 16, 32)
    a, b = _bf16(a), _bf16(b)
    with pytest.raises(TypeError):
        micro_dot.dot_probe(a.float(), b, 2, 1, 8, 0)
    with pytest.raises(ValueError):  # K not a multiple of 16
        micro_dot.dot_probe(a[..., :8].contiguous(), b[:8], 2, 1, 8, 0)
    with pytest.raises(ValueError):  # more rows than M
        micro_dot.dot_probe(a, b, 2, 1, 33, 0)
    with pytest.raises(ValueError):  # no such block
        micro_dot.dot_probe(a, b, 2, 1, 8, 2)
    with pytest.raises(ValueError):
        micro_dot.dot_probe(a.transpose(1, 2), b, 2, 1, 8, 0)

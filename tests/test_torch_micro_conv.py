"""Parity: K1's phase probe (``sparse_conv_cuda.sparse_conv_probe``, the
counterpart of P1b, P4, P5 and P8) and the probes' voxel sets, against the
JAX package and the Pallas probes.

- P1b: ``tools/micro_mxu_probe.py``'s ``make_level`` and ``run_variant``
  (interpret mode on the CPU) in the modes full, pertap, merged and dbuf
  against the probe's full mode on the port's ``make_level`` (the same
  numpy draws), at the valid sites, within 1e-3 of the output's scale (as
  ``tests/test_torch_sparse_conv.py`` holds K1 against the Pallas kernel);
  the plan has no spills there, since ``run_variant`` omits the spill fix.
- P4, P5, P8 hard-code the TPU or read argv at import; their full mode is
  K1's function, held against ``sparse_conv.apply_conv`` in f32 on the
  bf16 values (1e-5 of scale): at each conv geometry of P4's Tiny_L scan,
  on P5's clustered set (its rulebook equal to the one JAX builds through
  ``build_table`` and ``csr_reorder``), and per sample of P8's batch of two.
- The modes with a phase off compute zeros (no bias) or the bias.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focalformer3d_tpu.ops import sparse_conv as jsc
from focalformer3d_tpu.ops import sparse_conv_pallas as scp
from focalformer3d_tpu_torch.ops import sparse_conv_cuda as k1
from focalformer3d_tpu_torch.tools import (_common, micro_batch_grid,
                                           micro_kernel_v2, micro_mxu_probe,
                                           micro_pallas_attr)
from tools import micro_mxu_probe as jax_probe

CPU = torch.device("cpu")
LEVEL = (600, 16, 16, (5, 40, 40))


def _vs_apply_conv(feats, rules, w, valid, got):
    """got (V_out, Cout) against JAX's exact engine on the bf16 values."""
    ref = np.asarray(jsc.apply_conv(
        jnp.asarray(feats.float().numpy()), jnp.asarray(rules.numpy()),
        jnp.asarray(w.float().numpy()), jnp.asarray(valid.numpy())))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


@pytest.fixture(scope="module")
def level():
    """The P1b level on both sides, from the same seed."""
    v, c, cout, shape = LEVEL
    jfeats, plan, jw, jvalid = jax_probe.make_level(
        np.random.RandomState(0), v, c, cout, shape, 512)
    feats, rules, w, valid = _common.make_level(
        np.random.RandomState(0), v, c, cout, shape, CPU)
    np.testing.assert_array_equal(feats.numpy(), np.asarray(jfeats))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert int(plan.n_overflow) == 0  # run_variant has no spill fix
    return jfeats, plan, jw, feats, rules, w, valid


@pytest.mark.parametrize("mode", ["full", "pertap", "merged", "dbuf"])
def test_run_variant_vs_probe_full(level, mode):
    jfeats, plan, jw, feats, rules, w, valid = level
    fp, wp = scp._pad_c(jfeats, 1), scp._pad_c(jw, 1)
    ref = np.asarray(jax_probe.run_variant(fp, plan, wp, fp.shape[0], mode))
    n0 = k1.launch_count("probe")
    got = k1.sparse_conv_probe(feats.bfloat16()[None], rules[None],
                               w.bfloat16(), valid[None])[0]
    assert k1.launch_count("probe") == n0
    n = int(valid.sum())
    ref = ref[:n]
    np.testing.assert_allclose(got[:n].numpy(), ref, rtol=0,
                               atol=1e-3 * np.abs(ref).max())


def test_phase_off_modes_compute_the_bias(level):
    _, _, _, feats, rules, w, valid = level
    bias = torch.arange(w.shape[2], dtype=torch.float32)
    for phases in (0, k1.PHASE_GATHER, k1.PHASE_MMA):
        got = k1.sparse_conv_probe(feats.bfloat16()[None], rules[None],
                                   w.bfloat16(), valid[None], bias, phases)
        want = torch.where(valid[:, None], bias, 0.0)[None]
        assert torch.equal(got, want)
    with pytest.raises(ValueError):
        k1.sparse_conv_probe(feats.bfloat16()[None], rules[None],
                             w.bfloat16(), valid[None], phases=4)


def test_p4_geometries_vs_apply_conv():
    geoms = list(micro_kernel_v2.geometries(CPU, "small"))
    assert len(geoms) == 6  # subm and strided conv of levels 0-2
    for name, x, rules, w, valid in geoms:
        got = k1.sparse_conv_probe(x, rules, w, valid)[0]
        _vs_apply_conv(x[0], rules[0], w, valid[0], got)


def test_p5_clustered_set_vs_jax():
    v, c, shape = micro_pallas_attr.SMALL_SET
    rng = np.random.RandomState(0)  # the draws of micro_pallas_attr.main
    D, H, W = shape
    ncol = v // 2
    cols = rng.choice(H * W, size=ncol, replace=False)
    z = rng.randint(0, D, size=(ncol, 2))
    keys = np.unique((np.repeat(cols, 2) * D + z.reshape(-1))
                     .astype(np.int64))
    rng.shuffle(keys)
    keys = keys[:v]
    n = len(keys)
    coords = np.stack([keys % D, keys // D // W, (keys // D) % W],
                      -1).astype(np.int32)
    coords = jnp.asarray(np.pad(coords, ((0, v - n), (0, 0))))
    valid = jnp.asarray(np.arange(v) < n)
    jfeats = jnp.asarray(rng.randn(v, c).astype(np.float32)).astype(
        jnp.bfloat16)
    jw = jnp.asarray(rng.randn(27, c, c).astype(np.float32) * 0.05).astype(
        jnp.bfloat16)
    table0 = jsc.build_table(coords, valid, shape)
    coords, valid, jfeats = jsc.csr_reorder(table0, jfeats)
    table = jsc.build_table(coords, valid, shape)
    jrules = jsc.build_subm_rules(table, shape, 3, use_positions=True)

    feats, rules, w, tvalid = _common.clustered_set(
        np.random.RandomState(0), v, c, shape, CPU)
    np.testing.assert_array_equal(rules.numpy(), np.asarray(jrules))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(valid))
    np.testing.assert_array_equal(
        feats.bfloat16().float().numpy(),
        np.asarray(jfeats.astype(jnp.float32)))
    np.testing.assert_array_equal(w.bfloat16().float().numpy(),
                                  np.asarray(jw.astype(jnp.float32)))
    got = k1.sparse_conv_probe(feats.bfloat16()[None], rules[None],
                               w.bfloat16(), tvalid[None])[0]
    _vs_apply_conv(feats.bfloat16(), rules, w.bfloat16(), tvalid, got)


def test_p8_batch_of_two_vs_apply_conv():
    v, c, cout, shape = LEVEL
    rng = np.random.RandomState(0)
    samples = [_common.make_level(rng, v, c, cout, shape, CPU)
               for _ in range(2)]
    feats = torch.stack([s[0] for s in samples]).bfloat16()
    rules = torch.stack([s[1] for s in samples])
    valid = torch.stack([s[3] for s in samples])
    w = samples[0][2].bfloat16()
    got = k1.sparse_conv_probe(feats, rules, w, valid)
    for b in range(2):
        _vs_apply_conv(feats[b], rules[b], w, valid[b], got[b])


@pytest.mark.parametrize("module", [micro_mxu_probe, micro_kernel_v2,
                                    micro_pallas_attr, micro_batch_grid])
def test_run_small_on_cpu(module):
    rows = module.run(CPU, "small")
    assert rows and all(r["ok"] for r in rows)
    assert all(r["ms"] is None and r["plain_ms"] is None for r in rows)
    full = [r for r in rows if r.get("mode") == "full"]
    assert full and all(r["equal_k1"] for r in full)

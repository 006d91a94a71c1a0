"""Training on the kernel engines ``cuda_mxu`` and ``cuda_zrun``, on the CPU.

On CPU tensors every kernel wrapper runs its plain version, so these tests
hold the engines' training paths (index, backward rulebooks, the autograd
Functions) and leave the kernels to ``tests/test_torch_cuda.py``:

- ``zrun_conv_train`` (K3 forward, K1's dx and dW on ``zrun_rules``)
  against autograd through ``apply_conv_bf16_plain`` on ``zrun_rules``:
  the forward bit for bit (the same gather + matmul), dx and dW within
  1e-5 of each gradient's scale (the transposed rulebook's sums and dW's
  split of the cotangent into two bf16 parts, 2^-16 of it, take another
  order and rounding than autograd's);
- the transposed rulebooks of the meta chain's strided convs
  (``backward_index`` of K2's rulebook) equal ``transpose_rules`` of
  ``build_conv_rules`` in both packages, bit for bit;
- one Tiny_L ``make_train_step`` step: ``cuda_zrun`` equals ``cuda`` (the
  same plain functions at the same dense boundary, L3: z-run codes expand
  to the rulebook ``build_conv_rules`` gives, taps in the same dz-major
  order) and ``cuda_mxu`` equals ``cuda`` with ``train_dense_from=4`` (K2's
  plain version decodes ``build_conv_rules``' rulebooks), bit for bit in
  every metric, gradient and updated tensor;
- the training encoder of each engine against JAX ``voxel`` at the same
  dense boundary (``cuda_zrun`` dense from L3, ``cuda_mxu`` all-sparse
  against ``dense_from=4``): the BEV, every parameter gradient for one
  random cotangent and the updated batch-norm statistics. JAX ``voxel``
  computes in float32; the kernel engines round every sparse conv's
  features and weights to bf16 (relative error up to 2^-9) and the dx
  cotangent too. Through ~20 convs with training batch norms between them
  (whose backward removes the cotangent's mean and its projection on the
  normalised features, so small gradients are differences of large terms)
  such roundings move the result far more than 2^-9: perturbing only the
  weights of the float32 path by 2^-9 relative noise moves its BEV by
  ~1e-2 of scale and its gradients by ~12% (median over tensors, up to
  ~30%) of their norm. So the tolerance is that calibration, made in the
  test: the engine's distance from JAX, per tensor and by norm, may be at
  most ``CALIBRATION`` (2) times the distance that a 2^-9 perturbation of
  the weights moves the port's float32 ``plain`` path (itself within 2e-6
  of JAX), in the median over tensors and at the worst tensor; the BEV
  and the statistics likewise.

Capacities hold every level of the scans (asserted): past a capacity the
meta chain keeps dropped voxels that ``build_downsample`` drops (ROADMAP.md
Queue 3), and the engines' active sets would part.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focalformer3d_tpu.models.sparse_encoder import SparseEncoder as JaxEnc
from focalformer3d_tpu.ops import sparse_conv as jsc
from focalformer3d_tpu.ops import sparse_conv_pallas as scp
from focalformer3d_tpu.utils.convert import convert_tree
from focalformer3d_tpu_torch import configs as tconfigs
from focalformer3d_tpu_torch.data import synthetic
from focalformer3d_tpu_torch.models import detector as tdet
from focalformer3d_tpu_torch.models import sparse_encoder as tse
from focalformer3d_tpu_torch.ops import sparse_conv as tsc
from focalformer3d_tpu_torch.ops import sparse_conv_cuda as k1
from focalformer3d_tpu_torch.ops import sparse_conv_zrun as tzr
from focalformer3d_tpu_torch.ops import sparse_conv_zrun_cuda as k3
from focalformer3d_tpu_torch.training import losses as tlosses
from focalformer3d_tpu_torch.training import optim as toptim
from focalformer3d_tpu_torch.training import train_step as tstep
from focalformer3d_tpu_torch.utils import jax_keys
from focalformer3d_tpu_torch.utils.convert import from_flax
from focalformer3d_tpu_torch.utils.ref_keys import make_fake_state_dict

torch.set_num_threads(2)
TOL = 1e-5
CALIBRATION = 2.0
BF16_REL = 2.0 ** -9
# capacities that hold every level of the two 2000-point scans
CAPS = dict(capacities=(512, 1024, 1024, 512), out_capacity=512)
GEOMS = {
    "subm": (3, 1, (1, 1, 1)),
    "down_p111": (3, 2, (1, 1, 1)),
    "down_p011": (3, 2, (0, 1, 1)),
    "conv_out": ((3, 1, 1), (2, 1, 1), 0),
}


def _cfg(engine, dense_from=None):
    cfg = tconfigs.get_config("Tiny_L")["model"]
    return dataclasses.replace(
        cfg, sparse_engine=engine,
        sparse_dense_from=dense_from or cfg.sparse_dense_from, **CAPS)


def _batch():
    cfg = _cfg("plain")
    b = synthetic.make_batch(
        np.random.RandomState(5), batch_size=2, n_points=2000, n_boxes=4,
        max_gts=8, num_classes=cfg.decoder.num_classes,
        pc_range=cfg.voxel.point_cloud_range, mode="radial")
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _voxels():
    batch = _batch()
    vox = tdet.preprocess_points(_cfg("plain"), batch["points"],
                                 batch["points_mask"], train=True)
    return vox["features"], vox["coords"], vox["voxel_mask"]


def _encoder(engine, dense_from, sd=None):
    cfg = _cfg(engine, dense_from)
    enc = tse.SparseEncoder(
        in_channels=cfg.point_dim, sparse_shape=cfg.sparse_shape,
        output_channels=cfg.sparse_out_channels,
        encoder_channels=cfg.encoder_channels,
        down_paddings=cfg.down_paddings, capacities=cfg.capacities,
        out_capacity=cfg.out_capacity, engine=engine,
        dense_from=cfg.sparse_dense_from_eval, train_dense_from=dense_from)
    if sd is not None:
        enc.load_state_dict(sd, strict=True)
    return enc.train()


def _no_overflow(levels):
    for lvl in levels:
        total = lvl.meta[:, -2, 2].long() + lvl.meta[:, -2, 3]
        if lvl is not levels[0]:
            assert bool((total <= lvl.capacity).all()), (
                lvl.shape, total.tolist(), lvl.capacity)


# ---------------------------------------------------------------------------
# zrun_conv_train against its plain version
# ---------------------------------------------------------------------------

def _zrun_geometry(geom, seed=3, cap=384, cap_out=320, shape=(9, 16, 16)):
    D, H, W = shape
    rng = np.random.RandomState(seed)
    keys = np.sort(rng.choice(D * H * W, size=300, replace=False))
    z, yx = keys % D, keys // D
    coords = torch.from_numpy(np.pad(
        np.stack([z, yx // W, yx % W], -1).astype(np.int32),
        ((0, cap - 300), (0, 0))))
    valid = torch.arange(cap) < 300
    ks, st, pad = GEOMS[geom]
    table = tsc.build_table_csr(coords, valid, shape)
    if geom == "subm":
        oc, ov = coords, valid
    else:
        oc, ov = tsc.build_downsample(coords, valid, shape, ks, st, pad,
                                      cap_out)[:2]
    codes = tzr.build_zplan(table, shape, oc, ov, ks, st, pad)
    return codes, valid, ov


@pytest.mark.parametrize("geom", list(GEOMS))
def test_zrun_conv_train_plain_path(geom):
    codes, valid, ov = _zrun_geometry(geom)
    B, cap, cin, cout = 2, valid.shape[0], 16, 24
    codes_b, ov_b = codes[None].repeat(2, 1, 1), ov[None].repeat(2, 1)
    K = 3 * codes.shape[0]
    rng = np.random.RandomState(4)
    f = torch.from_numpy(np.where(valid.numpy()[None, :, None], rng.randn(
        B, cap, cin), 0.0).astype(np.float32))
    w = torch.from_numpy((rng.randn(K, cin, cout) * 0.2).astype(np.float32))
    cot = torch.from_numpy(rng.randn(B, ov.shape[0], cout)
                           .astype(np.float32))
    rules = tzr.zrun_rules(codes_b, cap)

    def grads(fn):
        ff, ww = f.clone().requires_grad_(), w.clone().requires_grad_()
        with torch.enable_grad():  # other test modules may turn it off
            y = fn(ff, ww)
            y.backward(cot)
        return y.detach(), ff.grad, ww.grad

    # what the encoder builds once per level: zrun_rules and its transpose
    bwd = tse.backward_index(codes_b, cap, "cuda_zrun", geom != "subm")
    assert torch.equal(bwd[0], rules)
    assert torch.equal(bwd[1], rules if geom == "subm" else torch.stack(
        [tsc.transpose_rules(r, cap) for r in rules]))
    k3.reset_launch_count()
    k1.reset_launch_count()
    got = grads(lambda ff, ww: k3.zrun_conv_train(ff, codes_b, *bwd, ww,
                                                  ov_b))
    assert k3.launch_count() == 0 and k1.launch_count("dx") == 0 \
        and k1.launch_count("wgrad") == 0  # CPU tensors
    ref = grads(lambda ff, ww: k1.apply_conv_bf16_plain(ff, rules, ww, ov_b))
    assert torch.equal(got[0], ref[0])
    for name, g, r in zip(("dx", "dW"), got[1:], ref[1:]):
        assert g.shape == r.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0,
                                   atol=TOL * r.abs().max().item(),
                                   err_msg=name)
    assert torch.all(got[1][:, ~valid] == 0)


# ---------------------------------------------------------------------------
# the meta chain's transposed rulebooks
# ---------------------------------------------------------------------------

def test_transposed_k2_rulebooks_bit_exact():
    f, c, v = _voxels()
    cfg = _cfg("cuda_mxu", 4)
    shape = cfg.sparse_shape
    mxu = tse.Level.from_voxels(c, v, shape, True)
    crd = tse.Level.from_voxels(c, v, shape, False)
    geoms = [(3, 2, p) for p in cfg.down_paddings] + [((3, 1, 1),
                                                       (2, 1, 1), 0)]
    caps = list(cfg.capacities[1:]) + [cfg.out_capacity]
    checked = 0
    for (ks, st, pad), cap in zip(geoms, caps):
        m_out = mxu.downsample(ks, st, pad, cap)
        c_out = crd.downsample(ks, st, pad, cap)
        assert torch.equal(m_out.valid, c_out.valid)
        rules = tse.conv_index(mxu, m_out, ks, st, pad, "cuda_mxu")
        dw_rules, rules_t = tse.backward_index(rules, mxu.capacity,
                                               "cuda_mxu", True)
        assert dw_rules is rules
        for b in range(rules.shape[0]):
            table = tsc.VoxelTable(crd.coords[b], crd.valid[b], crd.meta[b])
            ref = tsc.build_conv_rules(table, crd.shape, c_out.coords[b],
                                       c_out.valid[b], ks, st, pad)
            assert torch.equal(rules[b], ref)
            want = tsc.transpose_rules(ref, crd.capacity)
            assert torch.equal(rules_t[b], want)
            jt = jsc.build_table_csr(jnp.asarray(crd.coords[b].numpy()),
                                     jnp.asarray(crd.valid[b].numpy()),
                                     crd.shape)
            jr = jsc.build_conv_rules(
                jt, crd.shape, jnp.asarray(c_out.coords[b].numpy()),
                jnp.asarray(c_out.valid[b].numpy()), ks, st, pad,
                use_positions=True)
            np.testing.assert_array_equal(
                rules_t[b].numpy(),
                np.asarray(scp.transpose_rules(jr, crd.capacity, ks)))
            checked += 1
        # a submanifold rulebook is its own transpose
        sub = tse.conv_index(m_out, m_out, 3, 1, 1, "cuda_mxu")
        r, rt = tse.backward_index(sub, m_out.capacity, "cuda_mxu", False)
        assert r is sub and rt is sub
        mxu, crd = m_out, c_out
    assert checked == 8


# ---------------------------------------------------------------------------
# one train step per engine
# ---------------------------------------------------------------------------

def _step(engine, dense_from):
    cfg = _cfg(engine, dense_from)
    model = tdet.FocalFormer3D(cfg)
    model.load_state_dict(make_fake_state_dict(model, 2), strict=True)
    tx = toptim.make_optimizer(total_steps=10)
    opt_state = tx.init(list(model.parameters()))
    gen = torch.Generator()
    gen.manual_seed(0)
    lcfg = tlosses.LossConfig(code_weights=(1.0,) * 8 + (0.2, 0.2))
    levels = []
    enc = model.pts_middle_encoder
    orig = enc.forward
    enc.forward = lambda *a, **kw: orig(*a, levels=levels, **kw)
    for k in (k1, k3):
        k.reset_launch_count()
    metrics = tstep.make_train_step(cfg, lcfg, tx)(model, opt_state,
                                                   _batch(), gen)
    assert k1.launch_count("forward") == k1.launch_count("dx") == \
        k3.launch_count() == 0  # CPU tensors
    _no_overflow(levels)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    return metrics, grads, model.state_dict()


@pytest.fixture(scope="module")
def steps():
    return {key: _step(*key) for key in (("cuda", 3), ("cuda_zrun", 3),
                                         ("cuda", 4), ("cuda_mxu", 4))}


@pytest.mark.parametrize("engine,dense_from", [("cuda_zrun", 3),
                                               ("cuda_mxu", 4)])
def test_train_step_equals_cuda(steps, engine, dense_from):
    got, ref = steps[(engine, dense_from)], steps[("cuda", dense_from)]
    for k, v in ref[0].items():
        assert np.isfinite(float(v)), k
        assert torch.equal(torch.as_tensor(got[0][k]), torch.as_tensor(v)), k
    assert set(got[1]) == set(ref[1]) and len(ref[1]) > 100
    enc = [k for k in ref[1] if k.startswith("pts_middle_encoder")]
    assert len(enc) == 21 + 2 * 21  # conv weights, BN weights and biases
    for k, g in ref[1].items():
        assert torch.equal(got[1][k], g), k
    for k, v in ref[2].items():
        assert torch.equal(got[2][k], v), k


# ---------------------------------------------------------------------------
# the training encoder against JAX ``voxel``
# ---------------------------------------------------------------------------

def _jax_encoder_run(dense_from, sd, f, c, v, cot):
    cfg = _cfg("plain")
    enc = JaxEnc(engine="voxel", assume_csr=True, dense_from=dense_from,
                 sparse_shape=cfg.sparse_shape,
                 output_channels=cfg.sparse_out_channels,
                 encoder_channels=cfg.encoder_channels,
                 down_paddings=cfg.down_paddings, **CAPS)
    args = tuple(jnp.asarray(t.numpy()) for t in (f, c, v))
    shapes = jax.eval_shape(lambda: enc.init(jax.random.PRNGKey(0), *args,
                                             True))
    tmpl = {coll: {"pts_middle_encoder": jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), tree)}
        for coll, tree in shapes.items()}
    variables, report = convert_tree(
        tmpl, {f"pts_middle_encoder.{k}": x.numpy() for k, x in sd.items()})
    assert not report.unloaded, report.summary()
    ev = {coll: tree["pts_middle_encoder"] for coll, tree in
          variables.items()}

    def loss(params):
        out, new = enc.apply({"params": params,
                              "batch_stats": ev["batch_stats"]}, *args, True,
                             mutable=["batch_stats"])
        return jnp.sum(out * jnp.asarray(cot.numpy())), (out, new)

    (_, (out, new)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(ev["params"])
    return np.asarray(out), {"params": {"pts_middle_encoder": grads},
                             "batch_stats": {"pts_middle_encoder":
                                             new["batch_stats"]}}


def _rel(got, ref):
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - ref).max()
                 / max(np.abs(ref).max(), 1e-12))


def _nrel(got, ref):
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - ref)
                 / max(np.linalg.norm(ref), 1e-12))


def _encoder_run(engine, dense_from, sd, f, c, v, cot=None):
    """BEV, parameter gradients for ``cot`` (a seeded normal draw if None)
    and state dict of one training forward + backward."""
    enc = _encoder(engine, dense_from, sd)
    levels = []
    with torch.enable_grad():
        bev = enc(f, c, v, levels=levels)
        if cot is None:
            cot = torch.from_numpy(np.random.RandomState(8).randn(
                *bev.shape).astype(np.float32))
        (bev * cot).sum().backward()
    _no_overflow(levels)
    grads = {k: p.grad for k, p in enc.named_parameters()}
    return bev.detach(), grads, enc.state_dict(), cot


def _distances(got, ref, dist):
    """(median, max) over tensors of ``dist(got[k], ref[k])``."""
    d = sorted(dist(got[k].numpy(), ref[k].numpy()) for k in ref)
    return d[len(d) // 2], d[-1]


@pytest.mark.parametrize("engine,dense_from", [("cuda_zrun", 3),
                                               ("cuda_mxu", 4)])
def test_training_encoder_vs_jax_voxel(engine, dense_from):
    f, c, v = _voxels()
    model = tdet.FocalFormer3D(_cfg("plain"))
    full = make_fake_state_dict(model, 6)
    sd = {k[len("pts_middle_encoder."):]: t for k, t in full.items()
          if k.startswith("pts_middle_encoder.")}
    bev, grads, state, cot = _encoder_run(engine, dense_from, sd, f, c, v)
    ref_bev, jvars = _jax_encoder_run(dense_from, sd, f, c, v, cot)
    pre = len("pts_middle_encoder.")
    shapes = {k[pre:]: s for k, s in jax_keys.reference_state_shapes(
        _cfg("plain")).items() if k.startswith("pts_middle_encoder.")}

    def jax_tensors(coll, keys):
        out = from_flax({coll: {"pts_middle_encoder": jvars[coll][
            "pts_middle_encoder"]}}, {f"pts_middle_encoder.{k}": shapes[k]
                                      for k in keys})
        return {k[pre:]: t for k, t in out.items()}

    jgrads = jax_tensors("params", grads)
    stat_keys = [k for k in state if k.endswith(("running_mean",
                                                  "running_var"))]
    jstats = jax_tensors("batch_stats", stat_keys)
    assert len(jgrads) == 63 and len(jstats) == 42

    # the calibration: the float32 path with its weights moved by 2^-9
    rng = np.random.RandomState(1)
    moved = {k: t * (1 + BF16_REL * torch.from_numpy(
        rng.randn(*t.shape).astype(np.float32)))
        if t.dtype == torch.float32 and k in grads else t
        for k, t in sd.items()}
    p_bev, p_grads, p_state, _ = _encoder_run("plain", dense_from, moved, f,
                                              c, v, cot)
    p_ref = _encoder_run("plain", dense_from, sd, f, c, v, cot)
    assert _rel(p_ref[0].numpy(), ref_bev) <= 1e-5  # float32 = JAX voxel
    pairs = (
        ("BEV", {"bev": bev}, {"bev": torch.from_numpy(np.array(ref_bev))},
         {"bev": p_bev}, {"bev": p_ref[0]}, _rel),
        ("gradients", grads, jgrads, p_grads, p_ref[1], _nrel),
        ("statistics", {k: state[k] for k in stat_keys}, jstats,
         {k: p_state[k] for k in stat_keys},
         {k: p_ref[2][k] for k in stat_keys}, _rel))
    for name, got, ref, pert, base, dist in pairs:
        d_engine = _distances(got, ref, dist)
        d_bf16 = _distances(pert, base, dist)
        assert d_engine[0] <= CALIBRATION * d_bf16[0] and \
            d_engine[1] <= CALIBRATION * d_bf16[1], (name, d_engine, d_bf16)

"""Parity: one training step of the PyTorch port against the JAX package.

Tiny_L, batch 2, one reference-format state dict in both packages (as
``tests/test_torch_model.py``). The port's engine ``plain`` (autograd
through the float32 gather + matmul) runs against the JAX engine ``voxel``,
both with the training dense boundary (L3). Dropout is off in both
(``roi_dropout=0`` in both configs, the JAX decoder's dropout set to 0 and
the port's too) and the denoising GT groups' noise is the same numpy draw
in both (the JAX decoder's ``jax.random.uniform`` and the port's
``gt_group_noise`` are replaced for the test; nothing in the JAX package
changes). Compared after one step of each package's ``make_train_step``:

- every loss term and metric: 1e-5 relative (float32 sums in another
  order), ``num_pos`` exactly;
- every gradient, brought to the flax layout through ``convert_tree``:
  2e-4 of the largest gradient of its tensor (the grads pass through ~40
  layers of float32 math summed in different orders, and through
  ``atan2``/``exp`` box decodes);
- every updated parameter and batch-norm statistic (``from_jax_variables``
  of the new JAX variables against the port's state dict): 2e-5 of the
  tensor's scale, plus, for parameters, the most that the two packages'
  gradient differences can move an element through Adam's first update
  (``lr * min(2, |g_port - g_jax| / eps)`` on the clipped gradients:
  after the clip many gradients sit within a few eps of zero, where
  Adam's normalised step turns rounding into up to ~lr).

``test_train_step_on_kernel_engine_cpu`` runs the same step on engine
``cuda`` through the kernels' plain versions (K1's autograd with the
kernels' rounding), cheaply, for finite losses and moved parameters.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focalformer3d_tpu.configs import get_config as jax_get_config
from focalformer3d_tpu.data import synthetic
from focalformer3d_tpu.models import focal_decoder as jfd
from focalformer3d_tpu.models.deformable_decoder import DeformableDecoder
from focalformer3d_tpu.training import optim as joptim
from focalformer3d_tpu.training.train_step import (TrainState,
                                                   make_train_step as jstep)
from focalformer3d_tpu.models.detector import FocalFormer3D as JaxFF3D
from focalformer3d_tpu.models.detector import preprocess_points as jax_prep
from focalformer3d_tpu.utils.convert import convert_tree
from focalformer3d_tpu.utils.ref_keys import make_fake_state_dict
from focalformer3d_tpu_torch import configs as tconfigs
from focalformer3d_tpu_torch.models import detector as tdet
from focalformer3d_tpu_torch.models import focal_decoder as tfd
from focalformer3d_tpu_torch.ops import sparse_conv_cuda as k1
from focalformer3d_tpu_torch.training import losses as tlosses
from focalformer3d_tpu_torch.training import optim as toptim
from focalformer3d_tpu_torch.training import train_step as tstep
from focalformer3d_tpu_torch.utils.convert import from_jax_variables

torch.set_num_threads(2)
LOSS_TOL, GRAD_TOL, PARAM_TOL = 1e-5, 2e-4, 2e-5


def _configs(engine="plain"):
    jcfg = jax_get_config("Tiny_L")
    tcfg = tconfigs.get_config("Tiny_L")["model"]
    jm = jcfg["model"]
    jm = dataclasses.replace(
        jm, decoder=dataclasses.replace(jm.decoder, roi_dropout=0.0))
    tm = dataclasses.replace(
        tcfg, sparse_engine=engine,
        decoder=dataclasses.replace(tcfg.decoder, roi_dropout=0.0))
    lcfg = tlosses.LossConfig(
        code_weights=tuple(jcfg["loss"].code_weights))
    return jm, jcfg["loss"], tm, lcfg


def _batch():
    jm = jax_get_config("Tiny_L")["model"]
    return synthetic.make_batch(
        np.random.RandomState(5), batch_size=2, n_points=2000, n_boxes=4,
        max_gts=8, num_classes=jm.decoder.num_classes,
        pc_range=jm.voxel.point_cloud_range, mode="radial")


def _noise(cfg, batch):
    B, G = batch["gt_boxes"].shape[:2]
    return np.random.RandomState(9).uniform(
        -1, 1, (B, cfg.decoder.add_gt_groups * G, 2)).astype(np.float32)


def _port_model(tm, sd_np):
    m = tdet.FocalFormer3D(tm)
    m.load_state_dict({k: torch.from_numpy(np.array(v))
                       for k, v in sd_np.items()}, strict=True)
    for mod in m.modules():  # the decoder's dropouts off, as in JAX below
        if isinstance(getattr(mod, "dropout", None), float):
            mod.dropout = 0.0
    return m


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12)


def run_both(jm, jlcfg, tm, lcfg, batch, mp, variables=None, mesh=None):
    """One ``make_train_step`` step of each package on ``batch`` from one
    state dict, dropout off, the same numpy group noise; ``mp`` is a
    MonkeyPatch the caller undoes. Returns what the checks below read.

    ``variables``: flax variables to start from (a mode whose weights
    JAX's key inventory lacks; the port loads ``from_jax_variables`` of
    them) in place of ``make_fake_state_dict``'s. ``mesh``: a JAX device
    mesh to jit the JAX step over, the batch sharded over its devices and
    the state replicated (as ``__graft_entry__.dryrun_multichip``)."""
    noise = _noise(jm, batch)
    sd = make_fake_state_dict(jm, seed=4) if variables is None else None

    # ---- JAX: one make_train_step step, dropout 0, the numpy noise ----
    mp.setattr(jfd, "DeformableDecoder",
               functools.partial(DeformableDecoder, dropout=0.0))

    def fixed_uniform(key, shape, *args, **kwargs):
        assert tuple(shape) == noise.shape, shape
        return jnp.asarray(noise)

    mp.setattr(jax.random, "uniform", fixed_uniform)
    model = JaxFF3D(jm)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    vox = jax_prep(jm, jb["points"], jb["points_mask"], train=True)
    if variables is None:
        variables = jax.eval_shape(lambda: model.init(
            {"params": jax.random.PRNGKey(0), "gt": jax.random.PRNGKey(1),
             "dropout": jax.random.PRNGKey(2)}, vox, None, True,
            jb["gt_boxes"], jb["gt_labels"], jb["gt_valid"]))
        variables = jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, s.dtype), variables)
        variables, report = convert_tree(variables, sd)
        assert report.full, report.summary()
    else:
        sd = {k: v.numpy() for k, v in
              from_jax_variables(variables, tm).items()}
    tx = joptim.make_optimizer(total_steps=10)
    state = TrainState(variables["params"], variables["batch_stats"],
                       tx.init(variables["params"]),
                       jnp.zeros((), jnp.int32))
    if mesh is not None:
        from focalformer3d_tpu.parallel import mesh as mesh_lib

        state = mesh_lib.replicate(mesh, state)
        jb = mesh_lib.shard_batch(mesh, jb)
    step = jstep(jm, jlcfg, tx)

    @jax.jit
    def run(state, batch):
        grads = jax.grad(lambda p: _jax_loss(jm, jlcfg, model, p, state,
                                             batch))(state.params)
        new_state, metrics = step(state, batch, jax.random.PRNGKey(7))
        return new_state, metrics, grads

    new_state, jmetrics, jgrads = jax.device_get(run(state, jb))
    mp.undo()

    # ---- port: one make_train_step step, same weights, noise and batch ----
    tmodel = _port_model(tm, sd)
    ttx = toptim.make_optimizer(total_steps=10)
    opt_state = ttx.init(list(tmodel.parameters()))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with pytest.MonkeyPatch.context() as tmp:
        tmp.setattr(tfd, "gt_group_noise",
                    lambda gen, shape, device: torch.from_numpy(noise))
        tmetrics = tstep.make_train_step(tm, lcfg, ttx)(
            tmodel, opt_state, tbatch, None)
    tgrads = {n: p.grad.numpy() for n, p in tmodel.named_parameters()
              if p.grad is not None}
    new_vars = {"params": new_state.params,
                "batch_stats": new_state.batch_stats}
    return dict(jm=jm, tm=tm, jmetrics=jmetrics, jgrads=jgrads,
                tmetrics=tmetrics, tgrads=tgrads, tmodel=tmodel,
                new_vars=new_vars, old_vars=variables, noise=noise, sd=sd)


@pytest.fixture(scope="module")
def both(request):
    mp = pytest.MonkeyPatch()
    request.addfinalizer(mp.undo)
    return run_both(*_configs(), _batch(), mp)


def _jax_loss(jm, jlcfg, model, params, state, batch):
    """The JAX step's own loss function (``make_train_step.loss_fn``)."""
    from focalformer3d_tpu.training.losses import detection_loss

    vox = jax_prep(jm, batch["points"], batch["points_mask"], train=True)
    out, _ = model.apply(
        {"params": params, "batch_stats": state.batch_stats}, vox, None,
        True, batch["gt_boxes"], batch["gt_labels"], batch["gt_valid"],
        rngs={"gt": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
        mutable=["batch_stats"])
    return detection_loss(jm.decoder, jlcfg, out, batch["gt_boxes"],
                          batch["gt_labels"], batch["gt_valid"])[0]


def check_losses(both):
    """Every loss term and metric within LOSS_TOL, ``num_pos`` exactly."""
    jmet, tmet = both["jmetrics"], both["tmetrics"]
    keys = set(jmet)
    assert keys <= set(tmet), keys - set(tmet)
    assert float(tmet["num_pos"]) == float(jmet["num_pos"])
    for k in sorted(keys):
        rel = _rel(tmet[k].numpy(), jmet[k])
        assert rel <= LOSS_TOL, f"{k}: {float(tmet[k])} vs {jmet[k]} " \
                                f"rel {rel:.3g}"
    assert float(tmet["gt_query_loss_cls"]) > 0


def test_losses_match(both):
    check_losses(both)


def check_gradients(both):
    """Every gradient within GRAD_TOL of its tensor's largest."""
    tgrads = both["tgrads"]
    assert len(tgrads) > 100
    jgrads = both["jgrads"]
    tmpl = {"params": jax.tree_util.tree_map(np.zeros_like, jgrads)}
    conv, report = convert_tree(tmpl, tgrads)
    assert not report.missed and not report.unmapped, report.summary()
    got, ref = _flatten(conv["params"]), _flatten(jgrads)
    assert set(got) == set(ref)
    # Analytic zeros, whose computed values are rounding noise in both
    # packages: the key biases of softmax attention (a row's logits all
    # shift by q.b) and the bias of the last decoder layer's last norm
    # (a per-channel shift that the prediction heads' training batch norm
    # removes). Both sides must be noise: below 1e-5 of the largest grad.
    last = f"decoder{both['jm'].decoder.num_decoder_layers - 1}/layer" \
        f"{both['jm'].decoder.inner_layers - 1}/norm3/bias"
    gmax = max(np.abs(r).max() for r in ref.values())
    worst = []
    for path, r in ref.items():
        name = "/".join(path)
        if name.endswith("self_attn/k/bias") or name.endswith(last):
            assert max(np.abs(r).max(), np.abs(got[path]).max()) \
                <= 1e-5 * gmax, name
            continue
        worst.append((_rel(got[path], r), name))
    worst.sort()
    assert worst[-1][0] <= GRAD_TOL, worst[-5:]


def test_gradients_match(both):
    check_gradients(both)


def test_updated_params_and_batch_stats_match(both):
    check_params(both)


def check_params(both):
    """Batch-norm statistics: PARAM_TOL of the tensor's scale. Parameters:
    the same, plus what the two packages' gradient differences can move
    through Adam's first update, ``lr * |f(g_port) - f(g_jax)|`` with
    ``f(g) = g / (|g| + eps)`` on the clipped gradients (Lipschitz
    ``1 / eps``, and at most 2): the clip scales this step's gradients by
    ``0.1 / grad_norm``, which leaves many elements within a few eps
    (1e-8) of zero, where a rounding-level gradient difference moves the
    element by up to ~lr."""
    ref = from_jax_variables(both["new_vars"], both["tm"])
    old = from_jax_variables(both["old_vars"], both["tm"])
    jgrads = from_jax_variables(
        {"params": both["jgrads"],
         "batch_stats": both["new_vars"]["batch_stats"]}, both["tm"])
    got = both["tmodel"].state_dict()
    params = dict(both["tmodel"].named_parameters())
    tx = toptim.make_optimizer(total_steps=10)
    lr = tx.lr(0)
    clip_t = min(1.0, tx.grad_clip / float(both["tmetrics"]["grad_norm"]))
    clip_j = min(1.0, tx.grad_clip / float(both["jmetrics"]["grad_norm"]))
    moved_bn = 0
    for k, v in ref.items():
        if k.endswith("num_batches_tracked") or k.endswith("bev_pos"):
            continue
        g, r = got[k].numpy(), v.numpy()
        scale = max(np.abs(r).max(), 1e-3)
        allow = PARAM_TOL * scale
        if k in params:
            gt = both["tgrads"].get(k, np.zeros_like(r)) * clip_t
            gj = jgrads[k].numpy() * clip_j
            allow = allow + 1.01 * lr * np.minimum(
                2.0, np.abs(gt - gj) / tx.eps)
        worst = float(np.max(np.abs(g - r) / allow))
        assert worst <= 1.0, f"{k}: {worst:.3g} of its allowance"
        if k.endswith("running_mean"):
            moved_bn += int(not np.array_equal(r, old[k].numpy()))
    assert moved_bn > 20  # every BN the step ran updated its statistics


def test_train_step_on_kernel_engine_cpu():
    """Engine ``cuda`` on CPU tensors: the sparse convs go through K1's
    autograd Function (its plain versions: no launch), the step is finite,
    moves every sparse-conv weight and the BN statistics."""
    _, _, tm, lcfg = _configs("cuda")
    tm = dataclasses.replace(tm, decoder=dataclasses.replace(
        tm.decoder, roi_dropout=0.1))
    m = tdet.FocalFormer3D(tm)
    from focalformer3d_tpu_torch.utils.ref_keys import (
        make_fake_state_dict as port_fake)
    m.load_state_dict(port_fake(m, 2), strict=True)
    before = {k: v.clone() for k, v in m.state_dict().items()}
    tx = toptim.make_optimizer(total_steps=10)
    opt_state = tx.init(list(m.parameters()))
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    gen = torch.Generator()
    gen.manual_seed(0)
    k1.reset_launch_count()
    metrics = tstep.make_train_step(tm, lcfg, tx)(m, opt_state, batch, gen)
    assert all(k1.launch_count(kind) == 0
               for kind in ("forward", "dx", "wgrad"))
    for k, v in metrics.items():
        assert np.isfinite(float(v)), k
    after = m.state_dict()
    enc = [k for k, v in after.items()
           if k.startswith("pts_middle_encoder") and v.dim() == 5]
    assert len(enc) == 21  # 16 sparse convs, the dense L3 tail, conv_out
    assert all(not torch.equal(after[k], before[k]) for k in enc)
    assert not torch.equal(after["pts_middle_encoder.conv_input.1."
                                 "running_mean"],
                           before["pts_middle_encoder.conv_input.1."
                                  "running_mean"])

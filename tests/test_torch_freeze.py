"""Branch freezing in the port, against the JAX package.

Tiny_L with ``freeze_pts``:

- ``trainable_mask`` on the port's parameter names (reference keys), and
  the ``requires_grad`` the detector builds from it, equal the JAX masks
  (``trainable_mask``, and ``freeze_mask``'s 0 / 1) on the flax tree that
  ``utils/convert.convert_tree`` builds from the same state dict, leaf for
  leaf through ``utils/jax_keys.build_mapping`` (no JAX compile: the tree's
  shapes come from ``jax.eval_shape``);
- one port step (engine ``cuda`` on CPU tensors: the kernels' plain
  versions) leaves every frozen parameter and every point-branch batch-norm
  statistic bit-identical, ``imgpts_neck.shared_conv_pts`` included, moves
  the head, runs the encoder in eval mode at the eval dense boundary and
  without autograd, and gives the frozen parameters no gradient and no
  optimizer state; the step refuses an optimizer state that holds one;
- ``slow``: that step against JAX's jitted ``make_train_step`` with the
  masked optimizer (engine ``plain`` against ``voxel``, dropout off, the
  same GT-group noise): losses, trainable parameters and the head's
  batch-norm statistics to ``tests/test_torch_train_step.py``'s
  tolerances.
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
from focalformer3d_tpu.models.detector import FocalFormer3D as JaxFF3D
from focalformer3d_tpu.models.detector import preprocess_points as jax_prep
from focalformer3d_tpu.training import optim as joptim
from focalformer3d_tpu.training import train_step as jts
from focalformer3d_tpu.utils.convert import convert_tree
from focalformer3d_tpu.utils.ref_keys import make_fake_state_dict
from focalformer3d_tpu_torch import configs as tconfigs
from focalformer3d_tpu_torch.models import detector as tdet
from focalformer3d_tpu_torch.models import focal_decoder as tfd
from focalformer3d_tpu_torch.ops import sparse_conv_cuda as k1
from focalformer3d_tpu_torch.training import optim as toptim
from focalformer3d_tpu_torch.training import train_step as tts
from focalformer3d_tpu_torch.utils import jax_keys
from focalformer3d_tpu_torch.utils.convert import from_jax_variables

torch.set_num_threads(2)
LOSS_TOL, PARAM_TOL = 1e-5, 2e-5  # as tests/test_torch_train_step.py
POINT_BRANCH = ("pts_middle_encoder.", "pts_backbone.", "pts_neck.",
                "imgpts_neck.shared_conv_pts.")
FLAGS = [(), ("freeze_pts",), ("freeze_img", "freeze_camlss", "freeze_pts")]


def _batch():
    jm = jax_get_config("Tiny_L")["model"]
    return synthetic.make_batch(
        np.random.RandomState(5), batch_size=2, n_points=2000, n_boxes=4,
        max_gts=8, num_classes=jm.decoder.num_classes,
        pc_range=jm.voxel.point_cloud_range, mode="radial")


def _jax_variables(jm, batch, sd):
    """Flax variables of ``jm`` holding the state dict ``sd``."""
    model = JaxFF3D(jm)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    vox = jax_prep(jm, jb["points"], jb["points_mask"], train=True)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "gt": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)}, vox, None, True,
        jb["gt_boxes"], jb["gt_labels"], jb["gt_valid"]))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   shapes)
    variables, report = convert_tree(zeros, sd)
    assert report.full, report.summary()
    return variables


@pytest.fixture(scope="module")
def tree():
    jm = jax_get_config("Tiny_L")["model"]
    batch = _batch()
    return _jax_variables(jm, batch, make_fake_state_dict(jm, seed=4))


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "+".join(f) or "none")
def test_masks_equal_jax_leaf_for_leaf(tree, flags):
    on = {f: True for f in flags}
    jcfg = dataclasses.replace(jax_get_config("Tiny_L")["model"], **on)
    tcfg = dataclasses.replace(tconfigs.get_config("Tiny_L")["model"], **on)
    jtrain = _flat(jts.trainable_mask(jcfg, tree["params"]))
    jmult = _flat(jts.freeze_mask(jcfg, tree["params"]))
    named = list(tdet.FocalFormer3D(tcfg).named_parameters())
    names = [n for n, _ in named]
    ttrain = tts.trainable_mask(tcfg, names)
    assert ttrain == {n: p.requires_grad for n, p in named}
    mapping = jax_keys.build_mapping(jax_keys.reference_state_shapes(tcfg))
    seen = set()
    for name in names:
        # a key may list alternative places (a deconv or a conv); the
        # tree holds one of them
        paths = [tuple(p) for coll, p, _ in mapping[name]
                 if coll == "params" and tuple(p) in jtrain]
        assert paths, name
        for p in paths:
            assert jtrain[p] == ttrain[name], (name, p)
            assert float(jmult[p]) == float(ttrain[name]), (name, p)
            seen.add(p)
    assert seen == set(jtrain)  # every JAX parameter leaf is a port one
    if "freeze_pts" in flags:
        frozen = {n for n, keep in ttrain.items() if not keep}
        assert frozen == {n for n in names if n.startswith(POINT_BRANCH)}


def _port_freeze_step(engine, sd, batch, noise=None):
    """One port step of Tiny_L with ``freeze_pts`` (the optimizer state
    made from the model's named parameters); returns (model, state dict before, metrics, opt_state,
    what the encoder saw)."""
    tm = tconfigs.get_config("Tiny_L")
    cfg = dataclasses.replace(
        tm["model"], freeze_pts=True, sparse_engine=engine,
        decoder=dataclasses.replace(tm["model"].decoder, roi_dropout=0.0))
    model = tdet.FocalFormer3D(cfg)
    model.load_state_dict(sd, strict=True)
    for mod in model.modules():  # the decoder's dropouts off, as in JAX
        if isinstance(getattr(mod, "dropout", None), float):
            mod.dropout = 0.0
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tx = toptim.make_optimizer(total_steps=10)
    opt_state = tx.init(model.named_parameters())
    enc = model.pts_middle_encoder
    seen = {}
    hooks = [
        enc.register_forward_pre_hook(
            lambda m, a: seen.update(training=m.training)),
        model.pts_neck.register_forward_hook(
            lambda m, a, out: seen.update(grad=out.requires_grad)),
    ]
    tail = enc._dense_tail
    enc._dense_tail = lambda x, mask, start, engine: (
        seen.update(dense_from=start), tail(x, mask, start, engine))[1]
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    gen = torch.Generator()
    gen.manual_seed(0)
    with pytest.MonkeyPatch.context() as mp:
        if noise is not None:
            mp.setattr(tfd, "gt_group_noise",
                       lambda g, shape, device: torch.from_numpy(noise))
        k1.reset_launch_count()
        metrics = tts.make_train_step(cfg, tm["loss"], tx)(
            model, opt_state, tbatch, gen)
    for h in hooks:
        h.remove()
    del enc._dense_tail
    return model, before, metrics, opt_state, seen, cfg


def test_port_step_keeps_the_frozen_branch():
    tcfg = tconfigs.get_config("Tiny_L")["model"]
    from focalformer3d_tpu_torch.utils.ref_keys import (
        make_fake_state_dict as port_fake)
    sd = port_fake(tdet.FocalFormer3D(tcfg), 2)
    model, before, metrics, opt_state, seen, cfg = _port_freeze_step(
        "cuda", sd, _batch())
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert [k1.launch_count(k) for k in ("forward", "dx", "wgrad")] == \
        [0, 0, 0]  # CPU tensors: the kernels' plain versions
    after = model.state_dict()
    frozen = [k for k in after if k.startswith(POINT_BRANCH)]
    assert any(k.endswith("running_mean") for k in frozen)
    assert "imgpts_neck.shared_conv_pts.weight" in frozen
    for k in frozen:
        assert torch.equal(after[k], before[k]), k
    head = [k for k in after if k.startswith("pts_bbox_head.")]
    moved = [k for k in head if not torch.equal(after[k], before[k])]
    assert len(moved) > len(head) // 2
    assert any(k.endswith("running_mean") for k in moved)
    assert seen == {"training": False, "grad": False,
                    "dense_from": cfg.sparse_dense_from_eval}
    named = dict(model.named_parameters())
    assert all(named[k].grad is None for k in named
               if k.startswith(POINT_BRANCH))
    assert not set(opt_state.names) & {k for k in named
                                       if k.startswith(POINT_BRANCH)}
    assert model.training and not model.pts_backbone.training


def test_step_refuses_an_opt_state_with_frozen_parameters():
    tm = tconfigs.get_config("Tiny_L")
    cfg = dataclasses.replace(tm["model"], freeze_pts=True)
    model = tdet.FocalFormer3D(cfg)
    tx = toptim.make_optimizer(total_steps=10)
    assert len(tx.init(model.named_parameters()).mu) < \
        len(list(model.parameters()))
    unmasked = tx.init(list(model.parameters()))  # every parameter
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    with pytest.raises(ValueError, match="freeze flags"):
        tts.make_train_step(cfg, tm["loss"], tx)(model, unmasked, batch,
                                                 None)


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


@pytest.mark.slow
def test_freeze_step_matches_jax(request):
    """One jitted JAX step (``optax.masked``) against one port step.

    ``imgpts_neck.shared_conv_pts`` is frozen in both, but JAX's
    ``stop_gradient`` sits at the FPN output, before it, so it still gets a
    gradient, and ``optax.masked`` passes that gradient through as its
    update: ``apply_updates`` adds it, and JAX's value moves by ``+grad``
    (up to 2.06 on a 0.077-scale kernel on this config). The port leaves
    it as it was, which the test asserts."""
    batch = _batch()
    jc = jax_get_config("Tiny_L")
    jm = dataclasses.replace(jc["model"], freeze_pts=True,
                             decoder=dataclasses.replace(
                                 jc["model"].decoder, roi_dropout=0.0))
    B, G = batch["gt_boxes"].shape[:2]
    noise = np.random.RandomState(9).uniform(
        -1, 1, (B, jm.decoder.add_gt_groups * G, 2)).astype(np.float32)
    sd = make_fake_state_dict(jm, seed=4)
    variables = _jax_variables(jm, batch, sd)

    mp = pytest.MonkeyPatch()
    request.addfinalizer(mp.undo)
    mp.setattr(jfd, "DeformableDecoder",
               functools.partial(DeformableDecoder, dropout=0.0))

    def fixed_uniform(key, shape, *args, **kwargs):
        assert tuple(shape) == noise.shape, shape
        return jnp.asarray(noise)

    mp.setattr(jax.random, "uniform", fixed_uniform)
    tx = joptim.make_optimizer(
        total_steps=10, trainable_mask=lambda p: jts.trainable_mask(jm, p))
    state = jts.TrainState(variables["params"], variables["batch_stats"],
                           tx.init(variables["params"]),
                           jnp.zeros((), jnp.int32))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    step = jts.make_train_step(jm, jc["loss"], tx)
    model = JaxFF3D(jm)

    @jax.jit
    def run(state, batch):
        grads = jax.grad(lambda p: _jax_loss(jm, jc["loss"], model, p,
                                             state, batch))(state.params)
        new_state, metrics = step(state, batch, jax.random.PRNGKey(7))
        return new_state, metrics, grads

    new_state, jmet, jgrads = jax.device_get(run(state, jb))
    mp.undo()

    tsd = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    model, before, tmet, _, _, tcfg = _port_freeze_step("plain", tsd, batch,
                                                        noise)
    for k in jmet:
        if k == "grad_norm":  # JAX's also counts the frozen leaves' grads
            continue
        got, ref = float(tmet[k]), float(jmet[k])
        assert abs(got - ref) <= LOSS_TOL * max(abs(ref), 1e-12), \
            (k, got, ref)

    ref = from_jax_variables({"params": new_state.params,
                              "batch_stats": new_state.batch_stats}, tcfg)
    jg = from_jax_variables({"params": jgrads,
                             "batch_stats": new_state.batch_stats}, tcfg)
    got = model.state_dict()
    params = dict(model.named_parameters())
    trainable = [k for k in params if not k.startswith(POINT_BRANCH)]
    tx = toptim.make_optimizer(total_steps=10)
    # each clip reads the trainable gradients' norm (optax.masked around
    # the chain in JAX)
    clip_t = min(1.0, tx.grad_clip / float(tmet["grad_norm"]))
    clip_j = min(1.0, tx.grad_clip / float(np.sqrt(sum(
        float((jg[k].double() ** 2).sum()) for k in trainable))))
    checked = 0
    for k, v in ref.items():
        if k.startswith(POINT_BRANCH) or k.endswith(
                ("num_batches_tracked", "bev_pos")):
            continue
        g, r = got[k].numpy(), v.numpy()
        allow = PARAM_TOL * max(np.abs(r).max(), 1e-3)
        if k in params:  # as tests/test_torch_train_step.py
            gt = params[k].grad.numpy() * clip_t
            gj = jg[k].numpy() * clip_j
            allow = allow + 1.01 * tx.lr(0) * np.minimum(
                2.0, np.abs(gt - gj) / tx.eps)
        worst = float(np.max(np.abs(g - r) / allow))
        assert worst <= 1.0, f"{k}: {worst:.3g} of its allowance"
        checked += 1
    assert checked > 100
    head_bn = [k for k in ref if k.startswith("pts_bbox_head.")
               and k.endswith("running_mean")]
    assert head_bn and all(not torch.equal(got[k], before[k])
                           for k in head_bn)
    w = "imgpts_neck.shared_conv_pts.weight"
    assert torch.equal(got[w], before[w])  # JAX: before + grad (above)
    jax_move = float((ref[w] - before[w]).abs().max())
    head_move = max(float((ref[k] - before[k]).abs().max()) for k in ref
                    if k.startswith("pts_bbox_head.") and k in params)
    print(f"JAX freeze_pts step: shared_conv_pts moved by up to {jax_move:.4g}"
          f" (largest entry {float(before[w].abs().max()):.4g}); trainable "
          f"head parameters by up to {head_move:.4g}")
    assert jax_move > head_move

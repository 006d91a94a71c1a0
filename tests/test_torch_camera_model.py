"""Parity: the camera path as a whole, the port against the JAX package.

On the tiny LC config of ``tests/test_camera.py`` (``tiny_lc_config``)
with a ResNet-50 image branch (the only depth the reference key inventory
has), FPN 256, 2 cameras at 64 x 96; one reference-format state dict
(``ref_keys.make_fake_state_dict``) in both packages:

- the two camera configs mirror JAX field for field, their reference keys
  and shapes equal JAX's, and the synthetic camera batch is JAX's bit for
  bit;
- the eval forward: the fusion neck's stage features and every head
  output within ``EVAL_TOL`` (1e-4) of the JAX result's scale, the query
  labels exactly;
- ``slow``: one train step with ``freeze_img``, ``freeze_camlss`` and
  ``freeze_pts`` against JAX's jitted ``make_train_step`` (dropout off, the
  same GT-group noise and the same grid mask in both): losses within 1e-5,
  every trainable gradient within 2e-4 of its tensor's largest, the
  updated trainable parameters as ``tests/test_torch_train_step.py`` holds
  them; the port's frozen parameters and statistics bit-identical. (JAX's
  ``optax.masked`` moves ``shared_conv_pts``, ROADMAP.md Queue 3.)
- the same step in the port alone, on the kernel engine's CPU path: the
  frozen branches keep every bit, run in eval mode without autograd, and
  the fusion layers and head move;
- the camera-only model (``input_pts=False``): JAX's outputs do not move
  when the images change (its encoder feeds the head a zero canvas,
  ROADMAP.md Queue 3), the port's do, and the port's head equals JAX's
  ``FocalDecoder`` applied to JAX's own ``LiftSplatShoot`` output within
  ``EVAL_TOL``.
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
from focalformer3d_tpu.models.lss import LiftSplatShoot as JaxLSS
from focalformer3d_tpu.training import optim as joptim
from focalformer3d_tpu.training import train_step as jts
from focalformer3d_tpu.training.losses import detection_loss
from focalformer3d_tpu.utils import ref_keys as jref_keys
from focalformer3d_tpu.utils.convert import convert_tree
from focalformer3d_tpu_torch import configs as tconfigs
from focalformer3d_tpu_torch.data import synthetic as tsynthetic
from focalformer3d_tpu_torch.models import detector as tdet
from focalformer3d_tpu_torch.models import focal_decoder as tfd
from focalformer3d_tpu_torch.models import grid_mask as tgm
from focalformer3d_tpu_torch.ops import sparse_conv_cuda as k1
from focalformer3d_tpu_torch.training import losses as tlosses
from focalformer3d_tpu_torch.training import optim as toptim
from focalformer3d_tpu_torch.training import train_step as tts
from focalformer3d_tpu_torch.utils import jax_keys
from focalformer3d_tpu_torch.utils.convert import from_flax
from test_camera import tiny_lc_config

torch.set_num_threads(2)
EVAL_TOL = 1e-4
LOSS_TOL, GRAD_TOL, PARAM_TOL = 1e-5, 2e-4, 2e-5
IMG_KEYS = ("imgs", "lidar2img", "img_aug", "bev_aug")
FREEZE = dict(freeze_img=True, freeze_camlss=True, freeze_pts=True)
FROZEN = ("img_backbone.", "img_neck.", "imgpts_neck.cam_lss.",
          "pts_middle_encoder.", "pts_backbone.", "pts_neck.",
          "imgpts_neck.shared_conv_pts.")


def _to_port(j):
    d = dataclasses.asdict(j)
    return tconfigs.DetectorConfig(**{
        **d, "voxel": tconfigs.VoxelConfig(**d["voxel"]),
        "lss": tconfigs.LSSConfig(**d["lss"]),
        "decoder": tconfigs.FocalDecoderConfig(**d["decoder"])})


def tiny(input_pts=True, **kw):
    """(JAX config, port config): ``tiny_lc_config`` on ResNet-50."""
    jm = dataclasses.replace(tiny_lc_config(input_pts),
                             img_backbone_depth=50, **kw)
    tm = _to_port(jm)
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    return jm, tm


def _batch(seed=0, batch_size=1):
    jm = tiny_lc_config()
    return synthetic.make_batch(
        np.random.RandomState(seed), batch_size=batch_size, n_points=800,
        n_boxes=3, max_gts=6, num_classes=4,
        pc_range=jm.voxel.point_cloud_range, with_images=True, n_cams=2,
        img_hw=jm.lss.img_scale)


def _jax_variables(jm, batch, sd, train=False):
    model = JaxFF3D(jm)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    vox = (jax_prep(jm, jb["points"], jb["points_mask"], train=train)
           if jm.input_pts else None)
    img = {k: jb[k] for k in IMG_KEYS}
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "gt": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)}, vox, img, train,
        jb["gt_boxes"], jb["gt_labels"], jb["gt_valid"]))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   shapes)
    variables, report = convert_tree(zeros, sd)
    assert not report.unmapped and not report.unloaded, report.summary()
    return model, variables, vox, img


def _port_model(tm, sd):
    m = tdet.FocalFormer3D(tm)
    m.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()
                       if not jax_keys.absent(tm, k)}, strict=True)
    return m


def _port_inputs(tm, batch, train=False):
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    vox = (tdet.preprocess_points(tm, tb["points"], tb["points_mask"],
                                  train=train) if tm.input_pts else None)
    return tb, vox, {k: tb[k] for k in IMG_KEYS}


def _close(got, ref, tol, msg):
    got = got.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (msg, got.shape, ref.shape)
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-3)
    assert err <= tol, f"{msg}: rel err {err:.3g} > {tol}"


def _check_outputs(got, ref, tol=EVAL_TOL):
    assert set(ref) <= set(got), set(ref) - set(got)
    for k, r in ref.items():
        r = np.asarray(r)
        if r.dtype == bool or np.issubdtype(r.dtype, np.integer):
            np.testing.assert_array_equal(got[k].numpy(), r, err_msg=k)
        else:
            _close(got[k], r, tol, k)


def _jax_state(variables, tm):
    """The port's keys that the JAX tree holds (JAX builds no RoI MLP for a
    one-round decoder, whose parameters the port and the reference keep),
    from the flax variables."""
    shapes = {k: v for k, v in jax_keys.reference_state_shapes(tm).items()
              if not jax_keys.absent(tm, k)}
    mapping = jax_keys.build_mapping(shapes)
    flat = {}

    def walk(t, p):
        for k, v in t.items():
            walk(v, p + (k,)) if isinstance(v, dict) else flat.__setitem__(
                p + (k,), v)

    for coll, tree in variables.items():
        walk(tree, (coll,))
    held = {k: v for k, v in shapes.items()
            if k not in mapping or any((c,) + tuple(p) in flat
                                       for c, p, _ in mapping[k])}
    return from_flax(variables, held)


# ---------------------------------------------------------------------------
# configs, keys, synthetic cameras
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["FocalFormer3D_LC", "DeformFormer3D_C_R50"])
def test_camera_config_mirrors_jax(name):
    j, t = jax_get_config(name), tconfigs.get_config(name)
    assert set(t) == set(j)
    assert dataclasses.asdict(t["model"]) == dataclasses.asdict(j["model"])
    assert dataclasses.asdict(t["loss"]) == dataclasses.asdict(j["loss"])
    assert dataclasses.asdict(t["train"]) == dataclasses.asdict(j["train"])
    for k in ("class_names", "img_scale", "dataset"):
        assert t[k] == j[k], k
    cfg = t["model"]
    lss = cfg.lss
    assert (lss.img_scale, lss.depth_bins, lss.feat_hw, lss.nx[2],
            lss.cam_channels * lss.nx[2]) == ((448, 800), 41, (112, 200), 13,
                                              832)
    assert name in tconfigs.available()
    with torch.device("meta"):
        tdet.FocalFormer3D(cfg)


@pytest.mark.parametrize("name", ["FocalFormer3D_LC", "DeformFormer3D_C_R50"])
def test_camera_keys_match_jax(name):
    """The port's key inventory equals JAX's; the model's state dict is the
    inventory without the branches it does not build (the camera-only
    config's point branch), with the reference's shapes and order."""
    tm = tconfigs.get_config(name)["model"]
    shapes = jref_keys.reference_state_shapes(jax_get_config(name)["model"])
    assert list(jax_keys.reference_state_shapes(tm).items()) == \
        list(shapes.items())
    with torch.device("meta"):
        model = tdet.FocalFormer3D(tm)
    own = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    want = {k: s for k, s in shapes.items() if not jax_keys.absent(tm, k)}
    assert own == want
    assert (len(shapes) - len(want) > 0) == (not tm.input_pts)
    from focalformer3d_tpu_torch.utils.ref_keys import reference_key_order
    assert reference_key_order(model) == list(want)


def test_i2p_and_unported_camera_configs_raise():
    """``cam_proj="i2p"`` is ported (``tests/test_torch_i2p.py``); the LC
    TTA config (ported with the camera data layer) equals JAX's: the LC
    config field for field plus its ``tta`` dict; and a projection neither
    package has raises in both the model and the weight bridge."""
    tm = dataclasses.replace(tconfigs.get_config("FocalFormer3D_LC")["model"],
                             cam_proj="i2p")
    with torch.device("meta"):
        assert tdet.FocalFormer3D(tm).imgpts_neck.cam_lss is None
    assert "imgpts_neck.shared_conv_img.weight" in \
        jax_keys.reference_state_shapes(tm)
    t = tconfigs.get_config("FocalFormer3D_LC_TTA")
    j = jax_get_config("FocalFormer3D_LC_TTA")
    assert set(t) == set(j) and "FocalFormer3D_LC_TTA" in tconfigs.available()
    for k in ("model", "loss", "train"):
        assert dataclasses.asdict(t[k]) == dataclasses.asdict(j[k]), k
    for k in ("class_names", "img_scale", "dataset", "tta"):
        assert t[k] == j[k], k
    assert t["tta"]["pts_scale_ratio"] == (1.0, 1.06, 0.96)
    lc = tconfigs.get_config("FocalFormer3D_LC")
    assert dataclasses.asdict(t["model"]) == dataclasses.asdict(lc["model"])
    bad = dataclasses.replace(tm, cam_proj="bev")
    with pytest.raises(ValueError, match="cam_proj"):
        tdet.FocalFormer3D(bad)
    with pytest.raises(NotImplementedError, match="camera projections"):
        jax_keys.reference_state_shapes(bad)


def test_synthetic_camera_batch_bit_for_bit():
    kw = dict(batch_size=2, n_points=3000, n_boxes=4, max_gts=8,
              num_classes=4, pc_range=(-8.0, -8.0, -3.0, 8.0, 8.0, 3.0),
              with_images=True, n_cams=3, img_hw=(64, 96), mode="radial")
    a = synthetic.make_batch(np.random.RandomState(3), **kw)
    b = tsynthetic.make_batch(np.random.RandomState(3), **kw)
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert b["imgs"].shape == (2, 3, 64, 96, 3) and b["imgs"].max() > 0
    rng = np.random.RandomState(4)
    np.testing.assert_array_equal(
        tsynthetic.make_cameras(rng, 6, (448, 800)),
        synthetic.make_cameras(np.random.RandomState(4), 6, (448, 800)))


# ---------------------------------------------------------------------------
# eval forward
# ---------------------------------------------------------------------------

def _capture(module):
    seen = {}
    module.register_forward_hook(lambda m, a, out: seen.update(out=out))
    return seen


def test_tiny_lc_eval_forward_matches_jax():
    jm, tm = tiny()
    batch = _batch(0)
    sd = jref_keys.make_fake_state_dict(jm, seed=3)
    model, variables, vox, img = _jax_variables(jm, batch, sd)
    out, inter = jax.jit(lambda v: model.apply(
        v, vox, img, False, capture_intermediates=lambda mdl, _: (
            mdl.name == "imgpts_neck")))(variables)
    jneck = inter["intermediates"]["imgpts_neck"]["__call__"][0]

    tmodel = _port_model(tm, sd).eval()
    neck = _capture(tmodel.imgpts_neck)
    _, tvox, timg = _port_inputs(tm, batch)
    marks = []
    with torch.no_grad():
        tout = tmodel(tvox, img_data=timg, mark=marks.append)
    for s in ("image backbone + FPN", "LSS lift", "LSS splat", "BevEncode",
              "SECOND + neck", "FocalEncoder", "decoder"):
        assert s in marks, s
    pfc, stages = neck["out"]
    _close(pfc, jneck[0], EVAL_TOL, "pts_feat_conv")
    assert len(stages) == len(jneck[1]) == 3  # two fusion layers + extra
    for i, (g, r) in enumerate(zip(stages, jneck[1])):
        _close(g, r, EVAL_TOL, f"stage feature {i}")
    _check_outputs(tout, out)
    tb = tmodel.get_bboxes(tout, 8)
    assert torch.isfinite(tb["bboxes"]).all()


# ---------------------------------------------------------------------------
# camera-only: the JAX fault and the port's head on the LSS BEV
# ---------------------------------------------------------------------------

def test_camera_only_reads_the_images_where_jax_does_not():
    jm, tm = tiny(input_pts=False)
    b0 = _batch(0)
    b1 = dict(b0, imgs=np.ascontiguousarray(b0["imgs"][:, ::-1]))
    assert not np.array_equal(b0["imgs"], b1["imgs"])
    sd = jref_keys.make_fake_state_dict(jm, seed=3)
    model, variables, _, img0 = _jax_variables(jm, b0, sd)
    img1 = {k: jnp.asarray(b1[k]) for k in IMG_KEYS}
    run = jax.jit(lambda v, img: model.apply(
        v, None, img, False, capture_intermediates=lambda mdl, _: (
            isinstance(mdl, JaxLSS))))
    (j0, inter), (j1, _) = run(variables, img0), run(variables, img1)
    for k in ("center", "heatmap", "dense_heatmap"):  # the JAX fault
        np.testing.assert_array_equal(np.asarray(j0[k]), np.asarray(j1[k]))
    jbev = inter["intermediates"]["imgpts_neck"]["cam_lss"]["__call__"][0][0]
    # JAX's own head on JAX's own camera BEV: what the reference means
    dec = jfd.FocalDecoder(jm.decoder)
    want = jax.jit(lambda v, bev: dec.apply(
        {"params": v["params"]["pts_bbox_head"],
         "batch_stats": v["batch_stats"]["pts_bbox_head"]},
        bev, [bev], False))(variables, jbev)

    tmodel = _port_model(tm, sd).eval()
    with torch.no_grad():
        t0 = tmodel(None, img_data=_port_inputs(tm, b0)[2])
        t1 = tmodel(None, img_data=_port_inputs(tm, b1)[2])
    assert not torch.equal(t0["dense_heatmap"], t1["dense_heatmap"])
    _check_outputs(t0, want)


# ---------------------------------------------------------------------------
# the frozen train step
# ---------------------------------------------------------------------------

def _mask(batch):
    H, W = batch["imgs"].shape[2:4]
    return (np.random.RandomState(21).uniform(0, 1, (H, W)) < 0.7) \
        .astype(np.float32)


def _noise(jm, batch):
    B, G = batch["gt_boxes"].shape[:2]
    return np.random.RandomState(9).uniform(
        -1, 1, (B, jm.decoder.add_gt_groups * G, 2)).astype(np.float32)


def _port_step(tm, sd, batch, engine="plain", noise=None, mask=None):
    tm = dataclasses.replace(tm, sparse_engine=engine)
    model = _port_model(tm, sd)
    for mod in model.modules():  # the decoder's dropouts off, as in JAX
        if isinstance(getattr(mod, "dropout", None), float):
            mod.dropout = 0.0
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tx = toptim.make_optimizer(total_steps=10)
    opt_state = tx.init(model.named_parameters())
    seen = {}
    hooks = [m.register_forward_hook(
        lambda mod, a, out, name=name: seen.update(
            {name: (mod.training, out[0].requires_grad
                    if isinstance(out, tuple) else out.requires_grad)}))
        for name, m in (("img_neck", model.img_neck),
                        ("cam_lss", model.imgpts_neck.cam_lss),
                        ("pts_neck", model.pts_neck)) if m is not None]
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    lcfg = tlosses.LossConfig(code_weights=(1.0,) * 8 + (0.2, 0.2))
    with pytest.MonkeyPatch.context() as mp:
        if noise is not None:
            mp.setattr(tfd, "gt_group_noise",
                       lambda g, shape, device: torch.from_numpy(noise))
        if mask is not None:
            fixed = torch.from_numpy(mask)[..., None]
            mp.setattr(tgm, "grid_mask", lambda g, imgs: imgs * fixed)
        gen = torch.Generator()
        gen.manual_seed(0)
        k1.reset_launch_count()
        metrics = tts.make_train_step(tm, lcfg, tx)(model, opt_state, tb, gen)
    for h in hooks:
        h.remove()
    return model, before, metrics, seen


def _lc_train_cfg():
    jm, tm = tiny(use_grid_mask=True, **FREEZE)
    jm = dataclasses.replace(jm, decoder=dataclasses.replace(
        jm.decoder, roi_dropout=0.0))
    return jm, _to_port(jm)


def _check_frozen(model, before):
    after = model.state_dict()
    frozen = [k for k in after if k.startswith(FROZEN)]
    assert any(k.endswith("running_mean") and k.startswith("img_backbone")
               for k in frozen)
    for k in frozen:
        assert torch.equal(after[k], before[k]), k
    named = dict(model.named_parameters())
    assert all(not named[k].requires_grad and named[k].grad is None
               for k in named if k.startswith(FROZEN))
    moved = [k for k in after if k.startswith(
        ("imgpts_neck.fusion_blocks.", "pts_bbox_head."))
        and not torch.equal(after[k], before[k])]
    assert any(".iterimg_conv." in k and "running_mean" in k for k in moved)
    assert any(".P_IML.query_project." in k for k in moved)
    return after


def test_port_lc_step_keeps_the_frozen_branches():
    """Engine ``cuda`` on CPU tensors (the kernels' plain versions): the
    frozen branches run in eval mode without autograd and keep every
    bit; the fusion layers (the camera BEV's iterimg_conv included) and
    the head move."""
    _, tm = _lc_train_cfg()
    sd = jref_keys.make_fake_state_dict(tiny()[0], seed=2)
    model, before, metrics, seen = _port_step(tm, sd, _batch(1, 2), "cuda")
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert [k1.launch_count(k) for k in ("forward", "dx", "wgrad")] == \
        [0, 0, 0]  # CPU tensors
    assert seen == {"img_neck": (False, False), "cam_lss": (False, False),
                    "pts_neck": (False, False)}
    _check_frozen(model, before)
    assert model.training and not model.img_backbone.training


def _jax_loss(jm, lcfg, model, params, batch_stats, batch, mask):
    vox = jax_prep(jm, batch["points"], batch["points_mask"], train=True)
    img = {k: batch[k] for k in IMG_KEYS}
    img["imgs"] = img["imgs"] * mask[..., None]
    out, _ = model.apply(
        {"params": params, "batch_stats": batch_stats}, vox, img, True,
        batch["gt_boxes"], batch["gt_labels"], batch["gt_valid"],
        rngs={"gt": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
        mutable=["batch_stats"])
    return detection_loss(jm.decoder, lcfg, out, batch["gt_boxes"],
                          batch["gt_labels"], batch["gt_valid"])[0]


@pytest.mark.slow
def test_tiny_lc_frozen_train_step_matches_jax(request):
    frozen_step_vs_jax(request, *_lc_train_cfg())


def frozen_step_vs_jax(request, jm, tm, jax_patches=(), moved=()):
    """One frozen train step of both packages from one state dict (dropout
    off, the same noise and grid mask), held as the module docstring says;
    ``jax_patches`` are (module, name, value) set on the JAX side for the
    step, and every parameter prefix in ``moved`` must move in the port."""
    jlcfg = jax_get_config("Tiny_L")["loss"]
    batch = _batch(1, 2)
    noise, mask = _noise(jm, batch), _mask(batch)
    sd = jref_keys.make_fake_state_dict(jm, seed=4)
    model, variables, _, _ = _jax_variables(jm, batch, sd, train=True)

    mp = pytest.MonkeyPatch()
    request.addfinalizer(mp.undo)
    mp.setattr(jfd, "DeformableDecoder",
               functools.partial(DeformableDecoder, dropout=0.0))

    def fixed_uniform(key, shape, *args, **kwargs):
        assert tuple(shape) == noise.shape, shape
        return jnp.asarray(noise)

    mp.setattr(jax.random, "uniform", fixed_uniform)
    mp.setattr(jts, "grid_mask", lambda key, imgs: imgs * mask[..., None])
    for mod, name, value in jax_patches:
        mp.setattr(mod, name, value)
    tx = joptim.make_optimizer(
        total_steps=10, trainable_mask=lambda p: jts.trainable_mask(jm, p))
    state = jts.TrainState(variables["params"], variables["batch_stats"],
                           tx.init(variables["params"]),
                           jnp.zeros((), jnp.int32))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    step = jts.make_train_step(jm, jlcfg, tx)

    @jax.jit
    def run(state, b):
        grads = jax.grad(lambda p: _jax_loss(
            jm, jlcfg, model, p, state.batch_stats, b, mask))(state.params)
        new_state, metrics = step(state, b, jax.random.PRNGKey(7))
        return new_state, metrics, grads

    new_state, jmet, jgrads = jax.device_get(run(state, jb))
    mp.undo()

    tmodel, before, tmet, _ = _port_step(tm, sd, batch, "plain", noise, mask)
    assert float(tmet["num_pos"]) == float(jmet["num_pos"])
    for k in jmet:
        if k == "grad_norm":  # JAX's also counts the frozen leaves' grads
            continue
        got, ref = float(tmet[k]), float(jmet[k])
        assert abs(got - ref) <= LOSS_TOL * max(abs(ref), 1e-12), \
            (k, got, ref)
    after = _check_frozen(tmodel, before)
    for prefix in moved:
        assert any(not torch.equal(after[k], before[k]) for k in after
                   if k.startswith(prefix)), prefix

    bs = new_state.batch_stats
    jg = _jax_state({"params": jgrads, "batch_stats": bs}, tm)
    ref = _jax_state({"params": new_state.params, "batch_stats": bs}, tm)
    params = dict(tmodel.named_parameters())
    trainable = [k for k in jg if k in params and params[k].requires_grad]
    assert len(trainable) > 100
    gmax = max(float(jg[k].abs().max()) for k in trainable)
    # Analytic zeros, both sides rounding noise (below 1e-5 of the largest
    # gradient): the bias of the last decoder layer's last norm (as in
    # tests/test_torch_train_step.py), and each fusion layer's
    # P_out_proj.bn.bias, a per-channel shift that P_integration's 1x1 conv
    # carries linearly into its training batch norm, which removes it.
    zeros = {f"pts_bbox_head.decoder.{jm.decoder.num_decoder_layers - 1}."
             f"layers.{jm.decoder.inner_layers - 1}.norms.2.bias"} | {
        f"imgpts_neck.fusion_blocks.{i}.P_out_proj.bn.bias"
        for i in range(jm.neck_layers)}
    def grad(k):  # None: outside the loss's graph (the last layer's
        # iterimg_conv, whose output nothing reads), a zero in JAX
        g = params[k].grad
        return np.zeros(tuple(params[k].shape), np.float32) if g is None \
            else g.numpy()

    for k in trainable:
        g, r = grad(k), jg[k].numpy()
        if k in zeros:
            assert max(np.abs(r).max(), np.abs(g).max()) <= 1e-5 * gmax, k
            continue
        err = np.abs(g - r).max() / max(np.abs(r).max(), 1e-12)
        assert err <= GRAD_TOL, f"grad {k}: {err:.3g}"

    ttx = toptim.make_optimizer(total_steps=10)
    clip_t = min(1.0, ttx.grad_clip / float(tmet["grad_norm"]))
    clip_j = min(1.0, ttx.grad_clip / float(np.sqrt(sum(
        float((jg[k].double() ** 2).sum()) for k in trainable))))
    checked = 0
    for k, v in ref.items():
        if k.startswith(FROZEN) or k.endswith(
                ("num_batches_tracked", "bev_pos", "frustum")):
            continue
        g, r = after[k].numpy(), v.numpy()
        allow = PARAM_TOL * max(np.abs(r).max(), 1e-3)
        if k in params:
            gt = grad(k) * clip_t
            gj = jg[k].numpy() * clip_j
            allow = allow + 1.01 * ttx.lr(0) * np.minimum(
                2.0, np.abs(gt - gj) / ttx.eps)
        worst = float(np.max(np.abs(g - r) / allow))
        assert worst <= 1.0, f"{k}: {worst:.3g} of its allowance"
        checked += 1
    assert checked > 100
    w = "imgpts_neck.shared_conv_pts.weight"
    jax_move = float((ref[w] - before[w]).abs().max())
    print(f"JAX LC step (optax.masked): shared_conv_pts moved by up to "
          f"{jax_move:.4g}; the port's kept every bit")

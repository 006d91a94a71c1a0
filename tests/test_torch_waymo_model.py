"""Parity: the Waymo model path, the port against the JAX package.

On ``Tiny_Waymo_L`` (HardVFE 5 -> 16, 3 classes, code size 8), one
reference-format state dict in both packages:

- the five Waymo configs mirror JAX's field for field; the port's key
  inventory, its models' state dicts (keys, shapes, the reference order)
  and its random reference weights equal JAX's, but for the class-aware
  heads of FocalFormer3D_Waymo15_L, which JAX's inventory lists at the
  class-agnostic width (a fault of the JAX package, ROADMAP.md Queue 3):
  there the port's inventory is JAX's with those heads widened, which
  JAX's own model takes (``convert_tree`` loads every leaf), and the
  weights are JAX's draws over that inventory;
- ``hard_voxelize``: the integer outputs (point slots' order, counts,
  coords, mask) equal JAX's bit for bit and the point slots too, on a scan
  that overflows both the voxel cap and the point slots, and on one that
  overflows neither; ``preprocess_points`` on the HardVFE at both caps;
- ``HardVFE``: eval, and one training call (batch statistics over every
  slot of every non-empty voxel, running averages updated), outputs and
  statistics within 1e-5 of JAX's;
- the eval forward within ``EVAL_TOL`` (1e-4) of JAX's scale, labels and
  masks exactly: ``Tiny_Waymo_L``; its variant with the full Waymo
  config's structure (three heatmap stages, two ``bevfusionmb2`` fusion
  layers), where the second masked re-probe keeps the kernel-1 classes
  (1, 2) undilated; and the class-aware heads;
- DeformFormer3D_Waymo_L's structure (two fusion layers, one heatmap
  stage), which JAX's head refuses: the port's stage reads the deepest
  map, held to JAX's neck and head modules fed that map;
- one ``Tiny_Waymo_L`` training step: losses within 1e-5, gradients within
  2e-4, as ``tests/test_torch_train_step.py`` holds Tiny_L's, but for the
  last decoder layer's FFN output bias, whose near-cancelled gradient is
  held to twice the float32 floor measured in the test (what a one-ulp
  change of the weights moves it in JAX).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from focalformer3d_tpu.configs import get_config as jax_get_config
from focalformer3d_tpu.data import synthetic
from focalformer3d_tpu.models import focal_decoder as jfd
from focalformer3d_tpu.models.detector import FocalFormer3D as JaxFF3D
from focalformer3d_tpu.models.detector import preprocess_points as jax_prep
from focalformer3d_tpu.models.vfe import HardVFE as JaxHardVFE
from focalformer3d_tpu.ops import voxelize as jvox
from focalformer3d_tpu.utils import convert as jconvert
from focalformer3d_tpu.utils import ref_keys as jref_keys
from focalformer3d_tpu_torch import configs as tconfigs
from focalformer3d_tpu_torch.models import detector as tdet
from focalformer3d_tpu_torch.models import focal_decoder as tfd
from focalformer3d_tpu_torch.models import vfe as tvfe
from focalformer3d_tpu_torch.ops import voxelize as tvox
from focalformer3d_tpu_torch.training import losses as tlosses
from focalformer3d_tpu_torch.utils import jax_keys
from focalformer3d_tpu_torch.utils.ref_keys import (make_fake_state_dict,
                                                    reference_key_order)
from focalformer3d_tpu.models.deformable_decoder import DeformableDecoder
from focalformer3d_tpu.training.train_step import TrainState
from test_torch_dynamic import _picks
from test_torch_train_step import _jax_loss, check_gradients, check_losses
from test_torch_train_step import _noise as tts_noise
from test_torch_train_step import run_both

torch.set_num_threads(2)
EVAL_TOL = 1e-4
VFE_TOL = 1e-5
WAYMO = ("FocalFormer3D_Waymo_L", "Tiny_Waymo_L", "FocalFormer3D_Waymo15_L",
         "DeformFormer3D_Waymo_L", "DeformFormer3D_Waymo15_L")
BOX_HEADS = ("center", "height", "dim", "rot")


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, ref, tol, msg):
    got = got.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (msg, got.shape, ref.shape)
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-3)
    assert err <= tol, f"{msg}: rel err {err:.3g} > {tol}"


def _eq(got, ref, msg):
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref), err_msg=msg)


def jax_inventory(jm):
    """JAX's ``reference_state_shapes`` with the class-aware box heads at
    the width JAX's model builds (``num_classes`` times the class-agnostic
    one)."""
    d = dict(jref_keys.reference_state_shapes(jm))
    if jm.decoder.classaware_reg:
        n = jm.decoder.num_classes
        for k, s in d.items():
            p = k.split(".")
            if (k.startswith("pts_bbox_head.prediction_heads.")
                    and p[3] in BOX_HEADS and p[4] == "1"):
                d[k] = (s[0] * n,) + tuple(s[1:])
    return d


def jax_fake_state_dict(jm, seed):
    """JAX's ``make_fake_state_dict`` over ``jax_inventory``."""
    shapes = jax_inventory(jm)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jref_keys, "reference_state_shapes", lambda cfg: shapes)
        return jref_keys.make_fake_state_dict(jm, seed)


def _to_port(jm):
    d = dataclasses.asdict(jm)
    return tconfigs.DetectorConfig(**{
        **d, "voxel": tconfigs.VoxelConfig(**d["voxel"]),
        "lss": tconfigs.LSSConfig(**d["lss"]),
        "decoder": tconfigs.FocalDecoderConfig(**d["decoder"])})


def tiny(variant="base"):
    """(JAX config, port config) of Tiny_Waymo_L: ``base``; ``hip3`` with
    the full Waymo config's structure (two heatmap stages plus the reused
    first, two fusion layers); ``classaware`` with class-aware heads."""
    jm = jax_get_config("Tiny_Waymo_L")["model"]
    if variant == "hip3":
        jm = dataclasses.replace(
            jm, neck_layers=2,
            decoder=dataclasses.replace(jm.decoder, multistage_heatmap=2))
    elif variant == "classaware":
        jm = dataclasses.replace(jm, decoder=dataclasses.replace(
            jm.decoder, classaware_reg=True))
    tm = _to_port(jm)
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    return jm, tm


def _scan(seed=11, n=4000, batch_size=1):
    jm = jax_get_config("Tiny_Waymo_L")["model"]
    return synthetic.make_batch(
        np.random.RandomState(seed), batch_size=batch_size, n_points=n,
        n_boxes=6, max_gts=8, num_classes=3,
        pc_range=jm.voxel.point_cloud_range, mode="radial")


# ---------------------------------------------------------------------------
# configs, keys, weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", WAYMO)
def test_waymo_config_mirrors_jax(name):
    j, t = jax_get_config(name), tconfigs.get_config(name)
    assert set(t) == set(j) and t["dataset"] == "waymo"
    for k in ("model", "loss", "train"):
        assert dataclasses.asdict(t[k]) == dataclasses.asdict(j[k]), k
    for k in set(t) - {"model", "loss", "train"}:
        assert t[k] == j[k], k
    assert t.get("load_interval", 1) == (5 if "15" in name else 1)
    assert name in tconfigs.available()


@pytest.mark.parametrize("name", WAYMO)
def test_waymo_keys_and_weights_match_jax(name):
    jm = jax_get_config(name)["model"]
    tm = tconfigs.get_config(name)["model"]
    shapes = jax_inventory(jm)
    got = jax_keys.reference_state_shapes(tm)
    assert list(got.items()) == list(shapes.items())
    widened = {k for k, s in shapes.items()
               if s != jref_keys.reference_state_shapes(jm)[k]}
    assert (len(widened) == 8 * jm.decoder.num_decoder_layers) == \
        jm.decoder.classaware_reg
    assert list(got)[0] == "pts_voxel_encoder.vfe_layers.0.linear.weight"
    model = tdet.FocalFormer3D(tm)
    own = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert own == shapes
    assert reference_key_order(model) == list(shapes)
    fake = make_fake_state_dict(model, seed=1)
    ref = jax_fake_state_dict(jm, seed=1)
    assert list(fake) == list(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(fake[k].numpy(), v, err_msg=k)
    ref_map = jconvert.build_mapping(shapes)
    got_map = jax_keys.build_mapping(shapes)
    assert list(got_map) == list(ref_map)
    for k, targets in ref_map.items():
        assert [(c, p) for c, p, _ in got_map[k]] == \
            [(c, p) for c, p, _ in targets], k


# ---------------------------------------------------------------------------
# hard_voxelize and the batched entry point
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_voxels,max_points", [(512, 5), (4096, 64)])
def test_hard_voxelize_matches_jax(max_voxels, max_points):
    """(512, 5): Tiny_Waymo_L's caps, which a 4000-point radial scan
    overflows in voxels and in point slots; (4096, 64): neither."""
    jv = dataclasses.replace(jax_get_config("Tiny_Waymo_L")["model"].voxel,
                             max_voxels=max_voxels, max_num_points=max_points)
    tv = tconfigs.VoxelConfig(**dataclasses.asdict(jv))
    b = _scan()
    pts, mask = b["points"][0], b["points_mask"][0].copy()
    pts[:150, :3] += 9.0  # some out of range
    mask[-300:] = False  # a padded tail
    ref = jax.device_get(jax.jit(
        lambda p, m: jvox.hard_voxelize(jv, p, m))(pts, mask))
    got = tvox.hard_voxelize(tv, _t(pts), _t(mask))
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == {"voxels": torch.float32,
                                "num_points": torch.int32,
                                "coords": torch.int32,
                                "voxel_mask": torch.bool}[k], k
        _eq(got[k], ref[k], k)
    n = got["num_points"]
    overflow = (int(got["voxel_mask"].sum()) == max_voxels,
                int(n.max()) == max_points)
    assert overflow == ((True, True) if max_voxels == 512 else
                        (False, False))
    # empty slots are zero, and the slots hold points in input order
    slot = torch.arange(max_points)
    assert not got["voxels"][slot >= n[:, None]].any()


def test_preprocess_points_hard_vfe_matches_jax():
    jm, tm = tiny()
    jm = dataclasses.replace(jm, voxel=dataclasses.replace(
        jm.voxel, max_voxels=300, max_voxels_test=640))
    tm = _to_port(jm)
    b = _scan(seed=2, batch_size=2)
    for train in (False, True):
        ref = jax.device_get(jax_prep(jm, b["points"], b["points_mask"],
                                      train=train))
        got = tdet.preprocess_points(tm, _t(b["points"]),
                                     _t(b["points_mask"]), train=train)
        assert set(got) == set(ref) == {"voxels", "num_points", "coords",
                                        "voxel_mask"}
        assert got["voxels"].shape == (2, 300 if train else 640, 5, 5)
        for k in ref:
            _eq(got[k], ref[k], f"train={train} {k}")


# ---------------------------------------------------------------------------
# HardVFE
# ---------------------------------------------------------------------------

def _vfe_inputs():
    """Two samples of 300 radial points whose first 60 each come 7 times
    (jittered within 1e-4 m): full voxels past the 5 slots, partly filled
    ones and, with 512 voxels, empty ones."""
    jm, tm = tiny()
    b = _scan(seed=4, n=300, batch_size=2)
    rng = np.random.RandomState(8)
    pts = np.concatenate([b["points"]] + [
        b["points"][:, :60] + rng.uniform(-1e-4, 1e-4, (2, 60, 5)).astype(
            np.float32) for _ in range(6)], axis=1)
    mask = np.concatenate([b["points_mask"]]
                          + [b["points_mask"][:, :60]] * 6, axis=1)
    vox = tdet.preprocess_points(tm, _t(pts), _t(mask))
    assert (~vox["voxel_mask"]).any() and (vox["num_points"] == 5).any()
    return jm, tm, vox


@pytest.mark.parametrize("train", [False, True])
def test_hard_vfe_matches_jax(train):
    jm, tm, vox = _vfe_inputs()
    sd = jref_keys.make_fake_state_dict(jm, seed=6)
    vfe = tvfe.HardVFE(5, tm.vfe_channels)
    vfe.load_state_dict({k.split(".", 1)[1]: _t(v) for k, v in sd.items()
                         if k.startswith("pts_voxel_encoder.")
                         and not k.endswith("num_batches_tracked")},
                        strict=False)
    jmod = JaxHardVFE(feat_channels=jm.vfe_channels)
    jin = (jnp.asarray(vox["voxels"].numpy()),
           jnp.asarray(vox["num_points"].numpy()),
           jnp.asarray(vox["coords"].numpy()))
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *jin))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   shapes)
    wrapped, report = jconvert.convert_tree(
        {c: {"vfe": v} for c, v in zeros.items()},
        {k: v for k, v in sd.items() if k.startswith("pts_voxel_encoder.")})
    assert not report.missed and not report.unloaded, report.summary()
    variables = {c: v["vfe"] for c, v in wrapped.items()}
    ref, new = jax.jit(lambda v: jmod.apply(
        v, *jin, train, mutable=["batch_stats"]))(variables)
    vfe.train(train)
    got = vfe(vox["voxels"], vox["num_points"])
    _close(got, ref, VFE_TOL, "HardVFE output")
    empty = ~vox["voxel_mask"]
    assert not got[empty].any()
    # a padded slot carries relu(BN(0)) into the max (mmdet3d's quirk)
    assert (got[vox["voxel_mask"]] > 0).any()
    stats = jax.device_get(new["batch_stats"]["vfe_bn0"])
    bn = vfe.vfe_layers[0].norm
    for name, mine in (("mean", bn.running_mean), ("var", bn.running_var)):
        _close(mine, stats[name], VFE_TOL, f"running {name}")
    moved = not np.array_equal(
        stats["mean"], np.asarray(sd["pts_voxel_encoder.vfe_layers.0.norm."
                                     "running_mean"]))
    assert moved == train


def test_hard_simple_vfe_matches_jax():
    from focalformer3d_tpu.models.vfe import hard_simple_vfe

    _, _, vox = _vfe_inputs()
    ref = hard_simple_vfe(jnp.asarray(vox["voxels"].numpy()),
                          jnp.asarray(vox["num_points"].numpy()))
    _close(tvfe.hard_simple_vfe(vox["voxels"], vox["num_points"]), ref,
           1e-6, "hard_simple_vfe")


# ---------------------------------------------------------------------------
# the eval forward
# ---------------------------------------------------------------------------

def _jax_variables(jm, vox, sd):
    model = JaxFF3D(jm)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, vox, None, False))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   shapes)
    variables, report = jconvert.convert_tree(zeros, sd)
    assert report.full and not report.unloaded, report.summary()
    return model, variables


@functools.lru_cache(maxsize=None)
def _eval_run(variant):
    """JAX's forward and ``get_bboxes`` of one radial scan, and the port's,
    from one state dict."""
    jm, tm = tiny(variant)
    sd = jax_fake_state_dict(jm, seed=3)
    b = _scan(seed=7)
    pts, mask = b["points"], b["points_mask"]
    vox = jax.jit(lambda p, m: jax_prep(jm, p, m))(pts, mask)
    model, variables = _jax_variables(jm, vox, sd)
    out = jax.device_get(jax.jit(lambda v, p, m: model.apply(
        v, jax_prep(jm, p, m), None, False))(variables, pts, mask))
    dec = jax.device_get(jfd.get_bboxes(jm.decoder, out, 200))
    tmodel = tdet.FocalFormer3D(tm).eval()
    tmodel.load_state_dict({k: _t(v) for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        tvox_ = tdet.preprocess_points(tm, _t(pts), _t(mask))
        tout = tmodel(tvox_)
        tdec = tmodel.get_bboxes(tout, 200)
    return dict(tm=tm, out=out, dec=dec, tout=tout, tdec=tdec)


@pytest.fixture(params=["base", "hip3", "classaware"])
def eval_run(request):
    return _eval_run(request.param)


def test_waymo_eval_forward_matches_jax(eval_run):
    r = eval_run
    out, tout, tm = r["out"], r["tout"], r["tm"]
    S = tm.decoder.total_stages
    P = tm.decoder.num_proposals
    assert tout["query_labels"].shape == (1, S * P)
    assert tout["dense_heatmap"].shape[1] == S
    assert tout["center"].shape[-1] == 2 and "vel" not in tout
    assert set(out) <= set(tout)
    for k, v in out.items():
        v = np.asarray(v)
        if v.dtype == bool or np.issubdtype(v.dtype, np.integer):
            _eq(tout[k], v, k)
        else:
            _close(tout[k], v, EVAL_TOL, k)
    dec, tdec = r["dec"], r["tdec"]
    assert tdec["bboxes"].shape[-1] == 7  # code size 8: no velocity
    for k in ("labels", "mask"):
        _eq(tdec[k], dec[k], f"decoded {k}")
    for k in ("bboxes", "scores"):
        _close(tdec[k], dec[k], EVAL_TOL, f"decoded {k}")
    assert int(tdec["mask"].sum()) > 0
    assert torch.isfinite(tdec["bboxes"]).all()


def test_second_reprobe_keeps_kernel1_classes_undilated():
    """Three stages: each stage's mask removes the cells the stage before
    it picked (its peaks of the masked heat, top ``num_proposals``),
    dilated by the 3 x 3 kernel for class 0 (Car) and not for the kernel-1
    classes 1 and 2 (Pedestrian, Cyclist); the masks equal JAX's
    (``test_waymo_eval_forward_matches_jax``)."""
    run = _eval_run("hip3")
    tout, tm = run["tout"], run["tm"]
    cfg = tm.decoder
    assert cfg.total_stages == 3 and tm.neck_layers == 2
    assert cfg.kernel1_classes == (1, 2)
    masks = tout["multistage_masks"].permute(0, 1, 4, 2, 3)  # (B,S,C,H,W)
    B, S, C, H, W = masks.shape
    for i in range(S - 1):
        heat = torch.sigmoid(tout["dense_heatmap"][:, i].permute(0, 3, 1, 2))
        peaks = tfd._peak_suppress(heat * masks[:, i], cfg.nms_kernel_size,
                                   cfg.kernel1_classes)
        top = tfd._stable_top_k(peaks.reshape(B, -1), cfg.num_proposals)
        sel = torch.zeros(B, C * H * W)
        sel.scatter_(1, top, 1.0)
        sel = sel.reshape(B, C, H, W)
        dil = F.max_pool2d(sel, 3, 1, 1)
        live = masks[:, i] == 1
        newly = live & (masks[:, i + 1] == 0)
        for c in range(C):
            want = (sel if c in cfg.kernel1_classes else dil)[:, c] == 1
            assert torch.equal(newly[:, c], want & live[:, c]), (i, c)
        assert int(sel[:, 0].sum()) > 0 and int(sel[:, 1:].sum()) > 0
        assert int(newly[:, 0].sum()) > int((sel[:, 0] * live[:, 0]).sum())
    assert int((masks[:, 2] == 0).sum()) > int((masks[:, 1] == 0).sum()) > 0


def test_deform_waymo_structure_reads_the_deepest_map():
    """DeformFormer3D_Waymo_L's structure at Tiny width (two fusion layers,
    one heatmap stage without reuse): JAX's head asserts that the neck's
    maps and the stages agree, so its model does not run (a fault of the
    JAX package, ROADMAP.md Queue 3); the port's stage reads the deepest
    map. The port's neck and head equal JAX's ``FocalEncoder`` and
    ``FocalDecoder`` modules, with its deepest map as the stage's, on the
    port's SECOND-FPN output, within EVAL_TOL."""
    from focalformer3d_tpu.configs.variants import _deform_deltas
    from focalformer3d_tpu.models.focal_encoder import FocalEncoder

    base = _deform_deltas(jax_get_config("Tiny_Waymo_L"))["model"]
    # 16 proposals: the tiny BEV has 3 x 64 (class, cell) candidates
    jm = dataclasses.replace(base, neck_layers=2, decoder=dataclasses.replace(
        base.decoder, num_proposals=16))
    tm = _to_port(jm)
    assert tm.decoder.total_stages == 1 and tm.neck_layers == 2
    assert dataclasses.asdict(tconfigs.deform_deltas(
        tconfigs.get_config("Tiny_Waymo_L"))["model"]) == dataclasses.asdict(
        base)
    b = _scan(seed=7)
    vox = jax_prep(jm, b["points"], b["points_mask"])
    with pytest.raises(AssertionError, match=r"\(2, 1\)"):
        jax.eval_shape(lambda: JaxFF3D(jm).init(jax.random.PRNGKey(0), vox,
                                                None, False))

    model = tdet.FocalFormer3D(tm).eval()
    sd = make_fake_state_dict(model, seed=5)
    model.load_state_dict(sd, strict=True)
    seen = {}
    model.pts_neck.register_forward_hook(
        lambda m, a, out: seen.update(fpn=out))
    with torch.no_grad():
        out = model(tdet.preprocess_points(tm, _t(b["points"]),
                                           _t(b["points_mask"])))
    fpn = jnp.asarray(seen["fpn"].numpy())
    enc = FocalEncoder(num_layers=2, hidden=jm.hidden, iterbev=jm.iterbev,
                       iterbev_wo_img=True, multistage_heatmap=1,
                       extra_feat=False, input_img=False, input_pts=True,
                       dtype=jm.jdtype)
    dec = jfd.FocalDecoder(jm.decoder)
    e_shapes = jax.eval_shape(lambda: enc.init(jax.random.PRNGKey(0), None,
                                               fpn, False))
    pfc0, st0 = jax.eval_shape(lambda: enc.apply(
        jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                               e_shapes), None, fpn, False))
    d_shapes = jax.eval_shape(lambda: dec.init(
        jax.random.PRNGKey(0), jnp.zeros(pfc0.shape, pfc0.dtype),
        [jnp.zeros(st0[-1].shape, st0[-1].dtype)], False))
    tree = {c: {"imgpts_neck": e_shapes[c], "pts_bbox_head": d_shapes[c]}
            for c in ("params", "batch_stats")}
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), tree)
    variables, report = jconvert.convert_tree(
        zeros, {k: v.numpy() for k, v in sd.items()})
    assert not report.missed and not report.unloaded, report.summary()
    pfc, stages = enc.apply({c: v["imgpts_neck"] for c, v in
                             variables.items()}, None, fpn, False)
    assert len(stages) == 2
    ref = jax.device_get(dec.apply({c: v["pts_bbox_head"] for c, v in
                                    variables.items()}, pfc, stages[-1:],
                                   False))
    # the random weights' heat has near-ties among the 16 picks: hold the
    # queries as a set, as tests/test_torch_dynamic.py does
    jidx, jpeaks = _picks(ref, tm.decoder)
    tidx, _ = _picks(out, tm.decoder)
    assert sorted(tidx) == sorted(jidx), "the port picks other cells"
    where = {int(x): q for q, x in enumerate(tidx)}
    perm = np.asarray([where[int(x)] for x in jidx])
    moved = np.flatnonzero(perm != np.arange(len(perm)))
    assert np.all(np.abs(jpeaks[jidx[moved]] - jpeaks[tidx[moved]]) <= 1e-6)
    for k, v in ref.items():
        v = np.asarray(v)
        got = out[k]
        if k in ("center", "height", "dim", "rot", "heatmap"):
            got = got[..., perm, :]
        elif k in ("query_labels", "query_heatmap_score"):
            got = got[:, perm]
        if v.dtype == bool or np.issubdtype(v.dtype, np.integer):
            _eq(got, v, k)
        else:
            _close(got, v, EVAL_TOL, k)


# ---------------------------------------------------------------------------
# one training step
# ---------------------------------------------------------------------------

def _train_configs():
    j = jax_get_config("Tiny_Waymo_L")
    jm = dataclasses.replace(j["model"], decoder=dataclasses.replace(
        j["model"].decoder, roi_dropout=0.0))
    tm = dataclasses.replace(_to_port(jm), sparse_engine="plain")
    lcfg = tlosses.LossConfig(code_weights=tuple(j["loss"].code_weights))
    return jm, j["loss"], tm, lcfg


def _train_batch():
    return _scan(seed=5, n=2000, batch_size=2)


@pytest.fixture(scope="module")
def waymo_step(request):
    mp = pytest.MonkeyPatch()
    request.addfinalizer(mp.undo)
    return run_both(*_train_configs(), _train_batch(), mp)


def _jax_grad_floor(name):
    """How far JAX's own gradient of ``name`` (a flax path) moves when
    every weight of the state dict that ``run_both`` loads is scaled by
    1 +- 2^-23 (a random sign per element: one float32 ulp), relative to
    the tensor's largest gradient: the float32 floor of that gradient."""
    jm, jlcfg, _, _ = _train_configs()
    batch = _train_batch()
    noise = tts_noise(jm, batch)
    sd = jref_keys.make_fake_state_dict(jm, seed=4)
    rng = np.random.RandomState(0)
    sd1 = {k: (v * (1 + 2.0 ** -23 * rng.choice([-1, 1], v.shape))).astype(
        v.dtype) if v.dtype == np.float32 else v for k, v in sd.items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfd, "DeformableDecoder",
                   functools.partial(DeformableDecoder, dropout=0.0))
        mp.setattr(jax.random, "uniform",
                   lambda key, shape, *a, **k: jnp.asarray(noise))
        model = JaxFF3D(jm)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        vox = jax_prep(jm, jb["points"], jb["points_mask"], train=True)
        shapes = jax.eval_shape(lambda: model.init(
            {"params": jax.random.PRNGKey(0), "gt": jax.random.PRNGKey(1),
             "dropout": jax.random.PRNGKey(2)}, vox, None, True,
            jb["gt_boxes"], jb["gt_labels"], jb["gt_valid"]))
        zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                       shapes)
        grad = jax.jit(jax.grad(lambda p, st: _jax_loss(
            jm, jlcfg, model, p, st, jb)))
        out = []
        for d in (sd, sd1):
            v, _ = jconvert.convert_tree(zeros, d)
            st = TrainState(v["params"], v["batch_stats"], None,
                            jnp.zeros((), jnp.int32))
            g = jax.device_get(grad(v["params"], st))
            for p in name.split("/"):
                g = g[p]
            out.append(np.asarray(g, np.float64))
    return np.abs(out[1] - out[0]).max() / np.abs(out[0]).max()


def test_waymo_train_step_losses_match_jax(waymo_step):
    check_losses(waymo_step)
    assert "loss_vel" not in waymo_step["tmetrics"]


# The last decoder layer's FFN output bias: its gradient sums over the
# queries what the prediction heads' training batch norm nearly cancels
# (a per-channel shift before the last LayerNorm moves every query almost
# alike), so a one-ulp change of the weights moves it by ~1.7e-4 of its
# largest value in JAX alone. It is held to twice that floor, measured
# here; every other gradient to GRAD_TOL (2e-4) by ``check_gradients``.
NEAR_CANCELLED = "pts_bbox_head/decoder1/layer0/ffn2/bias"


def test_waymo_train_step_gradients_match_jax(waymo_step):
    r = waymo_step
    assert any(k.startswith("pts_voxel_encoder.") for k in r["tgrads"])
    tmpl = {"params": jax.tree_util.tree_map(np.zeros_like, r["jgrads"])}
    conv, report = jconvert.convert_tree(tmpl, r["tgrads"])
    assert not report.missed and not report.unmapped, report.summary()
    path = tuple(NEAR_CANCELLED.split("/"))
    got = np.asarray(conv["params"][path[0]][path[1]][path[2]][path[3]]
                     [path[4]], np.float64)
    ref = np.asarray(r["jgrads"][path[0]][path[1]][path[2]][path[3]]
                     [path[4]], np.float64)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    floor = _jax_grad_floor(NEAR_CANCELLED)
    assert floor > 0 and err <= 2 * floor, (err, floor)
    held = dict(r, jgrads=jax.tree_util.tree_map(lambda x: x, r["jgrads"]))
    # that one tensor compared above; the rest by the shared check
    leaf = held["jgrads"]
    for p in path[:-1]:
        leaf = leaf[p]
    leaf[path[-1]] = conv["params"][path[0]][path[1]][path[2]][path[3]][
        path[4]]
    check_gradients(held)

"""Parity: the modes that no named config sets, the port against JAX.

- The head's ``pos`` and ``boxcls`` mask modes (``boxcls`` with its dense
  box heads, ``heatmap_box``) on Tiny_L: JAX's ``model.init`` draws the
  weights (its key inventory has no box heads, so no reference state dict
  holds them) and the port loads ``from_jax_variables`` of them. The eval
  forward: query labels and the HIP masks exactly, heatmaps, scores and
  box heads within 5e-3 of scale (``tests/test_torch_model.py``'s
  tolerances); one training step (dropout off, the groups' noise one
  numpy draw, as ``tests/test_torch_train_step.py``): losses within 1e-5,
  gradients within 2e-4 of each tensor's largest (compared in the port's
  layout, where the box heads have names; their gradients are zero in
  both packages, as the masks read them detached), parameters and
  batch-norm statistics within ``check_params``' allowance.
- ``ops/points_in_boxes`` bit for bit against JAX's.
- The HardVFE with each of its offsets (``with_cluster_center``,
  ``with_voxel_center``, both), which JAX's ``DetectorConfig`` cannot
  ask for: the port's module against JAX's module built with them, eval
  and training, within 1e-5 of scale.
- The ``pillar`` engine, which the port does not port (a TPU layout of
  engine ``voxel``'s function): JAX's ``engine="pillar"`` encoder equals
  the port's ``plain`` engine on the same weights within 2e-4 (the
  sparse-encoder tolerance of ``tests/test_torch_model.py``), and the
  port's encoder refuses ``pillar`` naming the ROADMAP entry.
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
from focalformer3d_tpu.models.detector import FocalFormer3D as JaxFF3D
from focalformer3d_tpu.models.detector import preprocess_points as jax_prep
from focalformer3d_tpu.models.sparse_encoder import SparseEncoder as JaxEnc
from focalformer3d_tpu.models.vfe import HardVFE as JaxHardVFE
from focalformer3d_tpu.ops.points_in_boxes import (
    points_in_boxes as jax_pib, points_in_boxes_mask as jax_pib_mask)
from focalformer3d_tpu_torch import configs as tconfigs
from focalformer3d_tpu_torch.models import detector as tdet
from focalformer3d_tpu_torch.models import vfe as tvfe
from focalformer3d_tpu_torch.models.sparse_encoder import SparseEncoder
from focalformer3d_tpu_torch.ops.points_in_boxes import (
    points_in_boxes, points_in_boxes_mask)
from focalformer3d_tpu_torch.training import losses as tlosses
from focalformer3d_tpu_torch.utils.convert import from_jax_variables
from test_torch_model import _close, _enc_kwargs, _eq
from test_torch_train_step import (GRAD_TOL, check_losses, check_params,
                                   run_both)
from test_torch_waymo_model import _vfe_inputs

torch.set_num_threads(2)
MODES = {"pos": dict(mask_heatmap_mode="pos"),
         "boxcls": dict(mask_heatmap_mode="boxcls", heatmap_box=True)}


def _t(x):
    return torch.from_numpy(np.array(x))


def _configs(mode):
    """(JAX config, JAX loss, port config, port loss) of Tiny_L in
    ``mode``, RoI dropout off, engine plain."""
    jcfg = jax_get_config("Tiny_L")
    jm = jcfg["model"]
    jm = dataclasses.replace(jm, decoder=dataclasses.replace(
        jm.decoder, roi_dropout=0.0, **MODES[mode]))
    tm = tconfigs.get_config("Tiny_L")["model"]
    tm = dataclasses.replace(tm, sparse_engine="plain",
                             decoder=dataclasses.replace(
                                 tm.decoder, roi_dropout=0.0, **MODES[mode]))
    lcfg = tlosses.LossConfig(code_weights=tuple(jcfg["loss"].code_weights))
    return jm, jcfg["loss"], tm, lcfg


def _batch(batch_size):
    jm = jax_get_config("Tiny_L")["model"]
    return synthetic.make_batch(
        np.random.RandomState(5), batch_size=batch_size, n_points=2000,
        n_boxes=4, max_gts=8, num_classes=jm.decoder.num_classes,
        pc_range=jm.voxel.point_cloud_range, mode="radial")


def _fill(shapes, seed):
    """Random flax variables of the given shapes, drawn as
    ``make_fake_state_dict`` draws a reference state dict: running
    variances U(0.5, 2), everything else N(0, 0.1)."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        if path[-1].key == "var":
            return rng.uniform(0.5, 2.0, s.shape).astype(s.dtype)
        return rng.normal(0, 0.1, s.shape).astype(s.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@functools.lru_cache(maxsize=None)
def _mode_setup(mode):
    """Random flax variables of JAX's Tiny_L in ``mode`` (the leaves of
    its ``model.init``), its eval forward on one scan, and the port model
    loaded from those variables."""
    jm, jlcfg, tm, lcfg = _configs(mode)
    batch = _batch(1)
    model = JaxFF3D(jm)
    vox = jax.jit(lambda p, m: jax_prep(jm, p, m))(batch["points"],
                                                   batch["points_mask"])
    variables = _fill(jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, vox, None, False)), seed=4)
    jout = jax.device_get(jax.jit(lambda v, x: model.apply(
        v, x, None, False))(variables, vox))
    tmodel = tdet.FocalFormer3D(tm).eval()
    tmodel.load_state_dict(from_jax_variables(variables, tm), strict=True)
    return dict(mode=mode, jm=jm, jlcfg=jlcfg, tm=tm, lcfg=lcfg,
                batch=batch, variables=variables, jout=jout, tmodel=tmodel)


@pytest.fixture(scope="module", params=list(MODES))
def mode_setup(request):
    return _mode_setup(request.param)


def test_box_heads_exist_only_in_boxcls(mode_setup):
    names = [k for k in mode_setup["tmodel"].state_dict()
             if ".heatmap_box_head." in k]
    jnames = [k for k in mode_setup["variables"]["params"]["pts_bbox_head"]
              if k.startswith("heatmap_box_head")]
    if mode_setup["mode"] == "boxcls":
        assert len(jnames) == mode_setup["jm"].decoder.total_stages
        assert {k.split(".")[2] for k in names} == {
            n[len("heatmap_box_head"):] for n in jnames}
    else:
        assert not names and not jnames


def test_eval_forward_finite(mode_setup):
    """The whole Tiny_L eval forward on the scan: finite, and the masks
    of the stages after the first moved off all-ones in both packages."""
    s = mode_setup
    with torch.no_grad():
        vox = tdet.preprocess_points(s["tm"], _t(s["batch"]["points"]),
                                     _t(s["batch"]["points_mask"]))
        out = s["tmodel"](vox)
    for k in ("dense_heatmap", "heatmap", "center"):
        assert torch.isfinite(out[k]).all(), k
    for masks in (out["multistage_masks"].numpy(),
                  np.asarray(s["jout"]["multistage_masks"])):
        assert (masks[:, 0] == 1).all() and (masks[:, -1] == 0).any()


def test_head_forward_matches_jax(mode_setup):
    """The head on random BEV maps (N(0, 1) a cell, as JAX's
    ``test_boxcls_masking_mode_forward`` feeds it; the scan's maps are
    nearly constant away from its points, where peak suppression decides
    between cells that agree to a few ulps): query labels and the HIP
    masks exactly, the rest within 5e-3 of scale."""
    s = mode_setup
    jm, v = s["jm"], s["variables"]
    S = jm.decoder.total_stages
    n_maps = S - int(jm.decoder.reuse_first_heatmap) + int(
        jm.decoder.extra_feat)
    H = W = 8
    rng = np.random.RandomState(7)
    maps = [rng.randn(1, H, W, jm.decoder.hidden).astype(np.float32)
            for _ in range(1 + n_maps)]
    head = jfd.FocalDecoder(jm.decoder)
    jout = jax.device_get(jax.jit(lambda hv, x, f: head.apply(
        hv, x, f, False))({c: v[c]["pts_bbox_head"] for c in v}, maps[0],
                           maps[1:]))
    with torch.no_grad():
        out = s["tmodel"].pts_bbox_head(_t(maps[0]),
                                        [_t(m) for m in maps[1:]])
    _eq(out["multistage_masks"], jout["multistage_masks"], "HIP masks")
    _eq(out["query_labels"], jout["query_labels"], "query labels")
    masks = np.asarray(jout["multistage_masks"])
    assert (masks[:, 0] == 1).all() and (masks[:, -1] == 0).any()
    for k in ("dense_heatmap", "query_heatmap_score", "heatmap", "center",
              "height", "dim", "rot", "vel"):
        _close(out[k], jout[k], 5e-3, k)


@functools.lru_cache(maxsize=None)
def _step_both(mode):
    mp = pytest.MonkeyPatch()
    try:
        s = _mode_setup(mode)
        return run_both(s["jm"], s["jlcfg"], s["tm"], s["lcfg"], _batch(2),
                        mp, variables=s["variables"])
    finally:
        mp.undo()


# the pos step is poscls' but for the mask: the quick profile runs boxcls
STEP_MODES = [pytest.param("pos", marks=pytest.mark.slow), "boxcls"]


@pytest.mark.parametrize("mode", STEP_MODES)
def test_train_step_losses_match_jax(mode):
    check_losses(_step_both(mode))


@pytest.mark.parametrize("mode", STEP_MODES)
def test_train_step_gradients_match_jax(mode):
    """In the port's layout; analytic zeros (attention key biases, the
    last decoder layer's last norm bias) are rounding noise on both sides,
    below 1e-5 of the largest gradient, as ``check_gradients`` holds
    them; the box heads' gradients are zero on both sides."""
    b = _step_both(mode)
    jg = from_jax_variables({"params": b["jgrads"],
                             "batch_stats": b["new_vars"]["batch_stats"]},
                            b["tm"])
    params = dict(b["tmodel"].named_parameters())
    gmax = max(float(jg[k].abs().max()) for k in params)
    last = (f"decoder.{b['jm'].decoder.num_decoder_layers - 1}.layers."
            f"{b['jm'].decoder.inner_layers - 1}.norms.2.bias")
    worst, box = [], 0
    for k in params:
        ref = jg[k].numpy()
        got = b["tgrads"].get(k, np.zeros_like(ref))
        if ".heatmap_box_head." in k:
            assert not ref.any() and not got.any(), k
            box += 1
            continue
        parts = [(k, ref, got)]
        if k.endswith("in_proj_bias"):  # q, k, v: the key bias is noise
            parts = [(f"{k}[{n}]", r, g) for n, r, g in
                     zip("qkv", np.split(ref, 3), np.split(got, 3))]
        for name, r, g in parts:
            if name.endswith("[k]") or name.endswith(last):
                assert max(np.abs(r).max(), np.abs(g).max()) <= 1e-5 * gmax
                continue
            err = np.abs(g - r).max() / max(np.abs(r).max(), 1e-12)
            worst.append((err, name))
    worst.sort()
    assert worst[-1][0] <= GRAD_TOL, worst[-5:]
    assert box == (5 * b["jm"].decoder.total_stages
                   if b["jm"].decoder.mask_heatmap_mode == "boxcls" else 0)


@pytest.mark.parametrize("mode", STEP_MODES)
def test_train_step_params_and_batch_stats_match_jax(mode):
    check_params(_step_both(mode))


# ---------------------------------------------------------------------------
# points_in_boxes
# ---------------------------------------------------------------------------

def test_points_in_boxes_equals_jax():
    rng = np.random.RandomState(0)
    pts = rng.uniform(-10, 10, (4000, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(-2, 2, 4000)
    boxes = np.concatenate([
        rng.uniform(-8, 8, (40, 2)), rng.uniform(-2, 0, (40, 1)),
        rng.uniform(0.5, 6, (40, 3)), rng.uniform(-np.pi, np.pi, (40, 1)),
    ], axis=1).astype(np.float32)
    valid = rng.rand(40) > 0.2
    m = points_in_boxes_mask(_t(pts), _t(boxes))
    np.testing.assert_array_equal(
        m.numpy(), np.asarray(jax_pib_mask(jnp.asarray(pts),
                                           jnp.asarray(boxes))))
    assert (m.sum(1) > 1).any()  # overlaps: the first box wins
    for v in (None, valid):
        got = points_in_boxes(_t(pts), _t(boxes),
                              None if v is None else _t(v))
        ref = np.asarray(jax_pib(jnp.asarray(pts), jnp.asarray(boxes),
                                 None if v is None else jnp.asarray(v)))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)
        assert (ref == -1).any() and (ref >= 0).any()


# ---------------------------------------------------------------------------
# the HardVFE's offsets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("cluster,voxel", [(True, False), (False, True),
                                           (True, True)])
def test_hard_vfe_offsets_match_jax(cluster, voxel, train):
    jm, tm, vox = _vfe_inputs()
    geo = dict(voxel_size=tm.voxel.voxel_size,
               point_cloud_range=tm.voxel.point_cloud_range)
    jmod = JaxHardVFE(feat_channels=jm.vfe_channels,
                      with_cluster_center=cluster, with_voxel_center=voxel,
                      **geo)
    jin = tuple(jnp.asarray(vox[k].numpy())
                for k in ("voxels", "num_points", "coords"))
    variables = jax.jit(lambda: jmod.init(jax.random.PRNGKey(1), *jin))()
    rng = np.random.RandomState(2)
    bs = {"mean": rng.normal(0, 0.1, tm.vfe_channels[0]).astype(np.float32),
          "var": rng.uniform(0.5, 2, tm.vfe_channels[0]).astype(np.float32)}
    variables = {"params": jax.device_get(variables["params"]),
                 "batch_stats": {"vfe_bn0": bs}}
    ref, new = jax.jit(lambda v: jmod.apply(
        v, *jin, train, mutable=["batch_stats"]))(variables)
    vfe = tvfe.HardVFE(5, tm.vfe_channels, with_cluster_center=cluster,
                       with_voxel_center=voxel, **geo)
    p = variables["params"]
    vfe.load_state_dict({
        "vfe_layers.0.linear.weight": _t(np.asarray(p["vfe_fc0"]["kernel"]).T),
        "vfe_layers.0.norm.weight": _t(p["vfe_bn0"]["scale"]),
        "vfe_layers.0.norm.bias": _t(p["vfe_bn0"]["bias"]),
        "vfe_layers.0.norm.running_mean": _t(bs["mean"]),
        "vfe_layers.0.norm.running_var": _t(bs["var"]),
        "vfe_layers.0.norm.num_batches_tracked": torch.tensor(0)},
        strict=True)
    assert vfe.vfe_layers[0].linear.in_features == 5 + 3 * (cluster + voxel)
    vfe.train(train)
    got = vfe(vox["voxels"], vox["num_points"], vox["coords"])
    _close(got, ref, 1e-5, "HardVFE output")
    stats = jax.device_get(new["batch_stats"]["vfe_bn0"])
    bn = vfe.vfe_layers[0].norm
    _close(bn.running_mean, stats["mean"], 1e-5, "running mean")
    _close(bn.running_var, stats["var"], 1e-5, "running var")
    assert train != np.array_equal(stats["mean"], bs["mean"])


# ---------------------------------------------------------------------------
# the pillar engine: recorded, not ported
# ---------------------------------------------------------------------------

def test_jax_pillar_engine_equals_the_port_plain_engine():
    """Eval, on JAX's random weights of Tiny_L and its scan. Capacities
    that hold every level of the scan: past a capacity the engines drop
    at different granularities (3D sites, BEV columns), as JAX's own
    ``tests/test_pillar_conv.py`` notes (at Tiny_L's L1-L3 capacities the
    pillar BEV parts from the voxel engine's by 1.5e-2 of scale)."""
    mode_setup = _mode_setup("pos")
    jm, v = mode_setup["jm"], mode_setup["variables"]
    kw = dict(_enc_kwargs(jm), capacities=(4096,) * 4, out_capacity=4096)
    enc = JaxEnc(engine="pillar", assume_csr=True, **kw)
    ev = {"params": v["params"]["pts_middle_encoder"],
          "batch_stats": v["batch_stats"]["pts_middle_encoder"]}
    b = mode_setup["batch"]
    vox = jax.device_get(jax.jit(lambda p, m: jax_prep(jm, p, m))(
        b["points"], b["points_mask"]))
    ref = jax.jit(lambda e, f, c, m: enc.apply(e, f, c, m, False))(
        ev, vox["features"], vox["coords"], vox["voxel_mask"])
    tenc = SparseEncoder(in_channels=5, engine="plain", dense_from=4,
                         **kw).eval()
    tenc.load_state_dict(
        mode_setup["tmodel"].pts_middle_encoder.state_dict(), strict=True)
    with torch.no_grad():
        got = tenc(_t(vox["features"]), _t(vox["coords"]),
                   _t(vox["voxel_mask"]))
    _close(got, ref, 2e-4, "pillar BEV")
    with pytest.raises(NotImplementedError, match="Without a counterpart"):
        SparseEncoder(in_channels=5, engine="pillar", **kw)

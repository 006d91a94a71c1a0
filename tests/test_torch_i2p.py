"""Parity: I2P and FocalFormer3D_LC_Proj, the port against the JAX package.

On the tiny LC config of ``tests/test_torch_camera_model.py`` with
``cam_proj="i2p"`` (2 cameras at 64 x 96, a 3 x 8 x 8 grid of projected
points a sample); one reference-format state dict in both packages:

- ``project_points_to_cams`` on random camera rigs with random image and
  BEV augmentations: the normalised coordinates within 1e-5 of their
  scale, the validity masks exactly, once the test has asserted that no
  point lies within ``BORDER`` (1e-5) of a border the strict inequalities
  test (z = eps, x or y = +-1), where a last-ulp difference could flip it;
- the ``I2P`` module on the LiDAR map and camera features of a random
  draw: the decorated BEV within ``EVAL_TOL`` (1e-4) of scale; with the
  cameras turned away from the grid it is exactly zero in both;
- the config mirrors JAX's field for field, and its reference keys, shapes
  and order equal JAX's;
- the tiny LC_Proj eval forward: the neck's stage features and every head
  output within ``EVAL_TOL`` of scale, the query labels exactly;
- the same frozen train step in the port alone on the kernel engine's CPU
  path: the image and point branches keep every bit, ``shared_conv_img``,
  I2P, the fusion layers and the head move;
- ``slow``: that step against JAX's jitted ``make_train_step``, as
  ``tests/test_torch_camera_model.py`` holds LC's (I2P's dropout off in
  both; ``shared_conv_pts``, which JAX's ``optax.masked`` moves, left out
  as there).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focalformer3d_tpu.configs import get_config as jax_get_config
from focalformer3d_tpu.models import focal_encoder as jfe
from focalformer3d_tpu.models import i2p as ji2p
from focalformer3d_tpu.utils import ref_keys as jref_keys
from focalformer3d_tpu.utils.convert import convert_tree
from focalformer3d_tpu_torch import configs as tconfigs
from focalformer3d_tpu_torch.models import detector as tdet
from focalformer3d_tpu_torch.models import i2p as ti2p
from focalformer3d_tpu_torch.ops import sparse_conv_cuda as k1
from focalformer3d_tpu_torch.utils import jax_keys
from focalformer3d_tpu_torch.utils.ref_keys import reference_key_order
from test_torch_camera_model import (EVAL_TOL, FREEZE, _batch, _capture,
                                     _check_frozen, _check_outputs, _close,
                                     _jax_variables, _port_inputs,
                                     _port_model, _port_step, _to_port,
                                     frozen_step_vs_jax, tiny)

torch.set_num_threads(2)
BORDER = 1e-5
PROJ = dict(cam_proj="i2p")
TRAINED = ("imgpts_neck.shared_conv_img.",
           "imgpts_neck.fusion_blocks.0.I2P_block.")


def _rig(seed, n_cams=3, hw=(64, 96)):
    """lidar2img of a synthetic rig, and random image and BEV
    augmentations (rotation, scale, shift)."""
    from focalformer3d_tpu_torch.data import synthetic

    rng = np.random.RandomState(seed)
    l2i = synthetic.make_cameras(rng, n_cams, hw).astype(np.float32)
    ia = np.tile(np.eye(4, dtype=np.float32), (n_cams, 1, 1))
    for n in range(n_cams):
        a, s = rng.uniform(-0.1, 0.1), rng.uniform(0.9, 1.1)
        ia[n, :2, :2] = s * np.array([[np.cos(a), -np.sin(a)],
                                      [np.sin(a), np.cos(a)]])
        ia[n, :2, 3] = rng.uniform(-5, 5, 2)
    ba = np.eye(4, dtype=np.float32)
    a = rng.uniform(-0.5, 0.5)
    ba[:2, :2] = rng.uniform(0.95, 1.05) * np.array(
        [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
    ba[:3, 3] = rng.uniform(-0.5, 0.5, 3)
    return l2i, ia, ba


def _near_border(pts, l2i, ia, ba, hw, eps=1e-5):
    """How many points lie within ``BORDER`` of a validity border, in
    float64 from the JAX formula."""
    pts = np.asarray(pts, np.float64)
    inv = np.linalg.inv(ba.astype(np.float64))
    p = pts @ inv[:3, :3].T + inv[:3, 3]
    cam = np.einsum("nij,pj->npi", l2i.astype(np.float64),
                    np.concatenate([p, np.ones_like(p[:, :1])], -1))
    z = cam[..., 2]
    xy = cam[..., :2] / np.maximum(z, eps)[..., None]
    xy = (np.einsum("nij,npj->npi", ia[:, :3, :3].astype(np.float64),
                    np.concatenate([xy, np.ones_like(xy[..., :1])], -1))
          + ia[:, None, :3, 3])[..., :2]
    xn, yn = xy[..., 0] / hw[1] * 2 - 1, xy[..., 1] / hw[0] * 2 - 1
    near = np.abs(z - eps) < BORDER
    front = z > eps
    for v in (xn, yn):
        near |= front & ((np.abs(v - 1) < BORDER) | (np.abs(v + 1) < BORDER))
    return int(near.sum())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_project_points_to_cams_matches_jax(seed):
    hw = (64, 96)
    pc = (-8.0, -8.0, -3.0, 8.0, 8.0, 3.0)
    pts = ti2p.bev_grid((4, 16, 16), pc)
    l2i, ia, ba = _rig(seed, hw=hw)
    assert _near_border(pts.numpy(), l2i, ia, ba, hw) == 0
    got_xy, got_v = ti2p.project_points_to_cams(
        pts, torch.from_numpy(l2i), torch.from_numpy(ia),
        torch.from_numpy(ba), hw)
    ref_xy, ref_v = ji2p.project_points_to_cams(
        jnp.asarray(pts.numpy()), jnp.asarray(l2i), jnp.asarray(ia),
        jnp.asarray(ba), hw)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))
    assert 0 < int(got_v.sum()) < got_v.numel()  # seen and unseen points
    ref_xy = np.asarray(ref_xy)
    fin = np.isfinite(ref_xy).all(-1)
    _close(got_xy[torch.from_numpy(fin)], ref_xy[fin], 1e-5, "xy")
    # without augmentations: the identities JAX substitutes
    got = ti2p.project_points_to_cams(pts, torch.from_numpy(l2i), None,
                                      None, hw)
    ref = ti2p.project_points_to_cams(
        pts, torch.from_numpy(l2i), torch.eye(4).expand(3, 4, 4),
        torch.eye(4), hw)
    assert torch.equal(got[1], ref[1])
    np.testing.assert_allclose(got[0].numpy(), ref[0].numpy(), rtol=1e-6,
                               atol=1e-5)


def _i2p_pair(c=16, z=3, hw=(64, 96), pc=(-8.0, -8.0, -3.0, 8.0, 8.0,
                                           3.0)):
    """(port I2P with random weights, JAX I2P, its flax variables)."""
    port = ti2p.I2P(c, z, pc, hw).eval()
    rng = np.random.RandomState(7)
    with torch.no_grad():
        for p in port.parameters():
            p.copy_(torch.from_numpy(rng.normal(0, 0.3, p.shape)
                                     .astype(np.float32)))
    la = port.learnedAlign
    bq, bk, bv = (b.numpy() for b in la.in_proj_bias.detach().split(c))
    params = {f"{n}_proj": {"kernel": w.detach().numpy().T, "bias": b}
              for n, w, b in (("q", la.q_proj_weight, bq),
                              ("k", la.k_proj_weight, bk),
                              ("v", la.v_proj_weight, bv))}
    params["out_proj"] = {"kernel": la.out_proj.weight.detach().numpy().T,
                          "bias": la.out_proj.bias.detach().numpy()}
    jmod = ji2p.I2P(pts_channels=c, max_points_height=z, pc_range=pc,
                    input_shape=hw)
    return port, jmod, {"params": params}


def _i2p_inputs(seed, B=2, n_cams=3, c=16, bev=(8, 8), fhw=(16, 24)):
    rng = np.random.RandomState(seed)
    lidar = rng.randn(B, *bev, c).astype(np.float32)
    feats = rng.randn(B, n_cams, *fhw, c).astype(np.float32)
    rigs = [_rig(seed * 10 + b, n_cams) for b in range(B)]
    l2i, ia, ba = (np.stack(x) for x in zip(*rigs))
    return lidar, feats, l2i, ia, ba


@pytest.mark.parametrize("seed", [3, 4])
def test_i2p_matches_jax(seed):
    port, jmod, variables = _i2p_pair()
    arrays = _i2p_inputs(seed)
    for b in range(2):
        pts = ti2p.bev_grid((3, 8, 8), port.pc_range)
        assert _near_border(pts.numpy(), *(a[b] for a in arrays[2:]),
                            port.input_shape) == 0
    ref = np.asarray(jax.jit(lambda *a: jmod.apply(variables, *a))(
        *(jnp.asarray(a) for a in arrays)))
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in arrays))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert np.abs(ref).max() > 0.1 and (np.abs(ref).sum(-1) == 0).any()
    _close(got, ref, EVAL_TOL, "I2P")
    # a cell no camera sees is zero in both
    np.testing.assert_array_equal(got.numpy() == 0, ref == 0)
    # bf16 LiDAR features: computed in float32 all the same
    with torch.no_grad():
        half = port(torch.from_numpy(arrays[0]).bfloat16(),
                    *(torch.from_numpy(a) for a in arrays[1:]))
    assert half.dtype == torch.float32


def test_i2p_dropout_draws_from_the_generator():
    port, _, _ = _i2p_pair()
    arrays = [torch.from_numpy(a) for a in _i2p_inputs(5)]
    port.train()
    outs = []
    for seed in (0, 0, 1):
        gen = torch.Generator()
        gen.manual_seed(seed)
        outs.append(port(*arrays, generator=gen))
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0],
                                                              outs[2])
    with torch.no_grad():
        ref = port.eval()(*arrays)
    kept = outs[0] != 0
    assert 0.8 < float(kept.float().mean() / (ref != 0).float().mean()) < 1
    torch.testing.assert_close(outs[0][kept], ref[kept] / 0.9)


# ---------------------------------------------------------------------------
# the config and its keys
# ---------------------------------------------------------------------------

def test_lc_proj_config_and_keys_mirror_jax():
    name = "FocalFormer3D_LC_Proj"
    j, t = jax_get_config(name), tconfigs.get_config(name)
    assert set(t) == set(j)
    for k in ("model", "loss", "train"):
        assert dataclasses.asdict(t[k]) == dataclasses.asdict(j[k]), k
    for k in ("class_names", "img_scale", "dataset"):
        assert t[k] == j[k], k
    m = t["model"]
    assert (m.cam_proj, m.iter_bev_cam, m.max_points_height,
            m.freeze_camlss, m.freeze_img, m.freeze_pts) == (
        "i2p", True, 10, False, True, True)
    assert name in tconfigs.available()
    shapes = jref_keys.reference_state_shapes(j["model"])
    assert list(jax_keys.reference_state_shapes(m).items()) == \
        list(shapes.items())
    with torch.device("meta"):
        model = tdet.FocalFormer3D(m)
    own = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert own == dict(shapes)
    assert reference_key_order(model) == list(shapes)
    i2p_keys = [k for k in shapes if ".I2P_block." in k]
    assert len(i2p_keys) == 6 and all(
        k.startswith("imgpts_neck.fusion_blocks.0.") for k in i2p_keys)
    assert not any("cam_lss" in k for k in shapes)
    trainable = tdet.trainable_mask(m, list(own))
    assert all(trainable[k] for k in own if k.startswith(TRAINED))
    assert not any(trainable[k] for k in own if k.startswith(
        ("img_backbone.", "img_neck.", "pts_middle_encoder.",
         "imgpts_neck.shared_conv_pts.")))


# ---------------------------------------------------------------------------
# eval forward and the frozen step
# ---------------------------------------------------------------------------

def test_tiny_lc_proj_eval_forward_matches_jax():
    jm, tm = tiny(**PROJ)
    batch = _batch(0)
    sd = jref_keys.make_fake_state_dict(jm, seed=3)
    model, variables, vox, img = _jax_variables(jm, batch, sd)
    out, inter = jax.jit(lambda v: model.apply(
        v, vox, img, False, capture_intermediates=lambda mdl, _: (
            mdl.name in ("imgpts_neck", "I2P_block"))))(variables)
    jneck = inter["intermediates"]["imgpts_neck"]["__call__"][0]
    ji2p_out = inter["intermediates"]["imgpts_neck"]["fusion0"][
        "I2P_block"]["__call__"][0]

    tmodel = _port_model(tm, sd).eval()
    neck = _capture(tmodel.imgpts_neck)
    i2p = _capture(tmodel.imgpts_neck.fusion_blocks[0].I2P_block)
    _, tvox, timg = _port_inputs(tm, batch)
    marks = []
    with torch.no_grad():
        tout = tmodel(tvox, img_data=timg, mark=marks.append)
    for s in ("image backbone + FPN", "SECOND + neck", "I2P",
              "FocalEncoder", "decoder"):
        assert s in marks, s
    assert not any(m.startswith("LSS") for m in marks)
    assert float(np.abs(np.asarray(ji2p_out)).max()) > 0
    _close(i2p["out"], ji2p_out, EVAL_TOL, "I2P")
    pfc, stages = neck["out"]
    _close(pfc, jneck[0], EVAL_TOL, "pts_feat_conv")
    assert len(stages) == len(jneck[1]) == 3
    for i, (g, r) in enumerate(zip(stages, jneck[1])):
        _close(g, r, EVAL_TOL, f"stage feature {i}")
    _check_outputs(tout, out)
    assert torch.isfinite(tmodel.get_bboxes(tout, 8)["bboxes"]).all()


def _proj_train_cfg():
    jm, _ = tiny(use_grid_mask=True, **PROJ, **FREEZE)
    jm = dataclasses.replace(jm, freeze_camlss=False,
                             decoder=dataclasses.replace(jm.decoder,
                                                         roi_dropout=0.0))
    return jm, _to_port(jm)


def test_port_lc_proj_step_keeps_the_frozen_branches():
    """Engine ``cuda`` on CPU tensors: the image and point branches keep
    every bit; shared_conv_img, I2P, the fusion layers and the head move."""
    jm, tm = _proj_train_cfg()
    sd = jref_keys.make_fake_state_dict(jm, seed=2)
    model, before, metrics, seen = _port_step(tm, sd, _batch(1, 2), "cuda")
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert [k1.launch_count(k) for k in ("forward", "dx", "wgrad")] == \
        [0, 0, 0]  # CPU tensors
    assert seen["img_neck"] == (False, False)
    assert seen["pts_neck"] == (False, False)
    after = _check_frozen(model, before)
    for prefix in TRAINED:
        keys = [k for k in after if k.startswith(prefix)]
        assert keys and all(not torch.equal(after[k], before[k])
                            for k in keys), prefix


@pytest.mark.slow
def test_tiny_lc_proj_frozen_train_step_matches_jax(request):
    jm, tm = _proj_train_cfg()
    frozen_step_vs_jax(
        request, jm, tm,
        jax_patches=[(jfe, "I2P", functools.partial(ji2p.I2P,
                                                    dropout=0.0))],
        moved=TRAINED)

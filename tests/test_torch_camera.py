"""Parity: the camera modules of the port against the JAX package, on the CPU.

The same float32 inputs (numpy, from a seed) go through each JAX module and
its counterpart in the port; JAX's initialised variables, with their
batch-norm statistics and scales redrawn from a seed so that the norms do
something, reach the port through the weight bridge
(``utils/convert.from_flax`` on the module's reference keys). Floats are
held within 1e-5 of the JAX result's scale (``TOL``; float32 sums in
another order), integers exactly:

- ``segment_sum`` / ``segment_mean`` / ``segment_max`` / ``bev_pool``,
  with segment ids out of range on both sides (dropped, as in XLA);
- ResNet-18 and ResNet-50 (the shapes of ``tests/test_camera.py`` and the
  values), and FPN at a size that halves evenly (64 x 96) and one that
  does not (60 x 90, where ``F.interpolate``'s nearest rule would pick
  other rows than ``jax.image.resize``'s);
- ``create_frustum`` exactly; ``frustum_geometry`` with and without
  ``img_aug`` / ``bev_aug``; ``CamEncode``;
- ``splat_to_bev`` on the frustum of a synthetic camera rig: the voxel
  ranks exactly, after asserting that no in-grid point lies within
  ``BOUNDARY`` of a cell boundary (there, one ulp of difference between
  the two packages' geometry may flip a point into the next cell); the
  pooled BEV to ``TOL``;
- ``BevEncode`` in eval and in training (the running statistics too) and
  ``LiftSplatShoot``;
- ``local_attention`` and ``LocalContextBlock``, ``BasicBlock2d``.

The grid mask cannot draw JAX's numbers; it is held to the properties
``tests/test_camera.py`` checks (something kept and something masked, a
separable grid, ``prob=0`` the identity) and to its draws staying on the
generator's device.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from focalformer3d_tpu.data import synthetic
from focalformer3d_tpu.models import layers as jlayers
from focalformer3d_tpu.models import lss as jlss
from focalformer3d_tpu.models import resnet as jresnet
from focalformer3d_tpu.models.focal_encoder import \
    LocalContextBlock as JLocalContextBlock
from focalformer3d_tpu.ops import local_attn as jattn
from focalformer3d_tpu.ops import scatter as jscatter
from focalformer3d_tpu_torch import configs as tconfigs
from focalformer3d_tpu_torch.models import grid_mask as tgm
from focalformer3d_tpu_torch.models import layers as tlayers
from focalformer3d_tpu_torch.models import lss as tlss
from focalformer3d_tpu_torch.models import resnet as tresnet
from focalformer3d_tpu_torch.models.focal_encoder import \
    LocalContextBlock as TLocalContextBlock
from focalformer3d_tpu_torch.ops import local_attn as tattn
from focalformer3d_tpu_torch.ops import scatter as tscatter
from focalformer3d_tpu_torch.utils.convert import from_flax

torch.set_num_threads(2)
TOL = 1e-5
BOUNDARY = 1e-5  # in cell units
PC_RANGE = (-8.0, -8.0, -3.0, 8.0, 8.0, 3.0)
IMG_HW = (64, 96)
TINY_LSS = dict(img_scale=IMG_HW, camera_depth_range=(1.0, 9.0, 1.0),
                pc_range=PC_RANGE, downsample=4, grid=2.0, input_channels=32,
                cam_channels=8, out_channels=16)
JLSS = jlss.LSSConfig(**TINY_LSS)
TLSS = tconfigs.LSSConfig(**TINY_LSS)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, ref, tol=TOL, msg=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (msg, got.shape, ref.shape)
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-6)
    assert err <= tol, f"{msg}: rel err {err:.3g} > {tol}"


def _randomized(variables, seed):
    """JAX's initialised variables with every batch-norm statistic, scale
    and bias, and every conv bias, redrawn (the init leaves them trivial)."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = getattr(path[-1], "key", "")
        a = np.asarray(leaf)
        if name == "var":
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return rng.normal(0, 0.1, a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(draw, variables)


def _nest(tree, prefix):
    for p in reversed(prefix):
        tree = {p: tree}
    return tree


def _load(module, variables, ref_prefix, flax_prefix):
    """Load JAX variables of one module into its port counterpart through
    the weight bridge: the module's keys under ``ref_prefix`` map to flax
    paths under ``flax_prefix``."""
    own = module.state_dict()
    shapes = {f"{ref_prefix}.{k}": tuple(v.shape) for k, v in own.items()}
    nested = {c: _nest(jax.tree_util.tree_map(np.asarray, v), flax_prefix)
              for c, v in variables.items()}
    sd = from_flax(nested, shapes)
    module.load_state_dict({k[len(ref_prefix) + 1:]: v
                            for k, v in sd.items()}, strict=True)
    return module


# ---------------------------------------------------------------------------
# segment reductions
# ---------------------------------------------------------------------------

def _segments(seed=0, n=500, c=6, num=40):
    rng = np.random.RandomState(seed)
    data = rng.normal(0, 1, (n, c)).astype(np.float32)
    ids = rng.randint(-3, num + 5, n).astype(np.int32)  # some out of range
    ids[:num // 2] = np.arange(num // 2)  # the first half of cells hit
    return data, ids, num


def test_segment_sum_and_bev_pool_match_jax():
    data, ids, num = _segments()
    ref = jscatter.segment_sum(jnp.asarray(data), jnp.asarray(ids), num)
    _close(tscatter.segment_sum(_t(data), _t(ids), num), ref)
    _close(tscatter.bev_pool(_t(data), _t(ids), num),
           jscatter.bev_pool(jnp.asarray(data), jnp.asarray(ids), num))
    # out-of-range rows dropped: the total is that of the in-range rows
    inr = (ids >= 0) & (ids < num)
    np.testing.assert_allclose(
        tscatter.segment_sum(_t(data), _t(ids), num).sum(0).numpy(),
        data[inr].sum(0), rtol=1e-4, atol=1e-4)


def test_segment_mean_and_max_match_jax():
    data, ids, num = _segments(1, n=300, num=600)  # empty cells too
    mean, count = tscatter.segment_mean(_t(data), _t(ids), num)
    jmean, jcount = jscatter.segment_mean(jnp.asarray(data), jnp.asarray(ids),
                                          num)
    _close(mean, jmean)
    np.testing.assert_array_equal(count.numpy(), np.asarray(jcount))
    got = tscatter.segment_max(_t(data), _t(ids), num).numpy()
    ref = np.asarray(jscatter.segment_max(jnp.asarray(data),
                                          jnp.asarray(ids), num))
    np.testing.assert_array_equal(got, ref)  # -inf in the empty cells too
    assert np.isneginf(got).any()


# ---------------------------------------------------------------------------
# ResNet + FPN
# ---------------------------------------------------------------------------

def _resnet_pair(depth, x):
    jm = jresnet.ResNet(depth=depth)
    v = _randomized(jax.jit(jm.init)(jax.random.PRNGKey(depth),
                                     jnp.asarray(x)), 1)
    tm = _load(tresnet.ResNet(depth).eval(), v, "img_backbone",
               ("img_backbone",))
    return jm, v, tm


@pytest.mark.parametrize("depth,hw,channels", [
    (18, (64, 96), [64, 128, 256, 512]),
    (50, (32, 48), [256, 512, 1024, 2048])])
def test_resnet_matches_jax(depth, hw, channels):
    x = np.random.RandomState(2).uniform(0, 1, (2,) + hw + (3,)) \
        .astype(np.float32)
    jm, v, tm = _resnet_pair(depth, x)
    ref = jax.jit(jm.apply)(v, jnp.asarray(x))
    with torch.no_grad():
        got = tm(_t(x))
    H, W = hw
    assert [tuple(o.shape) for o in got] == [
        (2, -(-H // s), -(-W // s), c)
        for s, c in zip((4, 8, 16, 32), channels)]
    for i, (g, r) in enumerate(zip(got, ref)):
        _close(g, r, msg=f"R{depth} stage {i}")


def test_resnet_norm_eval_keeps_batch_norm_in_inference():
    tm = tresnet.ResNet(18).train()
    assert tm.training
    assert not any(m.training for m in tm.modules()
                   if isinstance(m, torch.nn.BatchNorm2d))


@pytest.mark.parametrize("hw", [(64, 96), (60, 90)])
def test_fpn_matches_jax(hw):
    x = np.random.RandomState(3).uniform(0, 1, (1,) + hw + (3,)) \
        .astype(np.float32)
    jm, v, tm = _resnet_pair(18, x)
    feats = jm.apply(v, jnp.asarray(x))
    jf = jresnet.FPN(32, 5)
    fv = _randomized(jf.init(jax.random.PRNGKey(4), feats), 5)
    tf = _load(tresnet.FPN(tm.out_channels, 32, 5), fv, "img_neck",
               ("img_neck",))
    ref = jf.apply(fv, feats)
    tfeats = tuple(_t(f) for f in feats)
    with torch.no_grad():
        got = tf(tfeats)
        lvl0 = tf(tfeats, num_levels=1)
    assert len(got) == 5 and len(lvl0) == 1
    torch.testing.assert_close(lvl0[0], got[0], rtol=0, atol=0)
    for i, (g, r) in enumerate(zip(got, ref)):
        _close(g, r, msg=f"FPN level {i}")
    small, big = tfeats[1], tfeats[0]
    up = tresnet.resize_nearest(small, big.shape[1:3])
    interp = F.interpolate(small.permute(0, 3, 1, 2), size=big.shape[1:3],
                           mode="nearest").permute(0, 2, 3, 1)
    exact = all(b == 2 * s for b, s in zip(big.shape[1:3], small.shape[1:3]))
    assert torch.equal(up, interp) == exact


# ---------------------------------------------------------------------------
# LSS
# ---------------------------------------------------------------------------

def test_create_frustum_equals_jax():
    np.testing.assert_array_equal(tlss.create_frustum(TLSS),
                                  jlss.create_frustum(JLSS))


def _rig(seed, n_cams=3, lss=TINY_LSS):
    """cam2lidar (rot, trans) of a synthetic camera rig, and random
    augmentations: a pixel-space scale + shift and a BEV rotation + shift."""
    rng = np.random.RandomState(seed)
    l2i = synthetic.make_cameras(rng, n_cams, lss["img_scale"])
    inv = np.linalg.inv(l2i.astype(np.float64)).astype(np.float32)
    img_aug = np.tile(np.eye(4, dtype=np.float32), (n_cams, 1, 1))
    img_aug[:, 0, 0] = img_aug[:, 1, 1] = rng.uniform(0.8, 1.2, n_cams)
    img_aug[:, :2, 3] = rng.uniform(-5, 5, (n_cams, 2))
    th = rng.uniform(-0.3, 0.3)
    bev_aug = np.eye(4, dtype=np.float32)
    bev_aug[:2, :2] = [[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]
    bev_aug[:3, 3] = rng.uniform(-1, 1, 3)
    return inv[:, :3, :3], inv[:, :3, 3], img_aug, bev_aug


@pytest.mark.parametrize("aug", ["none", "img_aug", "bev_aug", "both"])
def test_frustum_geometry_matches_jax(aug):
    rot, trans, ia, ba = _rig(0)
    ia = ia if aug in ("img_aug", "both") else None
    ba = ba if aug in ("bev_aug", "both") else None
    ref = jlss.frustum_geometry(
        JLSS, jnp.asarray(rot), jnp.asarray(trans),
        None if ia is None else jnp.asarray(ia),
        None if ba is None else jnp.asarray(ba))
    got = tlss.frustum_geometry(TLSS, _t(rot), _t(trans),
                                None if ia is None else _t(ia),
                                None if ba is None else _t(ba))
    _close(got, ref)


def test_cam_encode_matches_jax():
    x = np.random.RandomState(4).normal(0, 1, (2, 3, 16, 24, 32)) \
        .astype(np.float32)
    jm = jlss.CamEncode(JLSS.depth_bins, JLSS.cam_channels)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    lifted, depth = jm.apply(v, jnp.asarray(x))
    tm = _load(tlss.CamEncode(32, TLSS.depth_bins, TLSS.cam_channels), v,
               "imgpts_neck.cam_lss.camencode",
               ("imgpts_neck", "cam_lss", "camencode"))
    with torch.no_grad():
        tl, td = tm(_t(x).flatten(0, 1))
    _close(tl.unflatten(0, (2, 3)), lifted, msg="lifted")
    _close(td.unflatten(0, (2, 3)), depth, msg="depth")


def test_splat_ranks_exact_and_bev_matches_jax():
    rot, trans, ia, ba = _rig(1)
    jgeom = np.asarray(jlss.frustum_geometry(
        JLSS, jnp.asarray(rot), jnp.asarray(trans), jnp.asarray(ia),
        jnp.asarray(ba)))
    tgeom = tlss.frustum_geometry(TLSS, _t(rot), _t(trans), _t(ia), _t(ba))
    cell = (jgeom - np.asarray(PC_RANGE[:3], np.float32)) \
        / np.float32(JLSS.grid)
    nx, ny, nz = JLSS.nx
    idx = np.floor(cell).astype(np.int64)
    inside = ((idx >= 0) & (idx < [nx, ny, nz])).all(-1)
    assert inside.mean() > 0.2  # the test geometry fills the grid
    near = np.abs(cell - np.round(cell))[inside].min()
    assert near > BOUNDARY, f"a point lies {near:.3g} from a cell boundary"
    jrank = np.where(inside, (idx[..., 2] * nx + idx[..., 0]) * ny
                     + idx[..., 1], nx * ny * nz)
    np.testing.assert_array_equal(tlss.splat_ranks(TLSS, tgeom).numpy(),
                                  jrank)
    feats = np.random.RandomState(5).normal(
        0, 1, jgeom.shape[:-1] + (TLSS.cam_channels,)).astype(np.float32)
    ref = jlss.splat_to_bev(JLSS, jnp.asarray(jgeom), jnp.asarray(feats))
    got = tlss.splat_to_bev(TLSS, tgeom, _t(feats))
    assert tuple(got.shape) == (ny, nx, TLSS.cam_channels * nz)
    _close(got, ref)


@pytest.mark.parametrize("train", [False, True])
def test_bev_encode_matches_jax(train):
    nx, ny, nz = TLSS.nx
    x = np.random.RandomState(6).normal(0, 1, (2, ny, nx, 8 * nz)) \
        .astype(np.float32)
    jm = jlss.BevEncode(16)
    v = _randomized(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)), 7)
    tm = _load(tlss.BevEncode(8 * nz, 16), v,
               "imgpts_neck.cam_lss.bevencode",
               ("imgpts_neck", "cam_lss", "bevencode"))
    tm.train(train)
    if train:
        ref, mut = jm.apply(v, jnp.asarray(x), True, mutable=["batch_stats"])
        new = {"params": v["params"], "batch_stats": mut["batch_stats"]}
    else:
        ref = jm.apply(v, jnp.asarray(x))
    with torch.no_grad():
        got = tm(_t(x))
    _close(got, ref)
    if train:
        want = _load(tlss.BevEncode(8 * nz, 16), new,
                     "imgpts_neck.cam_lss.bevencode",
                     ("imgpts_neck", "cam_lss", "bevencode")).state_dict()
        for k, r in want.items():
            if "running" in k:
                _close(tm.state_dict()[k], r.numpy(), msg=k)


def test_lift_splat_shoot_matches_jax():
    rng = np.random.RandomState(8)
    B, N = 2, 3
    fH, fW = TLSS.feat_hw
    x = rng.normal(0, 1, (B, N, fH, fW, 32)).astype(np.float32)
    rigs = [_rig(9 + b, N) for b in range(B)]
    rot, trans, ia, ba = (np.stack([r[i] for r in rigs]) for i in range(4))
    jm = jlss.LiftSplatShoot(JLSS)
    args = tuple(jnp.asarray(a) for a in (x, rot, trans, ia, ba))
    v = _randomized(jm.init(jax.random.PRNGKey(2), *args), 10)
    bev, depth = jm.apply(v, *args)
    tm = _load(tlss.LiftSplatShoot(TLSS).eval(), v, "imgpts_neck.cam_lss",
               ("imgpts_neck", "cam_lss"))
    marks = []
    with torch.no_grad():
        tbev, tdepth = tm(*(_t(a) for a in (x, rot, trans, ia, ba)),
                          mark=marks.append)
    assert marks == ["LSS lift", "LSS splat", "BevEncode"]
    _close(tbev, bev, msg="bev")
    _close(tdepth, depth, msg="depth")


# ---------------------------------------------------------------------------
# local attention, the bevfusion neck's blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [3, 9])
def test_local_attention_matches_jax(k):
    rng = np.random.RandomState(11)
    q, key, val = (rng.normal(0, 1, (2, 10, 12, 8)).astype(np.float32)
                   for _ in range(3))
    ref = jax.jit(jax.vmap(lambda a, b, c: jattn.local_attention(
        a, b, c, k)))(jnp.asarray(q), jnp.asarray(key), jnp.asarray(val))
    got = tattn.local_attention(_t(q), _t(key), _t(val), k)
    _close(got, ref)


def test_local_context_block_matches_jax():
    x = np.random.RandomState(12).normal(0, 1, (2, 9, 11, 16)) \
        .astype(np.float32)
    jm = JLocalContextBlock(16, 9)
    v = _randomized(jax.jit(jm.init)(jax.random.PRNGKey(3), jnp.asarray(x),
                                     jnp.asarray(x)), 13)
    ref = jax.jit(jm.apply)(v, jnp.asarray(x), jnp.asarray(x))
    tm = _load(TLocalContextBlock(16, 9).eval(), v,
               "imgpts_neck.fusion_blocks.0.P_IML",
               ("imgpts_neck", "fusion0", "P_IML"))
    with torch.no_grad():
        got = tm(_t(x), _t(x))
    _close(got, ref)


def test_basic_block_2d_matches_jax():
    x = np.random.RandomState(14).normal(0, 1, (2, 8, 8, 16)) \
        .astype(np.float32)
    jm = jlayers.BasicBlock2d(16)
    v = _randomized(jm.init(jax.random.PRNGKey(4), jnp.asarray(x)), 15)
    ref = jm.apply(v, jnp.asarray(x))
    tm = _load(tlayers.BasicBlock2d(16).eval(), v,
               "imgpts_neck.fusion_blocks.0.iterimg_conv.0",
               ("imgpts_neck", "fusion0", "iterimg"))
    with torch.no_grad():
        got = tm(_t(x))
    _close(got, ref)


# ---------------------------------------------------------------------------
# grid mask (no JAX counterpart for the draws)
# ---------------------------------------------------------------------------

def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def test_grid_mask_keeps_strips_and_prob():
    imgs = torch.ones(2, 32, 40, 3)
    kept = tgm.grid_mask(_gen(0), imgs, prob=1.0).mean().item()
    assert 0.0 < kept < 1.0  # something masked, something kept
    assert torch.equal(tgm.grid_mask(_gen(0), imgs, prob=0.0), imgs)


@pytest.mark.parametrize("seed", range(4))
def test_grid_mask_is_a_separable_grid(seed):
    out = tgm.grid_mask(_gen(seed), torch.ones(1, 64, 64, 1), prob=1.0)
    m = out[0, :, :, 0].numpy()
    # mode 1 keeps the union of row strips and column strips
    recon = np.maximum(m.min(axis=1)[:, None], m.min(axis=0)[None, :])
    np.testing.assert_array_equal(m, recon)
    assert 0.0 < m.mean() < 1.0


def test_grid_mask_one_mask_for_every_image_and_channel():
    imgs = torch.rand(2, 3, 24, 30, 3, generator=_gen(1)) + 0.5
    out = tgm.grid_mask(_gen(2), imgs, prob=1.0)
    mask = out / imgs
    assert torch.equal(mask, mask[:1, :1, :, :, :1].expand_as(mask))

"""Parity: the training-side core of the PyTorch port against the JAX package.

Small random inputs made with numpy go through each JAX function and its
port. Integer results (assignments) must be equal; floats agree within 1e-5
of the reference's scale (float32 in both, sums in another order):

- ``core/box_coder.encode``; ``core/losses`` (every function);
  ``core/gaussian.heatmap_targets``; ``core/iou.boxes_iou_3d``;
- ``core/hungarian``: the batched auction against JAX's per-problem
  ``while_loop`` (also with an iteration cap that stops some problems
  early), and the scipy method;
- ``core/assigner.hungarian_assign_3d`` (both methods) and
  ``apply_gt_center_limit``;
- ``training/optim``: the cyclic schedules and five clipped AdamW steps
  with cyclic LR and beta1 against optax;
- batch norm in training: ``MaskedBatchNorm`` and ``ConvBN``'s flax
  ``BatchNorm`` (output and running statistics after one forward).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focalformer3d_tpu.configs import get_config as jax_get_config
from focalformer3d_tpu.core import assigner as jassigner
from focalformer3d_tpu.core import box_coder as jbc
from focalformer3d_tpu.core import gaussian as jgaussian
from focalformer3d_tpu.core import hungarian as jhungarian
from focalformer3d_tpu.core import iou as jiou
from focalformer3d_tpu.core import losses as jlosses
from focalformer3d_tpu.models import layers as jlayers
from focalformer3d_tpu.training import optim as joptim
from focalformer3d_tpu_torch import configs as tconfigs
from focalformer3d_tpu_torch.core import assigner as tassigner
from focalformer3d_tpu_torch.core import box_coder as tbc
from focalformer3d_tpu_torch.core import gaussian as tgaussian
from focalformer3d_tpu_torch.core import hungarian as thungarian
from focalformer3d_tpu_torch.core import iou as tiou
from focalformer3d_tpu_torch.core import losses as tlosses
from focalformer3d_tpu_torch.models import layers as tlayers
from focalformer3d_tpu_torch.training import optim as toptim

TOL = 1e-5
PC_RANGE = (-54.0, -54.0, -5.0, 54.0, 54.0, 3.0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, tol=TOL):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1e-12)
    err = np.abs(got - ref).max() / scale
    assert err <= tol, f"rel err {err:.3g} > {tol}"


def _boxes(rng, n, spread=20.0, dims=9):
    """World boxes (n, dims): xyz (z bottom), lwh, yaw[, vx, vy]."""
    b = np.concatenate([
        rng.uniform(-spread, spread, (n, 2)), rng.uniform(-2, 0, (n, 1)),
        rng.uniform(0.5, 5.0, (n, 3)), rng.uniform(-np.pi, np.pi, (n, 1)),
        rng.uniform(-3, 3, (n, 2))], -1).astype(np.float32)
    return b[:, :dims]


# ---------------------------------------------------------------- box coder
@pytest.mark.parametrize("dims", [7, 9])
def test_box_encode(dims):
    jcoder = jax_get_config("FocalFormer3D_L")["model"].decoder.coder
    tcoder = tconfigs.get_config("FocalFormer3D_L")["model"].decoder.coder
    b = _boxes(np.random.RandomState(0), 2 * 6, dims=dims).reshape(2, 6, -1)
    ref = jbc.encode(jcoder, jnp.asarray(b))
    got = tbc.encode(tcoder, _t(b))
    assert got.shape == (2, 6, 10)
    _close(got.numpy(), ref)


# ------------------------------------------------------------------- losses
def test_clip_sigmoid_and_focal_losses():
    rng = np.random.RandomState(1)
    N, C = 40, 6
    logits = rng.randn(N, C).astype(np.float32) * 3
    labels = rng.randint(0, C + 1, N).astype(np.int32)  # C = background
    weights = rng.uniform(0, 1, N).astype(np.float32)
    _close(tlosses.clip_sigmoid(_t(logits)).numpy(),
           jlosses.clip_sigmoid(jnp.asarray(logits)))
    for w in (None, weights):
        kw = dict(avg_factor=7.0, loss_weight=0.5)
        ref = jlosses.sigmoid_focal_loss(
            jnp.asarray(logits), jnp.asarray(labels),
            None if w is None else jnp.asarray(w), **kw)
        got = tlosses.sigmoid_focal_loss(
            _t(logits), _t(labels), None if w is None else _t(w), **kw)
        _close(got.numpy(), ref)


def test_gaussian_focal_and_l1_losses():
    rng = np.random.RandomState(2)
    pred = rng.uniform(1e-4, 1 - 1e-4, (2, 3, 8, 8, 4)).astype(np.float32)
    tgt = rng.uniform(0, 1, pred.shape).astype(np.float32)
    tgt[tgt > 0.9] = 1.0  # some exact peaks
    mask = (rng.uniform(0, 1, pred.shape) > 0.2).astype(np.float32)
    ref = jlosses.gaussian_focal_loss(jnp.asarray(pred), jnp.asarray(tgt),
                                      jnp.asarray(mask), avg_factor=5.0)
    got = tlosses.gaussian_focal_loss(_t(pred), _t(tgt), _t(mask),
                                      avg_factor=5.0)
    _close(got.numpy(), ref)
    a, b = rng.randn(2, 5, 10).astype(np.float32), rng.randn(2, 5, 10)
    b = b.astype(np.float32)
    w = rng.uniform(0, 1, (2, 5, 10)).astype(np.float32)
    ref = jlosses.l1_loss(jnp.asarray(a), jnp.asarray(b), jnp.asarray(w),
                          avg_factor=3.0, loss_weight=0.25)
    got = tlosses.l1_loss(_t(a), _t(b), _t(w), avg_factor=3.0,
                          loss_weight=0.25)
    _close(got.numpy(), ref)


def test_match_costs():
    rng = np.random.RandomState(3)
    Q, G, C = 12, 5, 4
    logits = rng.randn(Q, C).astype(np.float32) * 2
    gl = rng.randint(0, C, G).astype(np.int32)
    bx, gb = _boxes(rng, Q), _boxes(rng, G)
    ref = jlosses.focal_loss_cost(jnp.asarray(logits), jnp.asarray(gl),
                                  weight=0.15)
    got = tlosses.focal_loss_cost(_t(logits), _t(gl), weight=0.15)
    _close(got.numpy(), ref)
    ref = jlosses.bbox_bev_l1_cost(jnp.asarray(bx), jnp.asarray(gb),
                                   PC_RANGE, 0.25)
    got = tlosses.bbox_bev_l1_cost(_t(bx), _t(gb), PC_RANGE, 0.25)
    _close(got.numpy(), ref)


# --------------------------------------------------------- heatmap targets
def test_heatmap_targets():
    rng = np.random.RandomState(4)
    G, ncls, H, W = 10, 5, 60, 60
    gb = _boxes(rng, G, spread=50.0)
    gl = rng.randint(0, ncls, G).astype(np.int32)
    gv = np.arange(G) < 8
    args = (ncls, PC_RANGE, (0.075, 0.075), 8 * 2, (H, W), 0.1, 2)
    ref = jgaussian.heatmap_targets(jnp.asarray(gb), jnp.asarray(gl),
                                    jnp.asarray(gv), ncls,
                                    jnp.asarray(PC_RANGE),
                                    jnp.asarray((0.075, 0.075)), *args[3:])
    got = tgaussian.heatmap_targets(_t(gb), _t(gl), _t(gv), ncls,
                                    torch.tensor(PC_RANGE),
                                    torch.tensor((0.075, 0.075)), *args[3:])
    assert got.shape == (ncls, H, W)
    _close(got.numpy(), ref)
    assert float(got.max()) == 1.0


# --------------------------------------------------------------------- IoU
def test_boxes_iou_3d():
    rng = np.random.RandomState(5)
    a = _boxes(rng, 16, spread=3.0, dims=7)
    b = np.concatenate([a[:8] + rng.uniform(-0.5, 0.5, (8, 7)).astype(
        np.float32) * np.array([1, 1, 0.3, 0.2, 0.2, 0.2, 1], np.float32),
        _boxes(rng, 4, spread=3.0, dims=7)])
    b[:, 3:6] = np.abs(b[:, 3:6]) + 0.1
    ref = np.asarray(jiou.boxes_iou_3d(jnp.asarray(a), jnp.asarray(b)))
    got = tiou.boxes_iou_3d(_t(a), _t(b)).numpy()
    assert (ref > 0.05).sum() >= 8  # overlapping pairs are covered
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    batched = tiou.boxes_iou_3d(_t(np.stack([a, a])), _t(np.stack([b, b])))
    np.testing.assert_allclose(batched[1].numpy(), ref, rtol=0, atol=TOL)


# ---------------------------------------------------------------- auction
def _problems(seed, n=6, Q=12, G=10):
    """Contested problems: every GT column prefers the same few queries
    (a shared per-query cost plus small noise), so bidding takes several
    rounds and the problems converge after different iteration counts."""
    rng = np.random.RandomState(seed)
    cost = (rng.uniform(0, 1, (n, Q, 1))
            + 0.01 * rng.uniform(0, 2, (n, Q, G))).astype(np.float32)
    row_valid = np.ones((n, Q), bool)
    col_valid = rng.uniform(0, 1, (n, G)) > 0.25
    col_valid[0] = False  # a problem with no GT
    col_valid[1] = True
    return cost, row_valid, col_valid


@pytest.mark.parametrize("max_iters", [8192, 5])
def test_batched_auction_matches_per_problem_jax(max_iters):
    """Each problem of the batch gets JAX's per-problem result, also when
    the cap stops some problems before they converge."""
    cost, rv, cv = _problems(6)
    ref = jax.vmap(lambda c, r, v: jhungarian.auction_assign(
        c, r, v, max_iters=max_iters))(jnp.asarray(cost), jnp.asarray(rv),
                                       jnp.asarray(cv))
    got, iters = thungarian.auction_assign(_t(cost), _t(rv), _t(cv),
                                           max_iters=max_iters)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.dtype == torch.int32
    matched = (got >= 0).sum(-1).numpy()
    if max_iters == 5:
        assert iters == 5
        assert (matched < cv.sum(-1)).any()  # some problems were capped
    else:
        assert 5 < iters < max_iters
        np.testing.assert_array_equal(matched, cv.sum(-1))


def test_scipy_assign_matches_jax():
    cost, rv, cv = _problems(7)
    ref = jax.vmap(jhungarian.scipy_assign)(jnp.asarray(cost),
                                            jnp.asarray(rv), jnp.asarray(cv))
    got = thungarian.scipy_assign(_t(cost), _t(rv), _t(cv))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ----------------------------------------------------------------- assigner
@pytest.mark.parametrize("method", ["auction", "scipy"])
def test_hungarian_assign_3d(method):
    rng = np.random.RandomState(8)
    B, R, Q, G, C = 2, 2, 16, 6, 4
    gb = _boxes(rng, B * G, spread=15.0).reshape(B, G, 9)
    gl = rng.randint(0, C, (B, G)).astype(np.int32)
    gv = np.arange(G)[None].repeat(B, 0) < np.array([[5], [3]])
    bx = np.repeat(gb[:, None], R, 1)[:, :, rng.randint(0, G, Q)]
    bx = (bx + rng.normal(0, 0.7, bx.shape)).astype(np.float32)
    bx[..., 3:6] = np.abs(bx[..., 3:6]) + 0.2
    logits = rng.randn(B, R, Q, C).astype(np.float32)
    jcfg = jassigner.AssignerConfig(method=method)
    tcfg = tassigner.AssignerConfig(method=method)

    def one(b, lg, g, l, v):
        res = jassigner.hungarian_assign_3d(jcfg, b, lg, g, l, v, PC_RANGE)
        a = jassigner.apply_gt_center_limit(res["assigned_gt"], b, g, 3.0)
        return res, a

    per_r = jax.vmap(one, in_axes=(0, 0, None, None, None))
    ref, ref_lim = jax.vmap(per_r)(jnp.asarray(bx), jnp.asarray(logits),
                                   jnp.asarray(gb), jnp.asarray(gl),
                                   jnp.asarray(gv))
    tgb = _t(np.repeat(gb[:, None], R, 1))
    got = tassigner.hungarian_assign_3d(
        tcfg, _t(bx), _t(logits), tgb, _t(np.repeat(gl[:, None], R, 1)),
        _t(np.repeat(gv[:, None], R, 1)), PC_RANGE)
    np.testing.assert_array_equal(got["assigned_gt"].numpy(),
                                  np.asarray(ref["assigned_gt"]))
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  np.asarray(ref["labels"]))
    np.testing.assert_allclose(got["max_overlaps"].numpy(),
                               np.asarray(ref["max_overlaps"]), rtol=0,
                               atol=TOL)
    assert (got["assigned_gt"] >= 0).sum() == int(gv.sum()) * R
    lim = tassigner.apply_gt_center_limit(got["assigned_gt"], _t(bx), tgb,
                                          3.0)
    np.testing.assert_array_equal(lim.numpy(), np.asarray(ref_lim))
    assert (lim >= 0).sum() < (got["assigned_gt"] >= 0).sum()


# ---------------------------------------------------------------- optimizer
def test_cyclic_schedules():
    for base, ratio in ((1e-4, (10.0, 1e-4)),
                        (0.9, (0.8947368421052632, 1.0))):
        js = joptim.cyclic_schedule(base, 20, ratio, 0.4)
        ts = toptim.cyclic_schedule(base, 20, ratio, 0.4)
        got = np.array([ts(i) for i in range(24)])
        ref = np.array([float(js(jnp.int32(i))) for i in range(24)])
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


def test_optimizer_matches_optax():
    """Five steps of clip + AdamW with cyclic LR and beta1 (8 total steps,
    so both schedules move every step); steps 0-2 are clipped, steps 3-4
    have a global norm below 0.1 and are not."""
    rng = np.random.RandomState(9)
    shapes = [(4, 3), (7,), (2, 2, 5)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    jtx = joptim.make_optimizer(total_steps=8)
    ttx = toptim.make_optimizer(total_steps=8)
    jp = [jnp.asarray(p) for p in params]
    jstate = jtx.init(jp)
    tp = [_t(p.copy()) for p in params]
    tstate = ttx.init(tp)
    for step in range(5):
        scale = 1.0 if step < 3 else 1e-3
        grads = [rng.randn(*s).astype(np.float32) * scale for s in shapes]
        upd, jstate = jtx.update([jnp.asarray(g) for g in grads], jstate, jp)
        jp = [p + u for p, u in zip(jp, upd)]
        norm = ttx.update([_t(g) for g in grads], tstate, tp)
        ref_norm = np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                               for g in grads))
        assert abs(float(norm) - ref_norm) <= 1e-5 * ref_norm
        assert (ref_norm > 0.1) == (step < 3)
        for got, ref in zip(tp, jp):
            _close(got.numpy(), ref)
    assert tstate.count == 5


# --------------------------------------------------------------- batch norm
def test_masked_batch_norm_train():
    rng = np.random.RandomState(10)
    x = rng.randn(2, 50, 8).astype(np.float32) * 2 + 1
    mask = rng.uniform(0, 1, (2, 50)) > 0.3
    scale = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bias = rng.randn(8).astype(np.float32)
    mean0 = rng.randn(8).astype(np.float32)
    var0 = rng.uniform(0.5, 2, 8).astype(np.float32)
    jm = jlayers.MaskedBatchNorm()
    variables = {"params": {"scale": jnp.asarray(scale),
                            "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean0),
                                 "var": jnp.asarray(var0)}}
    ref, mut = jm.apply(variables, jnp.asarray(x), jnp.asarray(mask),
                        train=True, mutable=["batch_stats"])
    bn = torch.nn.BatchNorm1d(8, eps=1e-3, momentum=0.01)
    with torch.no_grad():
        bn.weight.copy_(_t(scale))
        bn.bias.copy_(_t(bias))
        bn.running_mean.copy_(_t(mean0))
        bn.running_var.copy_(_t(var0))
    bn.train()
    got = tlayers.apply_bn(_t(x), bn, _t(mask))
    _close(got.detach().numpy(), ref)
    _close(bn.running_mean.numpy(), mut["batch_stats"]["mean"])
    _close(bn.running_var.numpy(), mut["batch_stats"]["var"])


def test_conv_bn_train_biased_running_var():
    """``ConvBN`` in training against flax's ``BatchNorm`` (decay 0.9,
    eps 1e-5): the output and the running statistics, whose variance is
    the biased batch variance (torch's own BatchNorm would store the
    unbiased one)."""
    rng = np.random.RandomState(11)
    x = rng.randn(2, 6, 6, 4).astype(np.float32)
    jm = jlayers.ConvBN(features=5, kernel_size=3)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    kernel = rng.randn(3, 3, 4, 5).astype(np.float32) * 0.3
    variables = {
        "params": {"Conv_0": {"kernel": jnp.asarray(kernel)},
                   "BatchNorm_0": {
                       "scale": jnp.asarray(rng.uniform(0.5, 1.5, 5),
                                            jnp.float32),
                       "bias": jnp.asarray(rng.randn(5), jnp.float32)}},
        "batch_stats": {"BatchNorm_0": {
            "mean": jnp.asarray(rng.randn(5), jnp.float32),
            "var": jnp.asarray(rng.uniform(0.5, 2, 5), jnp.float32)}}}
    ref, mut = jm.apply(variables, jnp.asarray(x), train=True,
                        mutable=["batch_stats"])
    tm = tlayers.ConvBN(4, 5, 3)
    p, s = variables["params"], variables["batch_stats"]["BatchNorm_0"]
    with torch.no_grad():
        tm.conv.weight.copy_(_t(kernel).permute(3, 2, 0, 1))
        tm.bn.weight.copy_(_t(p["BatchNorm_0"]["scale"]))
        tm.bn.bias.copy_(_t(p["BatchNorm_0"]["bias"]))
        tm.bn.running_mean.copy_(_t(s["mean"]))
        tm.bn.running_var.copy_(_t(s["var"]))
    tm.train()
    got = tm(_t(x))
    _close(got.detach().numpy(), ref)
    new = mut["batch_stats"]["BatchNorm_0"]
    _close(tm.bn.running_mean.numpy(), new["mean"])
    _close(tm.bn.running_var.numpy(), new["var"])

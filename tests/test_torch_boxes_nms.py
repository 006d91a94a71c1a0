"""Parity: the port's box utilities, BEV IoU and NMS against the JAX package.

The same numpy boxes through ``focalformer3d_tpu.core`` (``boxes``, ``iou``,
``nms``) and their counterparts in ``focalformer3d_tpu_torch.core``:

- box geometry (centres, corners, rotations, containment, flips, scaling):
  1e-6 of the values' scale, containment masks exactly;
- ``boxes_iou_bev``: within 1e-6 on the cases of ``tests/test_core.py``
  and the degenerate ones (identical boxes, shared edges, zero-area
  boxes); within 1e-5 on random boxes with centres up to 25 m out. There a
  corner's float32 ulp is 2e-6 m, and the two packages' corners differ by
  that much (their sine, cosine and fused multiply-adds differ; JAX's own
  jitted and eager corners differ as well), which moves an IoU by up to
  ~3e-6;
- ``circle_nms`` and ``rotated_nms_bev``: keep masks exactly, ties broken
  as JAX breaks them (among equal scores the higher index first). Two
  correct implementations may decide differently where a pair's IoU (or
  squared distance) lies within float rounding of the threshold, so each
  random case first asserts, from the JAX matrix, that no valid pair lies
  within 1e-5 of it; a seed that has such a pair fails here (seeds 0 and 3
  have one at IoU 0.1, so the rotated cases run on seeds 1, 2, 4 and 5).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focalformer3d_tpu.core import boxes as jboxes
from focalformer3d_tpu.core import iou as jiou
from focalformer3d_tpu.core import nms as jnms
from focalformer3d_tpu_torch.core import boxes as tboxes
from focalformer3d_tpu_torch.core import iou as tiou
from focalformer3d_tpu_torch.core import nms as tnms

IOU_TOL = 1e-5  # random boxes (see the module docstring)
MARGIN = 1e-5


def rand_boxes(rng, n, code_size=9, spread=20.0):
    out = np.zeros((n, code_size), np.float32)
    out[:, 0:2] = rng.uniform(-spread, spread, (n, 2))
    out[:, 2] = rng.uniform(-3, 1, n)
    out[:, 3:6] = rng.uniform(0.5, 6.0, (n, 3))
    out[:, 6] = rng.uniform(-np.pi, np.pi, n)
    if code_size > 7:
        out[:, 7:9] = rng.uniform(-5, 5, (n, 2))
    return out


def clustered_boxes(rng, n, centres=12):
    """Boxes jittered around a few centres, so that NMS suppresses."""
    base = rand_boxes(rng, centres)
    b = base[rng.randint(0, centres, n)].copy()
    b[:, 0:2] += rng.normal(0, 0.6, (n, 2))
    b[:, 3:6] *= rng.uniform(0.8, 1.25, (n, 3))
    b[:, 6] += rng.normal(0, 0.2, n)
    return b


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _close(got, ref, tol=1e-6):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1.0)
    assert np.abs(got - ref).max() <= tol * scale, np.abs(got - ref).max()


# ---------------------------------------------------------------------------
# boxes
# ---------------------------------------------------------------------------

def test_box_geometry_matches_jax():
    rng = np.random.RandomState(0)
    b = rand_boxes(rng, 40)
    pts = rng.uniform(-22, 22, (300, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(-3, 3, 300)
    for name in ("gravity_center", "bev_corners", "corners_3d"):
        _close(getattr(tboxes, name)(_t(b)), getattr(jboxes, name)(*_j(b)))
    ang = rng.uniform(-3, 3, 40).astype(np.float32)
    _close(tboxes.rotate_points_z(_t(b[:, None, :3]), _t(ang)),
           jboxes.rotate_points_z(*_j(b[:, None, :3], ang)))
    for axis in ("horizontal", "vertical"):
        _close(tboxes.flip_boxes(_t(b), axis), jboxes.flip_boxes(*_j(b), axis))
        _close(tboxes.flip_boxes(_t(b[:, :7]), axis),
               jboxes.flip_boxes(*_j(b[:, :7]), axis))
    _close(tboxes.scale_boxes(_t(b), 1.06), jboxes.scale_boxes(*_j(b), 1.06))
    _close(tboxes.rotate_boxes(_t(b), 0.7), jboxes.rotate_boxes(*_j(b), 0.7))
    _close(tboxes.rotate_boxes(_t(b[:, :7]), -0.3),
           jboxes.rotate_boxes(*_j(b[:, :7]), -0.3))
    for name in ("points_in_boxes_bev", "points_in_boxes_3d"):
        p = pts[:, :2] if name.endswith("bev") else pts
        got = getattr(tboxes, name)(_t(p), _t(b)).numpy()
        ref = np.asarray(getattr(jboxes, name)(*_j(p, b)))
        np.testing.assert_array_equal(got, ref)
    assert got.any()


def test_box_cases_of_the_jax_tests():
    """``tests/test_core.py::TestBoxes`` on the port."""
    b = torch.tensor([[1.0, 2.0, -1.0, 2.0, 2.0, 4.0, 0.0]])
    np.testing.assert_allclose(tboxes.gravity_center(b), [[1.0, 2.0, 1.0]])
    b = torch.tensor([[0.0, 0.0, 0.0, 4.0, 2.0, 1.0, 0.0]])
    got = {tuple(np.round(p, 5)) for p in tboxes.bev_corners(b)[0].numpy()}
    assert got == {(2.0, 1.0), (-2.0, 1.0), (-2.0, -1.0), (2.0, -1.0)}
    b = torch.tensor([[0.0, 0.0, 0.0, 4.0, 2.0, 1.0, np.pi / 2]])
    got = {tuple(np.round(p, 5) + 0.0)
           for p in tboxes.bev_corners(b)[0].numpy()}
    assert got == {(-1.0, 2.0), (-1.0, -2.0), (1.0, -2.0), (1.0, 2.0)}
    m = tboxes.points_in_boxes_bev(torch.tensor([[[0.5, 1.5], [1.5, 0.5]]]),
                                   b[None])
    assert m[0, 0, 0] and not m[0, 1, 0]
    b = _t(rand_boxes(np.random.RandomState(0), 10))
    b2 = tboxes.flip_boxes(tboxes.flip_boxes(b, "horizontal"), "horizontal")
    np.testing.assert_allclose(b[:, :6], b2[:, :6], atol=1e-5)
    np.testing.assert_allclose(torch.sin(b[:, 6]), torch.sin(b2[:, 6]),
                               atol=1e-5)


# ---------------------------------------------------------------------------
# BEV IoU
# ---------------------------------------------------------------------------

IOU_CASES = {
    # (boxes1, boxes2, expected IoU or None)
    "identical": ([[0, 0, 0, 4, 2, 1, 0.3]], [[0, 0, 0, 4, 2, 1, 0.3]], 1.0),
    "aligned_overlap": ([[0, 0, 0, 2, 2, 1, 0.0]], [[1, 0, 0, 2, 2, 1, 0.0]],
                        2.0 / 6.0),
    "disjoint": ([[0, 0, 0, 2, 2, 1, 0.4]], [[10, 10, 0, 2, 2, 1, 1.2]], 0.0),
    "shared_edge": ([[0, 0, 0, 2, 2, 1, 0.0]], [[2, 0, 0, 2, 2, 1, 0.0]],
                    0.0),
    "shared_corner": ([[0, 0, 0, 2, 2, 1, 0.0]], [[2, 2, 0, 2, 2, 1, 0.0]],
                      0.0),
    "contained": ([[0, 0, 0, 4, 4, 1, 0.0]], [[0, 0, 0, 2, 2, 1, 0.7]],
                  0.25),
    "zero_area": ([[0, 0, 0, 0, 0, 1, 0.0], [0, 0, 0, 2, 0, 1, 0.5]],
                  [[0, 0, 0, 2, 2, 1, 0.0], [0, 0, 0, 0, 0, 1, 0.0]], None),
    "point_boxes": ([[1, 1, 0, 0, 0, 1, 0.3]] * 2,
                    [[1, 1, 0, 0, 0, 1, 0.3], [1, 1, 0, 2, 2, 1, 0.0]],
                    None),
}


@pytest.mark.parametrize("case", sorted(IOU_CASES))
def test_iou_cases_match_jax(case):
    b1, b2, want = IOU_CASES[case]
    b1, b2 = np.asarray(b1, np.float32), np.asarray(b2, np.float32)
    ref = np.asarray(jiou.boxes_iou_bev(*_j(b1, b2)))
    got = tiou.boxes_iou_bev(_t(b1), _t(b2)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    if want is not None:
        np.testing.assert_allclose(got, [[want]], atol=1e-5)
    assert np.isfinite(got).all()


def test_rotated_45_intersection():
    b1 = torch.tensor([[0, 0, 0, 1, 1, 1, 0.0]])
    b2 = torch.tensor([[0, 0, 0, 1, 1, 1, np.pi / 4]])
    inter = tiou.boxes_intersection_bev(b1, b2)[0, 0]
    np.testing.assert_allclose(inter, 2 * (np.sqrt(2) - 1), atol=1e-4)


@pytest.mark.parametrize("chunk", [1 << 20, 97])
def test_iou_random_matches_jax(chunk, monkeypatch):
    """Random and clustered boxes, the full matrix; a small chunk (97
    pairs at a time) gives the same values, and the pairs too far apart
    to be clipped are 0 in JAX too."""
    monkeypatch.setattr(tiou, "PAIR_CHUNK", chunk)
    rng = np.random.RandomState(1)
    b = np.concatenate([rand_boxes(rng, 60), clustered_boxes(rng, 100)])
    ref = np.asarray(jiou.boxes_iou_bev(*_j(b, b)))
    got = tiou.boxes_iou_bev(_t(b), _t(b)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=IOU_TOL)
    assert (ref > 0.1).sum() > 2 * len(b)  # the clusters overlap
    np.testing.assert_array_equal(got == 0, ref == 0)
    full = tiou.boxes_intersection_bev(_t(b), _t(b)).numpy()
    assert ((full > 0) == (got > 0)).all() and (got == 0).mean() > 0.5


# ---------------------------------------------------------------------------
# NMS
# ---------------------------------------------------------------------------

def test_nms_cases_of_the_jax_tests():
    """``tests/test_core.py::TestNMS`` on the port."""
    centers = torch.tensor([[0.0, 0.0], [0.1, 0.0], [5.0, 5.0], [0.0, 0.0]])
    keep = tnms.circle_nms(centers, torch.tensor([0.9, 0.8, 0.7, 0.1]),
                           torch.tensor([True, True, True, False]), 0.5)
    assert keep.tolist() == [True, False, True, False]
    b = torch.tensor([[0, 0, 0, 4, 2, 1, 0.0], [0.2, 0, 0, 4, 2, 1, 0.05],
                      [10, 10, 0, 4, 2, 1, 0.0]])
    keep = tnms.rotated_nms_bev(b, torch.tensor([0.5, 0.9, 0.3]),
                                torch.ones(3, dtype=torch.bool), 0.3)
    assert keep.tolist() == [False, True, True]


def _assert_margin(values, valid, thr, what):
    pair = valid[:, None] & valid[None, :]
    near = pair & (np.abs(values - thr) <= MARGIN * max(thr, 1.0))
    assert not near.any(), (
        f"{what}: {int(near.sum())} pairs within {MARGIN} of the threshold "
        f"{thr}; the comparison would not be decided")


def _nms_inputs(seed, n=160, ties=False):
    rng = np.random.RandomState(seed)
    b = clustered_boxes(rng, n)
    s = rng.uniform(0, 1, n).astype(np.float32)
    if ties:  # many equal scores
        s = np.round(s * 4) / 4
    v = rng.uniform(size=n) < 0.9
    return b, s.astype(np.float32), v


@pytest.mark.parametrize("seed,ties,pre_max", [
    (1, False, None), (2, True, None), (4, False, 50), (5, True, 40)])
@pytest.mark.parametrize("thr", [0.1, 0.3, 0.65])
def test_rotated_nms_matches_jax(seed, ties, pre_max, thr):
    b, s, v = _nms_inputs(seed, ties=ties)
    _assert_margin(np.asarray(jiou.boxes_iou_bev(*_j(b, b))), v, thr, "IoU")
    ref = np.asarray(jnms.rotated_nms_bev(*_j(b, s, v), thr, pre_max))
    got = tnms.rotated_nms_bev(_t(b), _t(s), _t(v), thr, pre_max).numpy()
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.sum() < v.sum()  # something was suppressed


@pytest.mark.parametrize("seed,ties", [(0, False), (1, True)])
@pytest.mark.parametrize("radius", [0.5, 1.5])
def test_circle_nms_matches_jax(seed, ties, radius):
    b, s, v = _nms_inputs(seed, ties=ties)
    c = b[:, :2]
    d2 = ((c[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    _assert_margin(d2, v, radius * radius, "squared distance")
    ref = np.asarray(jnms.circle_nms(*_j(c, s, v), radius))
    got = tnms.circle_nms(_t(c), _t(s), _t(v), radius).numpy()
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.sum() < v.sum()


def test_equal_scores_keep_the_higher_index():
    """Two identical boxes of equal score: JAX's reversed stable sort puts
    the higher index first, so it is the one kept."""
    b = np.asarray([[0, 0, 0, 4, 2, 1, 0.3]] * 3, np.float32)
    s = np.asarray([0.5, 0.5, 0.2], np.float32)
    v = np.ones(3, bool)
    ref = np.asarray(jnms.rotated_nms_bev(*_j(b, s, v), 0.5))
    got = tnms.rotated_nms_bev(_t(b), _t(s), _t(v), 0.5).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.tolist() == [False, True, False]
    ref = np.asarray(jnms.circle_nms(*_j(b[:, :2], s, v), 1.0))
    got = tnms.circle_nms(_t(b[:, :2]), _t(s), _t(v), 1.0).numpy()
    np.testing.assert_array_equal(got, ref)


def test_suppress_loop_matches_the_sequential_definition():
    """The host pass against the JAX loop on a random asymmetric matrix."""
    rng = np.random.RandomState(4)
    n = 70
    sup = rng.uniform(size=(n, n)) < 0.05
    order = rng.permutation(n)
    ref = np.asarray(jnms._suppress_loop(*_j(order, sup)))
    got = tnms._suppress_loop(_t(order), _t(sup)).numpy()
    np.testing.assert_array_equal(got, ref)

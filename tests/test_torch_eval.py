"""The port's evaluator and result formatting against the JAX package's.

``core/eval_nuscenes.py`` on the randomised and hand cases of
``tests/test_eval_nuscenes.py`` (and on cases that exercise every TP error:
scales, yaws, velocities and the classes without orientation or velocity),
every metric within 1e-12 of the JAX evaluator's. ``core/results.py`` on
the cases of ``tests/test_data.py``'s ``TestResultFormatting``: the
quaternion round trip, lidar-to-global, and the submission and tracking
JSON equal key for key.
"""
import json

import numpy as np
import pytest

from focalformer3d_tpu.core import eval_nuscenes as jen
from focalformer3d_tpu.core import results as jres
from focalformer3d_tpu.data.nuscenes import CLASS_NAMES
from focalformer3d_tpu_torch.core import eval_nuscenes as ten
from focalformer3d_tpu_torch.core import results as tres

from test_eval_nuscenes import CLASSES, _box

TOL = 1e-12


def _assert_metrics(got, ref):
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=TOL,
                                   err_msg=k)


def _random_case(rng, classes, full=False):
    """``test_ap_matches_devkit_oracle_randomized``'s generator; with
    ``full``, random labels, dims, yaws and velocities too."""
    predictions, ground_truth = {}, {}
    for tok in [f"s{i}" for i in range(4)]:
        ng = rng.randint(1, 6)
        gxy = rng.uniform(-10, 10, (ng, 2))
        gb = np.asarray([_box(*p) for p in gxy])
        np_ = rng.randint(2, 9)
        pxy = np.concatenate([
            gxy[rng.randint(0, ng, np_ // 2)]
            + rng.normal(0, 1.0, (np_ // 2, 2)),
            rng.uniform(-12, 12, (np_ - np_ // 2, 2)),
        ])
        pb = np.asarray([_box(*p) for p in pxy])
        glab, plab = np.zeros(ng, np.int32), np.zeros(np_, np.int32)
        if full:
            for b in (gb, pb):
                b[:, 3:6] = rng.uniform(0.5, 5, (len(b), 3))
                b[:, 6] = rng.uniform(-np.pi, np.pi, len(b))
                b[:, 7:9] = rng.uniform(-3, 3, (len(b), 2))
            glab = rng.randint(0, len(classes), ng).astype(np.int32)
            plab = rng.randint(0, len(classes), np_).astype(np.int32)
        ground_truth[tok] = {"boxes": gb, "labels": glab}
        predictions[tok] = {"boxes": pb,
                            "scores": rng.uniform(0.05, 1.0, np_),
                            "labels": plab}
    return predictions, ground_truth


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("trial", range(5))
def test_random_cases_equal_jax(trial, full):
    classes = CLASS_NAMES if full else CLASSES
    rng = np.random.RandomState(trial + 10 * full)
    pred, gt = _random_case(rng, classes, full)
    _assert_metrics(ten.evaluate_detections(pred, gt, classes),
                    jen.evaluate_detections(pred, gt, classes))
    _assert_metrics(ten.evaluate_detections(pred, gt, classes, 2),
                    jen.evaluate_detections(pred, gt, classes, 2))


def _hand_cases():
    one = lambda boxes, scores: {"t0": {  # noqa: E731
        "boxes": np.asarray(boxes), "scores": np.asarray(scores),
        "labels": np.zeros(len(scores), np.int32)}}
    gt = lambda boxes: {"t0": {"boxes": np.asarray(boxes),  # noqa: E731
                               "labels": np.zeros(len(boxes), np.int32)}}
    return [
        # test_calc_ap_hand_fixture
        (one([_box(0.3, 0), _box(50, 50), _box(10, 0.45)], [0.9, 0.8, 0.7]),
         gt([_box(0, 0), _box(10, 0)]), ("car",)),
        # test_nds_composite_formula
        (one([_box(0.5, 0.0)], [0.9]), gt([_box(0.0, 0.0)]), ("car",)),
        # test_barrier_orientation_period
        (one([_box(0.0, 0.0, yaw=np.pi)], [0.9]), gt([_box(0.0, 0.0)]),
         ("car",)),
        (one([_box(0.0, 0.0, yaw=np.pi)], [0.9]), gt([_box(0.0, 0.0)]),
         ("barrier",)),
        # no predictions, and predictions without ground truth
        (one(np.zeros((0, 9)), []), gt([_box(1.0, 1.0)]), ("car",)),
        (one([_box(1.0, 1.0)], [0.5]), {"t0": {
            "boxes": np.zeros((0, 9)), "labels": np.zeros(0)}}, ("car",)),
    ]


@pytest.mark.parametrize("case", range(len(_hand_cases())))
def test_hand_cases_equal_jax(case):
    pred, gt, classes = _hand_cases()[case]
    _assert_metrics(ten.evaluate_detections(pred, gt, classes),
                    jen.evaluate_detections(pred, gt, classes))


def test_helpers_equal_jax():
    rng = np.random.RandomState(3)
    a, b = rng.uniform(-5, 5, (6, 2)), rng.uniform(-5, 5, (4, 2))
    np.testing.assert_array_equal(ten._center_dist(a, b),
                                  jen._center_dist(a, b))
    for _ in range(20):
        p, g = rng.uniform(0.1, 5, 3), rng.uniform(0.1, 5, 3)
        assert ten._scale_iou(p, g) == jen._scale_iou(p, g)
        y1, y2 = rng.uniform(-7, 7, 2)
        for period in (np.pi, 2 * np.pi):
            assert ten._yaw_diff(y1, y2, period) == jen._yaw_diff(y1, y2,
                                                                 period)
    preds = [{"sample": f"s{i % 2}", "box": rng.uniform(-3, 3, 9),
              "score": float(s)} for i, s in enumerate(rng.uniform(0, 1, 9))]
    gts = [{"sample": f"s{i % 2}", "box": rng.uniform(-3, 3, 9)}
           for i in range(5)]
    for th in ten.DIST_THRESHOLDS:
        for cname in ("car", "barrier"):
            got = ten.accumulate_class(preds, gts, th, True, cname)
            ref = jen.accumulate_class(preds, gts, th, True, cname)
            assert got == ref
    assert (ten.DIST_THRESHOLDS, ten.TP_THRESHOLD, ten.NO_VEL_CLASSES,
            ten.NO_ORIENT_CLASSES) == (jen.DIST_THRESHOLDS, jen.TP_THRESHOLD,
                                       jen.NO_VEL_CLASSES,
                                       jen.NO_ORIENT_CLASSES)


def test_quat_roundtrip_equals_jax():
    for yaw in (0.73, -2.5, 0.0, np.pi):
        q = tres.yaw_to_quat(yaw)
        assert q == jres.yaw_to_quat(yaw)
        R = tres.quat_to_mat(q)
        np.testing.assert_array_equal(R, jres.quat_to_mat(q))
        assert tres.mat_to_yaw(R) == jres.mat_to_yaw(R)
        assert abs(tres.mat_to_yaw(R) - np.arctan2(np.sin(yaw),
                                                   np.cos(yaw))) < 1e-9


INFO = {
    "lidar2ego_rotation": [1.0, 0, 0, 0],
    "lidar2ego_translation": [1.0, 0, 2.0],
    "ego2global_rotation": [np.cos(np.pi / 4), 0, 0,
                            np.sin(np.pi / 4)],  # yaw 90deg
    "ego2global_translation": [100.0, 50.0, 0.0],
}


def test_lidar_to_global_equals_jax():
    boxes = np.array([[10.0, 0, -1.0, 4, 2, 2, 0.0, 1.0, 0.0],
                      [-3.0, 7, -2.0, 1, 1, 1.5, 2.0, -0.5, 0.3]])
    got = tres.boxes_lidar_to_global(INFO, boxes)
    ref = jres.boxes_lidar_to_global(INFO, boxes)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    # tests/test_data.py's expectation
    np.testing.assert_allclose(got[0][0], [100.0, 61.0, 2.0], atol=1e-6)
    for name in CLASS_NAMES + ("unknown",):
        for speed in (0.0, 0.2, 0.3, 5.0):
            assert (tres.velocity_attribute(name, speed)
                    == jres.velocity_attribute(name, speed))


def test_submission_and_tracking_equal_jax(tmp_path):
    rng = np.random.RandomState(0)
    infos, preds = {}, {}
    for i in range(3):
        tok = f"tok{i}"
        infos[tok] = {**INFO, "ego2global_translation": [100.0 + i, 50.0,
                                                         0.0]}
        n = 7 + i
        boxes = np.zeros((n, 9))
        boxes[:, :3] = rng.uniform(-20, 20, (n, 3))
        boxes[:, 3:6] = rng.uniform(0.5, 4, (n, 3))
        boxes[:, 6] = rng.uniform(-np.pi, np.pi, n)
        boxes[:, 7:9] = rng.uniform(-3, 3, (n, 2))
        preds[tok] = {"boxes": boxes, "scores": rng.uniform(0, 1, n),
                      "labels": rng.randint(0, 10, n)}
    outs = {}
    for tag, mod in (("port", tres), ("jax", jres)):
        sub = mod.format_nuscenes_submission(
            preds, infos, CLASS_NAMES, str(tmp_path / tag / "sub.json"),
            max_boxes=6)
        trk = mod.tracking_from_detections(sub, str(tmp_path / tag /
                                                    "trk.json"))
        outs[tag] = (sub, trk)
        for f in ("sub.json", "trk.json"):
            assert (tmp_path / tag / f).exists()
    assert json.dumps(outs["port"][0]) == json.dumps(outs["jax"][0])
    assert json.dumps(outs["port"][1]) == json.dumps(outs["jax"][1])
    for f in ("sub.json", "trk.json"):
        assert ((tmp_path / "port" / f).read_text()
                == (tmp_path / "jax" / f).read_text())
    anns = outs["port"][0]["results"]["tok0"]
    assert len(anns) == 6 and anns[0]["detection_name"] in CLASS_NAMES

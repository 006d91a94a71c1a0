"""Parity: the port's TTA merge (``core/merge_augs.py``) against the JAX
package.

- the cases of ``tests/test_tta.py`` on the port: ``mapping_back`` round
  trips, duplicates merged and voted, classes that do not suppress each
  other, the ``merge_tta_results`` wrapper, ``tta_augs``' expansion and the
  offline ensemble's cache round trip;
- a random merge of 4 passes x 200 candidates (the double flip of
  ``tta_augs({})``; objects seen by every pass with jitter, plus spurious
  and invalid candidates, 10 classes) through both packages'
  ``merge_tta_results``: keep mask and labels exactly, boxes and scores
  within 1e-5 of each value's magnitude (at least 1). Both IoU thresholds
  (NMS 0.1, vote 0.65) decide comparisons, so the test first asserts, from
  the JAX IoU matrix of the class-offset boxes, that no valid pair lies
  within 1e-5 of either; a seed that has such a pair fails here;
- the cache both ways: what the port's ``dump_aug_cache`` writes, the JAX
  ``load_ensemble`` reads (the same keys, numpy arrays and dtypes, equal
  values), and the other way round.
"""
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focalformer3d_tpu.core import iou as jiou
from focalformer3d_tpu.core import merge_augs as jmerge
from focalformer3d_tpu_torch.core import boxes as tboxes
from focalformer3d_tpu_torch.core import merge_augs as tmerge
from focalformer3d_tpu_torch.core.merge_augs import (TTAConfig, mapping_back,
                                                     merge_aug_boxes,
                                                     merge_tta_results)

MARGIN = 1e-5


def _box(x, y, yaw=0.0, dx=4.0, dy=2.0, vx=1.0, vy=0.5):
    return [x, y, -1.0, dx, dy, 1.5, yaw, vx, vy]


def _f(x):
    return torch.tensor(x, dtype=torch.float32)


# ---------------------------------------------------------------------------
# the cases of tests/test_tta.py
# ---------------------------------------------------------------------------

def test_flip_scale_roundtrip():
    b = _f([_box(10.0, 5.0, 0.3)])
    fwd = tboxes.flip_boxes(tboxes.scale_boxes(b, 1.06), "horizontal")
    back = mapping_back(fwd, 1.06, True, False)
    np.testing.assert_allclose(back, b, rtol=1e-5, atol=1e-5)


def test_double_flip_roundtrip():
    b = _f([_box(-3.0, 7.0, -1.2)])
    fwd = tboxes.flip_boxes(tboxes.flip_boxes(b, "vertical"), "horizontal")
    got, want = mapping_back(fwd, 1.0, True, True)[0], b[0]
    np.testing.assert_allclose(got[:6], want[:6], atol=1e-5)
    assert abs(((got[6] - want[6]) + np.pi) % (2 * np.pi) - np.pi) < 1e-5
    np.testing.assert_allclose(got[7:], want[7:], atol=1e-5)


def test_mapping_back_matches_jax():
    rng = np.random.RandomState(2)
    b = rng.uniform(-20, 20, (50, 9)).astype(np.float32)
    for scale, fh, fv in tmerge.tta_augs({"pts_scale_ratio": (1.0, 1.06,
                                                              0.96)}):
        ref = np.asarray(jmerge.mapping_back(
            jnp.asarray(b), jnp.asarray(scale), jnp.asarray(fh),
            jnp.asarray(fv)))
        got = mapping_back(torch.from_numpy(b), scale, fh, fv).numpy()
        np.testing.assert_array_equal(got, ref)


def test_duplicates_merge_and_vote():
    cfg = TTAConfig(max_out=4, num_classes=3)
    boxes = _f([[_box(10.0, 5.0, 0.30), _box(-20.0, 0.0, 0.0)],
                [_box(10.4, 5.2, 0.34), _box(99.0, 99.0, 0.0)]])
    scores = _f([[0.9, 0.2], [0.7, 0.05]])
    labels = torch.tensor([[1, 0], [1, 2]], dtype=torch.int32)
    valid = torch.tensor([[True, True], [True, False]])
    out = merge_aug_boxes(cfg, boxes, scores, labels, valid)
    m = out["mask"]
    kept_boxes, kept_scores = out["bboxes"][m], out["scores"][m]
    assert int(m.sum()) == 2
    best = kept_boxes[torch.argmax(kept_scores)]
    assert 10.0 <= best[0] <= 10.4
    assert best[0] < 10.2  # nearer the higher-scored box
    assert 0.30 <= best[6] <= 0.34


def test_classes_do_not_suppress_each_other():
    cfg = TTAConfig(max_out=4, num_classes=3)
    out = merge_aug_boxes(cfg, _f([[_box(10.0, 5.0), _box(10.0, 5.0)]]),
                          _f([[0.9, 0.8]]),
                          torch.tensor([[0, 1]], dtype=torch.int32),
                          torch.tensor([[True, True]]))
    assert int(out["mask"].sum()) == 2


def test_wrapper():
    cfg = TTAConfig(max_out=8)
    r = {"bboxes": _f([_box(5.0, -2.0, 0.1)]), "scores": _f([0.5]),
         "labels": torch.tensor([3], dtype=torch.int32),
         "mask": torch.tensor([True])}
    r_flip = dict(r, bboxes=tboxes.flip_boxes(r["bboxes"], "horizontal"))
    out = merge_tta_results(cfg, [r, r_flip], scales=[1.0, 1.0],
                            flips_h=[False, True], flips_v=[False, False])
    assert int(out["mask"].sum()) == 1  # the same box after mapping back
    np.testing.assert_allclose(out["bboxes"][out["mask"]][0, :2],
                               [5.0, -2.0], atol=1e-4)


def test_scale_flip_roundtrip_identity():
    rng = np.random.RandomState(0)
    boxes = rng.uniform(-20, 20, size=(7, 9)).astype(np.float32)
    boxes[:, 3:6] = rng.uniform(1, 4, size=(7, 3))
    for scale, fh, fv in tmerge.tta_augs({
            "pts_scale_ratio": (1.0, 1.06, 0.96),
            "flip_horizontal": True, "flip_vertical": True}):
        b = boxes.copy()
        b[:, :6] *= scale
        b[:, 7:9] *= scale
        if fh:
            b[:, [1, 6, 8]] *= -1
        if fv:
            b[:, [0, 7]] *= -1
            b[:, 6] = np.pi - b[:, 6]
        back = mapping_back(torch.from_numpy(b), scale, fh, fv).numpy()
        yaw = np.abs(np.angle(np.exp(1j * (back[:, 6] - boxes[:, 6]))))
        np.testing.assert_allclose(back[:, :6], boxes[:, :6], atol=1e-4)
        np.testing.assert_allclose(back[:, 7:9], boxes[:, 7:9], atol=1e-4)
        assert float(yaw.max()) < 1e-4


def test_tta_augs_expansion():
    cfgs = [{"pts_scale_ratio": (1.0, 1.06, 0.96), "flip_horizontal": True,
             "flip_vertical": True}, {}, {"flip_vertical": False},
            {"flip_horizontal": False, "flip_vertical": False}]
    for c in cfgs:
        assert tmerge.tta_augs(c) == jmerge.tta_augs(c)
    augs = tmerge.tta_augs(cfgs[0])
    assert len(augs) == 12 and augs[0] == (1.0, False, False)
    assert len(tmerge.tta_augs({})) == 4


# ---------------------------------------------------------------------------
# a random 4-pass merge against JAX
# ---------------------------------------------------------------------------

def _passes(seed, n=200, objects=60, classes=10):
    """4 double-flip passes of n candidates each, in their augmented
    frames: every pass sees each object with jitter, then spurious boxes;
    the last 20 of each pass are invalid."""
    rng = np.random.RandomState(seed)
    obj = np.zeros((objects, 9), np.float32)
    obj[:, :2] = rng.uniform(-45, 45, (objects, 2))
    obj[:, 2] = rng.uniform(-2, 0, objects)
    obj[:, 3:6] = rng.uniform(0.5, 5.0, (objects, 3))
    obj[:, 6] = rng.uniform(-np.pi, np.pi, objects)
    obj[:, 7:9] = rng.uniform(-3, 3, (objects, 2))
    obj_cls = rng.randint(0, classes, objects)
    out = []
    for scale, fh, fv in tmerge.tta_augs({}):
        b = np.zeros((n, 9), np.float32)
        b[:objects] = obj
        b[:objects, :2] += rng.normal(0, 0.15, (objects, 2))
        b[:objects, 6] += rng.normal(0, 0.05, objects)
        b[objects:] = obj[rng.randint(0, objects, n - objects)]
        b[objects:, :2] += rng.normal(0, 2.0, (n - objects, 2))
        lab = np.concatenate([obj_cls, rng.randint(0, classes, n - objects)])
        # forward transform into the pass's frame (mapping_back undoes it)
        if fv:
            b[:, [0, 7]] *= -1
            b[:, 6] = np.pi - b[:, 6]
        if fh:
            b[:, [1, 6, 8]] *= -1
        s = rng.uniform(0.05, 1.0, n).astype(np.float32)
        v = np.arange(n) < n - 20
        out.append({"bboxes": b, "scores": s, "labels": lab.astype(np.int32),
                    "mask": v})
    return out


def _assert_decided(passes, cfg):
    """No valid pair of class-offset boxes within MARGIN of a threshold."""
    b = np.concatenate([np.asarray(jmerge.mapping_back(
        jnp.asarray(r["bboxes"]), jnp.asarray(s), jnp.asarray(fh),
        jnp.asarray(fv))) for r, (s, fh, fv) in zip(passes,
                                                    tmerge.tta_augs({}))])
    lab = np.concatenate([r["labels"] for r in passes])
    v = np.concatenate([r["mask"] for r in passes])
    b[:, 0] += lab.astype(np.float32) * np.float32(400.0)
    iou = np.asarray(jiou.boxes_iou_bev(jnp.asarray(b), jnp.asarray(b)))
    pair = v[:, None] & v[None, :]
    for thr in (cfg.nms_thresh, cfg.vote_iou):
        near = pair & (np.abs(iou - thr) <= MARGIN)
        assert not near.any(), (f"{int(near.sum())} pairs within {MARGIN} "
                                f"of {thr}: the comparison is undecided")
    # votes happen: pairs of distinct candidates above the vote IoU
    assert (pair & (iou > cfg.vote_iou)).sum() - v.sum() > 200


@pytest.mark.parametrize("seed", [0, 1])
def test_random_merge_matches_jax(seed):
    cfg = TTAConfig(num_classes=10)
    passes = _passes(seed)
    _assert_decided(passes, cfg)
    augs = tmerge.tta_augs({})
    kw = dict(scales=[a[0] for a in augs], flips_h=[a[1] for a in augs],
              flips_v=[a[2] for a in augs])
    ref = jmerge.merge_tta_results(
        jmerge.TTAConfig(num_classes=10),
        [{k: jnp.asarray(v) for k, v in r.items()} for r in passes], **kw)
    got = merge_tta_results(
        cfg, [{k: torch.from_numpy(v) for k, v in r.items()}
              for r in passes], **kw)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    np.testing.assert_array_equal(got["mask"].numpy(), ref["mask"])
    np.testing.assert_array_equal(got["labels"].numpy(), ref["labels"])
    for k in ("bboxes", "scores"):
        err = np.abs(got[k].numpy() - ref[k]) / np.maximum(np.abs(ref[k]), 1)
        assert err.max() <= 1e-5, (k, err.max())
    n = int(ref["mask"].sum())
    assert 60 <= n < 600  # the duplicates merged, the objects kept


# ---------------------------------------------------------------------------
# the offline ensemble's cache
# ---------------------------------------------------------------------------

def _cands(rng, n, score0):
    b = rng.randn(n, 9).astype(np.float32)
    b[:, 3:6] = np.abs(b[:, 3:6]) + 1.0
    s = np.linspace(score0, 0.1, n).astype(np.float32)
    lab = rng.randint(0, 3, size=n).astype(np.int32)
    v = np.ones(n, bool)
    v[-1] = False  # an invalid row, dropped when written
    return b, s, lab, v


def test_offline_ensemble_cache_roundtrip(tmp_path):
    rng = np.random.RandomState(0)
    d1, d2 = tmp_path / "m1", tmp_path / "m2"
    b1, s1, l1, v1 = _cands(rng, 6, 0.9)
    b2, s2, l2, v2 = _cands(rng, 4, 0.8)
    tmerge.dump_aug_cache(d1, "tok42", b1, s1, l1, v1)
    tmerge.dump_aug_cache(d2, "tok42", b2, s2, l2, v2)
    eb, es, el, ev = tmerge.load_ensemble([str(d1), str(d2)], "tok42",
                                          pad_to=16)
    assert ev.sum() == 5 + 3
    np.testing.assert_allclose(eb[:5], b1[:5])
    np.testing.assert_allclose(eb[5:8], b2[:3])
    assert (es[8:] == 0).all() and not ev[8:].any()
    merged = merge_aug_boxes(TTAConfig(num_classes=3),
                             *(torch.from_numpy(x)[None]
                               for x in (eb, es, el, ev)))
    m = merged["mask"].numpy()
    assert m.any() and not m[8:].any()
    assert m[int(np.argmax(es))]
    eb3, es3, el3, ev3 = tmerge.load_ensemble([str(d1), str(d2)], "tok42",
                                              pad_to=4)
    assert ev3.all() and es3.min() >= np.sort(
        np.concatenate([s1[v1], s2[v2]]))[-4]


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_cache_read_across_packages(tmp_path, writer, reader):
    pkg = {"port": tmerge, "jax": jmerge}
    rng = np.random.RandomState(3)
    folders = []
    for i, n in enumerate((12, 7)):
        b, s, lab, v = _cands(rng, n, 0.9 - 0.1 * i)
        folders.append(str(tmp_path / f"model{i}"))
        pkg[writer].dump_aug_cache(folders[-1], "sample_0003", b, s, lab, v)
    with open(tmp_path / "model0" / "sampleidx_sample_0003.pkl", "rb") as f:
        raw = pickle.load(f)
    assert set(raw) == {"aug_bboxes", "aug_scores", "aug_labels"}
    assert [(type(raw[k]), raw[k].dtype) for k in sorted(raw)] == [
        (np.ndarray, np.dtype(np.float32)), (np.ndarray, np.dtype(np.int32)),
        (np.ndarray, np.dtype(np.float32))]
    for pad in (40, 10):
        got = pkg[reader].load_ensemble(folders, "sample_0003", pad)
        ref = pkg[writer].load_ensemble(folders, "sample_0003", pad)
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype and g.shape == r.shape
            np.testing.assert_array_equal(g, r)

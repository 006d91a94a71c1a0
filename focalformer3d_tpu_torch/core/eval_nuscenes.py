"""Self-contained nuScenes-style detection evaluation (host-side NumPy).

The port's copy of ``focalformer3d_tpu/core/eval_nuscenes.py``: the
nuScenes detection metric definitions (center-distance matched AP at
{0.5, 1, 2, 4} m, TP errors ATE/ASE/AOE/AVE at 2 m, and the NDS composite)
on info-pkl ground truth, without the nuscenes-devkit or the raw dataset.
``tools/test.py --official-eval`` defers to the devkit where it and the
dataset are present (as the reference always does, tools/test.py:245-254);
this module reproduces the devkit's ``calc_ap`` / ``calc_tp`` / NDS math.

The attribute error (AAE) needs per-annotation attributes that the mmdet3d
info pkl does not carry; it is left out and NDS is computed over the other
4 TP metrics with the devkit weighting renormalized (``nds_no_attr``).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

DIST_THRESHOLDS = (0.5, 1.0, 2.0, 4.0)
TP_THRESHOLD = 2.0
MIN_RECALL = 0.1
MIN_PRECISION = 0.1

# classes for which velocity / orientation errors are undefined (devkit)
NO_VEL_CLASSES = ("barrier", "traffic_cone")
NO_ORIENT_CLASSES = ("traffic_cone",)


def _center_dist(pred_xy: np.ndarray, gt_xy: np.ndarray) -> np.ndarray:
    return np.linalg.norm(pred_xy[:, None] - gt_xy[None], axis=-1)


def _scale_iou(pred: np.ndarray, gt: np.ndarray) -> float:
    """Aligned 3D IoU of dims only (devkit scale_iou)."""
    inter = np.prod(np.minimum(pred, gt))
    union = np.prod(pred) + np.prod(gt) - inter
    return float(inter / max(union, 1e-9))


def _yaw_diff(a: float, b: float, period: float = 2 * np.pi) -> float:
    d = (a - b) % period
    if d > period / 2:
        d = period - d
    return abs(d)


def accumulate_class(
    preds: List[dict], gts: List[dict], dist_th: float,
    compute_tp: bool = False, class_name: str = "",
):
    """Greedy match (devkit `accumulate`): preds sorted by score descending
    across the dataset; each GT matched at most once per sample.

    preds: [{sample, box (9,), score}], gts: [{sample, box (9,)}].
    Returns dict with ap and (optionally) tp errors.
    """
    npos = len(gts)
    if npos == 0:
        return {"ap": np.nan, "ate": np.nan, "ase": np.nan, "aoe": np.nan,
                "ave": np.nan}
    order = np.argsort([-p["score"] for p in preds])
    gt_by_sample: Dict[str, List[int]] = {}
    for i, g in enumerate(gts):
        gt_by_sample.setdefault(g["sample"], []).append(i)
    taken = np.zeros(npos, bool)
    tp, fp = [], []
    errs = {"trans": [], "scale": [], "orient": [], "vel": []}
    conf = []
    for oi in order:
        p = preds[oi]
        cand = gt_by_sample.get(p["sample"], [])
        best, best_d = -1, dist_th
        for gi in cand:
            if taken[gi]:
                continue
            d = np.linalg.norm(p["box"][:2] - gts[gi]["box"][:2])
            if d < best_d:
                best, best_d = gi, d
        conf.append(p["score"])
        if best >= 0:
            taken[best] = True
            tp.append(1.0)
            fp.append(0.0)
            if compute_tp:
                g = gts[best]["box"]
                b = p["box"]
                errs["trans"].append(float(np.linalg.norm(b[:2] - g[:2])))
                errs["scale"].append(1.0 - _scale_iou(b[3:6], g[3:6]))
                period = (
                    np.pi if class_name == "barrier" else 2 * np.pi
                )
                errs["orient"].append(_yaw_diff(b[6], g[6], period))
                if len(b) >= 9 and len(g) >= 9:
                    errs["vel"].append(
                        float(np.linalg.norm(b[7:9] - g[7:9]))
                    )
        else:
            tp.append(0.0)
            fp.append(1.0)
    tp = np.cumsum(tp)
    fp = np.cumsum(fp)
    rec = tp / npos
    prec = tp / np.maximum(tp + fp, 1e-9)

    # devkit calc_ap: 101-point interp, clip min recall/precision 0.1
    rec_interp = np.linspace(0, 1, 101)
    prec_i = np.interp(rec_interp, rec, prec, right=0) if len(rec) else (
        np.zeros(101)
    )
    prec_i = prec_i[int(round(100 * MIN_RECALL)) + 1:]
    prec_i = np.maximum(prec_i - MIN_PRECISION, 0)
    ap = float(prec_i.mean() / (1 - MIN_PRECISION))

    out = {"ap": ap}
    if compute_tp:
        # devkit calc_tp: cumulative mean of errors over the TP ranking,
        # sampled on the recall grid up to max achieved recall.
        for name, key in (("ate", "trans"), ("ase", "scale"),
                          ("aoe", "orient"), ("ave", "vel")):
            e = np.asarray(errs[key], np.float64)
            if len(e) == 0:
                out[name] = 1.0
                continue
            cummean = np.cumsum(e) / (np.arange(len(e)) + 1)
            tp_rec = np.arange(1, len(e) + 1) / npos
            # sample at recall grid between min_recall and max achieved
            last = tp_rec[-1]
            grid = rec_interp[
                (rec_interp >= MIN_RECALL) & (rec_interp <= last)
            ]
            if len(grid) == 0:
                out[name] = 1.0
            else:
                out[name] = float(
                    np.interp(grid, tp_rec, cummean).mean()
                )
    return out


def evaluate_detections(
    predictions: Dict[str, dict],
    ground_truth: Dict[str, dict],
    class_names: Sequence[str],
    max_boxes_per_sample: int = 500,
) -> Dict[str, float]:
    """predictions[sample_token] = {boxes (N,9), scores (N,), labels (N,)},
    ground_truth[sample_token] = {boxes (G,9), labels (G,)}.

    Returns {mAP, mATE, mASE, mAOE, mAVE, nds_no_attr, per-class APs}.
    """
    per_class = {}
    for ci, cname in enumerate(class_names):
        preds, gts = [], []
        for tok, pr in predictions.items():
            sel = np.where(np.asarray(pr["labels"]) == ci)[0]
            order = np.argsort(-np.asarray(pr["scores"])[sel])
            for i in sel[order][:max_boxes_per_sample]:
                preds.append({
                    "sample": tok,
                    "box": np.asarray(pr["boxes"][i], np.float64),
                    "score": float(pr["scores"][i]),
                })
        for tok, gt in ground_truth.items():
            sel = np.where(np.asarray(gt["labels"]) == ci)[0]
            for i in sel:
                gts.append({
                    "sample": tok,
                    "box": np.asarray(gt["boxes"][i], np.float64),
                })
        aps = []
        tp_metrics = {}
        for th in DIST_THRESHOLDS:
            r = accumulate_class(
                preds, gts, th, compute_tp=(th == TP_THRESHOLD),
                class_name=cname,
            )
            aps.append(r["ap"])
            if th == TP_THRESHOLD:
                tp_metrics = {
                    k: r[k] for k in ("ate", "ase", "aoe", "ave")
                }
        per_class[cname] = {
            "ap": float(np.nanmean(aps)) if aps else np.nan, **tp_metrics
        }

    valid = [c for c in class_names if not np.isnan(per_class[c]["ap"])]
    mean_ap = float(np.mean([per_class[c]["ap"] for c in valid])) if (
        valid
    ) else 0.0

    def mean_tp(key, exclude=()):
        vals = [
            per_class[c][key] for c in valid
            if c not in exclude and key in per_class[c]
        ]
        return float(np.mean(vals)) if vals else 1.0

    m_ate = mean_tp("ate")
    m_ase = mean_tp("ase")
    m_aoe = mean_tp("aoe", exclude=NO_ORIENT_CLASSES)
    m_ave = mean_tp("ave", exclude=NO_VEL_CLASSES)

    # devkit NDS: (5*mAP + sum over TP scores) / 10 with 5 TP metrics; with
    # AAE unavailable we renormalize over the 4 computable ones: weight 5
    # for mAP + 4 TP scores, denominator 9.
    tp_scores = [max(1 - m, 0.0) for m in (m_ate, m_ase, m_aoe, m_ave)]
    nds = (5.0 * mean_ap + sum(tp_scores)) / 9.0

    out = {
        "mAP": mean_ap, "mATE": m_ate, "mASE": m_ase, "mAOE": m_aoe,
        "mAVE": m_ave, "nds_no_attr": nds,
    }
    for c in class_names:
        out[f"AP_{c}"] = per_class[c]["ap"]
    return out

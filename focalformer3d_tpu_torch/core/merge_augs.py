"""Test-time-augmentation merging of box lists, with fixed shapes.

Port of ``focalformer3d_tpu/core/merge_augs.py`` (the reference's
``merge_aug_bboxes_3d``): each augmented pass's boxes are mapped back to the
canonical frame (``mapping_back``), concatenated, suppressed by per-class
rotated-BEV NMS (IoU > 0.1), voted among by IoU-weighted averaging (IoU >=
0.65; yaw through the weighted means of its sine and cosine), and the top
500 by score are kept. Every pass is padded to the same box count and the
merge works on masks, so a merge has the shape of its inputs.

``dump_aug_cache`` and ``load_ensemble`` write and read the offline
ensemble's per-sample pickles in the JAX package's layout (numpy arrays
``aug_bboxes`` float32, ``aug_scores`` float32, ``aug_labels`` int32), so
either package reads what the other wrote.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import boxes as box_utils
from .iou import boxes_iou_bev
from .nms import nms_from_iou, top_k_mask


@dataclasses.dataclass(frozen=True)
class TTAConfig:
    nms_thresh: float = 0.1
    vote_iou: float = 0.65
    max_out: int = 500
    num_classes: int = 10


def mapping_back(boxes: torch.Tensor, scale: float, flip_horizontal: bool,
                 flip_vertical: bool) -> torch.Tensor:
    """Undo a pass's augmentation on its predicted (N, 9) boxes, as mmdet3d's
    ``bbox3d_mapping_back``: flip back, then scale by 1 / ``scale`` (the
    reciprocal taken in the boxes' dtype, as the JAX version takes it)."""
    b = boxes
    if flip_horizontal:
        b = box_utils.flip_boxes(b, "horizontal")
    if flip_vertical:
        b = box_utils.flip_boxes(b, "vertical")
    scale = torch.as_tensor(scale, dtype=b.dtype, device=b.device)
    return box_utils.scale_boxes(b, 1.0 / scale)


def merge_aug_boxes(cfg: TTAConfig, boxes: torch.Tensor,
                    scores: torch.Tensor, labels: torch.Tensor,
                    valid: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Merge A passes of N mapped-back candidates: boxes (A, N, 9), scores,
    labels and valid (A, N). Returns bboxes (M, 9), scores (M,) (0 where
    not kept), labels (M,) and mask (M,), M = A * N; the mask marks the
    kept top ``max_out``."""
    A, N = scores.shape
    b = boxes.reshape(A * N, -1)
    s = scores.reshape(-1)
    lab = labels.reshape(-1)
    v = valid.reshape(-1)

    # per-class NMS as one NMS: each class is moved 400 m along x, farther
    # than any box reaches (the batched-NMS offset, in the boxes' dtype)
    b_off = b.clone()
    b_off[:, 0] = b[:, 0] + lab.to(b.dtype) * (2.0 * 200.0)
    iou = boxes_iou_bev(b_off, b_off)
    keep = nms_from_iou(iou, torch.where(v, s, torch.full_like(s, -1.0)), v,
                        cfg.nms_thresh) & v

    # IoU-weighted vote of each box over the valid boxes of its class
    w = torch.where((iou >= cfg.vote_iou) & v[None, :], s[None, :],
                    torch.zeros_like(iou))
    ww = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-6)
    parts = [ww @ b[:, :6],
             torch.atan2(ww @ torch.sin(b[:, 6]),
                         ww @ torch.cos(b[:, 6]))[:, None]]
    if b.shape[1] > 7:
        parts.append(ww @ b[:, 7:])
    voted = torch.where((w.sum(-1) > 0)[:, None], torch.cat(parts, -1), b)

    final = top_k_mask(torch.where(keep, s, torch.full_like(s, -float("inf"))),
                       keep, cfg.max_out)
    return {"bboxes": voted,
            "scores": torch.where(final, s, torch.zeros_like(s)),
            "labels": lab, "mask": final}


def merge_tta_results(cfg: TTAConfig, aug_results: Sequence[dict],
                      scales: Sequence[float], flips_h: Sequence[bool],
                      flips_v: Sequence[bool]) -> Dict[str, torch.Tensor]:
    """Map each pass's result (bboxes (N, 9), scores, labels, mask) back
    and merge them."""
    boxes = torch.stack([mapping_back(r["bboxes"], sc, fh, fv)
                         for r, sc, fh, fv in zip(aug_results, scales,
                                                  flips_h, flips_v)])
    return merge_aug_boxes(
        cfg, boxes, torch.stack([r["scores"] for r in aug_results]),
        torch.stack([r["labels"] for r in aug_results]),
        torch.stack([r["mask"] for r in aug_results]))


def dump_aug_cache(cache_dir: str, sample_idx, boxes: np.ndarray,
                   scores: np.ndarray, labels: np.ndarray,
                   valid: np.ndarray) -> None:
    """Write one sample's mapped-back candidates (host arrays) for offline
    ensembling, the valid rows only, to ``sampleidx_<idx>.pkl`` in
    ``cache_dir`` (the reference's ``temp_result_folder`` pickles)."""
    os.makedirs(cache_dir, exist_ok=True)
    v = np.asarray(valid)
    payload = {
        "aug_bboxes": np.asarray(boxes)[v].astype(np.float32),
        "aug_scores": np.asarray(scores)[v].astype(np.float32),
        "aug_labels": np.asarray(labels)[v].astype(np.int32),
    }
    with open(os.path.join(cache_dir, f"sampleidx_{sample_idx}.pkl"),
              "wb") as f:
        pickle.dump(payload, f)


def load_ensemble(folders: Sequence[str], sample_idx, pad_to: int
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Concatenate one sample's cached candidates from several model
    folders (``dump_aug_cache``'s, in either package; a missing file
    raises) and pad them to ``pad_to`` rows; past ``pad_to`` the
    best-scored stay. Returns numpy boxes (P, 9), scores (P,), labels (P,)
    and valid (P,)."""
    bs: List[np.ndarray] = []
    ss: List[np.ndarray] = []
    ls: List[np.ndarray] = []
    for folder in folders:
        with open(os.path.join(folder, f"sampleidx_{sample_idx}.pkl"),
                  "rb") as f:
            t = pickle.load(f)
        bs.append(t["aug_bboxes"])
        ss.append(t["aug_scores"])
        ls.append(t["aug_labels"])
    boxes = np.concatenate(bs, 0)
    scores = np.concatenate(ss, 0)
    labels = np.concatenate(ls, 0)
    n = len(scores)
    if n > pad_to:
        keep = np.argsort(-scores)[:pad_to]
        boxes, scores, labels = boxes[keep], scores[keep], labels[keep]
        n = pad_to
    pad = pad_to - n
    return (np.pad(boxes, ((0, pad), (0, 0))), np.pad(scores, (0, pad)),
            np.pad(labels, (0, pad)), np.arange(pad_to) < n)


def tta_augs(tta_cfg: dict) -> List[Tuple[float, bool, bool]]:
    """A config's ``tta`` dict as (scale, flip_h, flip_v) passes: every
    ``pts_scale_ratio`` times the double flip (the reference's
    ``MultiScaleFlipAug3D``)."""
    scales = tuple(tta_cfg.get("pts_scale_ratio", (1.0,)))
    flips = [(False, False)]
    if tta_cfg.get("flip_horizontal", True):
        flips.append((True, False))
    if tta_cfg.get("flip_vertical", True):
        flips.append((False, True))
    if len(flips) == 3:
        flips.append((True, True))
    return [(s, fh, fv) for s in scales for fh, fv in flips]

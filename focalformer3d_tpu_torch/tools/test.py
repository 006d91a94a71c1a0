"""Evaluation CLI.

Port of ``tools/test.py``: runs the eval step over a nuScenes split on one
card, optionally with test-time augmentation, scores the boxes with the
port's evaluator (``core/eval_nuscenes.py``), and writes a nuScenes
submission (``--out``) and a tracking file (``--tracking-out``):

    python -m focalformer3d_tpu_torch.tools.test FocalFormer3D_L \\
        --checkpoint work_dirs/ff3d_l/epoch_6 --data-root data/nuscenes \\
        --out results/ff3d_l.json [--tta [--tta-cache-dir cache/ff3d_l]]
    python -m focalformer3d_tpu_torch.tools.test FocalFormer3D_L \\
        --data-root data/nuscenes --tta-ensemble cache/a cache/b

The model gets random weights from ``--seed``, or the weights of an
``epoch_N`` directory of the train CLI or of ``tools/convert_checkpoint.py``
(``--checkpoint``). Samples load in a prefetching thread (depth 4); each
runs through ``make_eval_step`` on the sparse engine of ``--engine``
(``auto``: ``cuda`` on a card, ``plain`` on the CPU). ``--official-eval``
runs the nuscenes-devkit's DetectionEval on the submission where the devkit
and the raw dataset are present.

Test-time augmentation (``--tta``, as the JAX CLI runs it): one eval pass
per entry of ``core.merge_augs.tta_augs`` of the config's ``tta`` dict (the
LiDAR configs have none: the double flip, 4 passes), each on the sample's
points scaled and flipped on the host before ``collate``; the passes'
boxes are mapped back and merged on the device (``merge_tta_results``:
per-class rotated NMS, IoU-weighted voting, the top 500). With
``--tta-cache-dir`` each sample's mapped-back candidates are also written
there (``dump_aug_cache``, the JAX package's pickle layout). With
``--tta-ensemble`` no model is built and nothing runs forward: each
sample's cached candidates of the given folders (padded to ``--max-out`` x
8 x folders) are merged (``merge_aug_boxes``).

It runs on the card unless ``--device cpu`` is given, and raises where
there is none. A Waymo config raises (ROADMAP.md, Queue 1 item 10).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

import torch

from .train import load_config, resolve_device


def parse_args(argv: Optional[List[str]] = None):
    from ..models.sparse_encoder import ENGINES

    p = argparse.ArgumentParser(description="Evaluate a FocalFormer3D model")
    p.add_argument("config")
    p.add_argument("--checkpoint", default=None,
                   help="epoch_N directory of the train CLI")
    p.add_argument("--data-root", default="data/nuscenes")
    p.add_argument("--ann-file", default=None,
                   help="infos pkl (default: nuscenes_infos_val.pkl in "
                        "--data-root)")
    p.add_argument("--out", default=None, help="submission json path")
    p.add_argument("--tracking-out", default=None)
    p.add_argument("--max-points", type=int, default=300000)
    p.add_argument("--max-out", type=int, default=200)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--engine", default="auto", choices=ENGINES,
                   help="sparse engine (auto: cuda on a card, plain on "
                        "the CPU)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights without --checkpoint")
    p.add_argument("--tta", action="store_true",
                   help="double-flip TTA with box voting")
    p.add_argument("--tta-cache-dir", default=None,
                   help="with --tta, write each sample's mapped-back "
                        "candidates here for offline ensembling")
    p.add_argument("--tta-ensemble", nargs="+", default=None,
                   help="no forward pass: merge the cached candidates of "
                        "these folders")
    p.add_argument("--official-eval", action="store_true",
                   help="run the nuscenes-devkit DetectionEval on the "
                        "submission (needs --out, raw dataset, devkit)")
    p.add_argument("--eval-set", default="val")
    p.add_argument("--nusc-version", default="v1.0-trainval")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default: the card, raises without one) "
                        "or 'cpu'")
    return p.parse_args(argv)


@dataclasses.dataclass
class EvalRun:
    """What ``main`` leaves: the metrics, the kept boxes and the ground
    truth per sample token, the submission (None without ``--out``), the
    samples and seconds of the loop over them, the seconds to the first
    sample's boxes (set-up included), the eval passes per sample (0 for an
    ensemble) and the seconds of the TTA merges (host clock from the
    device's last pass to the merged boxes on the host)."""

    metrics: Dict[str, float]
    predictions: Dict[str, dict]
    ground_truth: Dict[str, dict]
    submission: Optional[dict]
    samples: int
    seconds: float
    seconds_first: float
    passes: int = 1
    seconds_merge: float = 0.0


def ground_truth_of(sample: dict, classes) -> dict:
    """The evaluator's ground truth of one pipeline output: its boxes of
    the config's classes and their labels (JAX ``tools/test.py:253-265``)."""
    if "gt_boxes" in sample and len(sample["gt_boxes"]):
        names = sample["gt_names"]
        keep = [j for j, nm in enumerate(names) if nm in classes]
        return {"boxes": sample["gt_boxes"][keep],
                "labels": np.asarray([classes.index(names[j]) for j in keep],
                                     np.int32)}
    return {"boxes": np.zeros((0, 9)), "labels": np.zeros(0)}


def augment_points(points: np.ndarray, scale: float, flip_h: bool,
                   flip_v: bool) -> np.ndarray:
    """A TTA pass's points (JAX ``tools/test.py:185-193``): xyz scaled by
    ``scale``, then y negated for the horizontal flip and x for the
    vertical one."""
    pts = points.copy()
    if scale != 1.0:
        pts[:, :3] = pts[:, :3] * scale
    if flip_h:
        pts[:, 1] = -pts[:, 1]
    if flip_v:
        pts[:, 0] = -pts[:, 0]
    return pts


def kept(dec: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The boxes, scores and labels that a result's mask keeps, on the
    host."""
    m = dec["mask"].cpu().numpy()
    return {k: dec[src].cpu().numpy()[m]
            for k, src in (("boxes", "bboxes"), ("scores", "scores"),
                           ("labels", "labels"))}


def main(argv: Optional[List[str]] = None) -> EvalRun:
    args = parse_args(argv)
    device = resolve_device(args.device)

    from ..core import eval_nuscenes
    from ..core import merge_augs as ma
    from ..core import results as res
    from ..data import nuscenes as nusc
    from ..data import pipelines as pl
    from ..data.prefetch import prefetch
    from ..models.detector import FocalFormer3D
    from ..training import checkpoint as ckpt
    from ..training.loop import to_device
    from ..training.train_step import make_eval_step
    from ..utils.ref_keys import make_fake_state_dict

    cfg_all = load_config(args.config)
    cfg = dataclasses.replace(cfg_all["model"], sparse_engine=args.engine)
    classes = list(cfg_all["class_names"])
    ann = args.ann_file or str(
        Path(args.data_root) / "nuscenes_infos_val.pkl")
    ds = nusc.NuScenesDataset(
        ann, data_root=args.data_root, classes=classes,
        pipeline=pl.test_pipeline(cfg.voxel.point_cloud_range,
                                  with_images=cfg.input_img),
        with_images=cfg.input_img, test_mode=True)
    n = len(ds) if args.limit is None else min(args.limit, len(ds))
    augs = (ma.tta_augs(cfg_all.get("tta", {})) if args.tta
            else [(1.0, False, False)])
    tta_cfg = ma.TTAConfig(num_classes=len(classes))
    if args.tta_ensemble:
        mode = f"an ensemble of {len(args.tta_ensemble)} caches"
    else:
        mode = f"engine {args.engine}, {len(augs)} pass(es) a sample"
    print(f"evaluating {n} samples on {device}, {mode}", flush=True)

    eval_step = model = None
    if not args.tta_ensemble:
        model = FocalFormer3D(cfg)
        model.load_state_dict(make_fake_state_dict(model, seed=args.seed),
                              strict=True)
        model = model.to(device)
        if args.checkpoint:
            ckpt.restore_checkpoint(args.checkpoint, model)
            print(f"loaded {args.checkpoint}", flush=True)
        eval_step = make_eval_step(cfg, args.max_out)

    def merge(fn, *a):
        """``fn(*a)``'s kept boxes on the host, and its host seconds from
        the device's last pass on."""
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t = time.time()
        out = kept(fn(*a))
        return out, time.time() - t

    rng = np.random.RandomState(0)
    predictions, gt = {}, {}
    first = merge_s = 0.0
    t0 = time.time()
    # sample loading is host-side IO + numpy work; a thread keeps it off
    # the eval step's path (one producer: the rng draw order is unchanged)
    for i, s in enumerate(prefetch(
            (ds.get_sample(j, rng) for j in range(n)), depth=4)):
        token = s["token"]
        if args.tta_ensemble:
            cands = ma.load_ensemble(
                args.tta_ensemble, token,
                pad_to=args.max_out * 8 * len(args.tta_ensemble))
            predictions[token], sec = merge(
                ma.merge_aug_boxes, tta_cfg,
                *(torch.from_numpy(x)[None].to(device) for x in cands))
            merge_s += sec
        else:
            results = []
            for scale, fh, fv in augs:
                b = nusc.collate(
                    [dict(s, points=augment_points(s["points"], scale, fh,
                                                   fv))],
                    classes, max_points=args.max_points,
                    max_gts=cfg.decoder.max_gts // 4)
                b.pop("tokens")
                dec = eval_step(model, to_device(b, device))
                results.append({k: dec[k][0] for k in
                                ("bboxes", "scores", "labels", "mask")})
            if len(results) == 1:
                predictions[token] = kept(results[0])
            else:
                if args.tta_cache_dir:
                    ma.dump_aug_cache(args.tta_cache_dir, token, *(
                        torch.cat(x).cpu().numpy() for x in (
                            [ma.mapping_back(r["bboxes"], *aug)
                             for r, aug in zip(results, augs)],
                            [r["scores"] for r in results],
                            [r["labels"] for r in results],
                            [r["mask"] for r in results])))
                predictions[token], sec = merge(
                    ma.merge_tta_results, tta_cfg, results,
                    [a[0] for a in augs], [a[1] for a in augs],
                    [a[2] for a in augs])
                merge_s += sec
        gt[token] = ground_truth_of(s, classes)
        if i == 0:
            first = time.time() - t0
        if (i + 1) % 50 == 0:
            print(f"{i + 1}/{n} ({(i + 1) / (time.time() - t0):.2f} "
                  "samples/s)", flush=True)
    seconds = time.time() - t0
    merged = (f"; the TTA merge {merge_s / n * 1e3:.1f} ms a sample"
              if merge_s else "")
    print(f"{n} samples in {seconds:.2f} s ({n / seconds:.3f} samples/s; "
          f"the first {first:.2f} s{merged})", flush=True)

    metrics = eval_nuscenes.evaluate_detections(predictions, gt, classes)
    print(json.dumps({k: round(v, 4) for k, v in metrics.items()}),
          flush=True)
    print("note: nds_no_attr averages 9 terms (no attribute error: info "
          "pkls carry no attributes) and is NOT comparable to published "
          "NDS; use --official-eval for devkit NDS.", flush=True)

    sub = None
    if args.out:
        infos_by_token = {info["token"]: info for info in ds.infos}
        sub = res.format_nuscenes_submission(predictions, infos_by_token,
                                             classes, args.out)
        print(f"wrote {args.out}", flush=True)
        if args.tracking_out:
            res.tracking_from_detections(sub, args.tracking_out)
            print(f"wrote {args.tracking_out}", flush=True)
    if args.official_eval:
        official = run_official_nuscenes_eval(
            args.out, args.data_root, args.eval_set, args.nusc_version)
        if official is not None:
            print("official nuScenes devkit metrics:")
            print(json.dumps(official, indent=1), flush=True)
    return EvalRun(metrics, predictions, gt, sub, n, seconds, first,
                   0 if args.tta_ensemble else len(augs), merge_s)


def run_official_nuscenes_eval(submission_json, data_root, eval_set,
                               version):
    """Run the official nuscenes-devkit DetectionEval on a submission
    json (the reference's tools/test.py:245-254 -> dataset.evaluate).
    Returns the devkit metrics dict, or None if the devkit or the raw
    dataset is not available (the port's evaluator has already been
    reported)."""
    if not submission_json:
        print("--official-eval needs --out <submission.json>")
        return None
    try:
        from nuscenes import NuScenes
        from nuscenes.eval.detection.config import config_factory
        from nuscenes.eval.detection.evaluate import DetectionEval
    except ImportError:
        print("nuscenes-devkit not installed; used the port's evaluator.")
        return None
    try:
        nusc_obj = NuScenes(
            version=version, dataroot=data_root, verbose=False
        )
        ev = DetectionEval(
            nusc_obj,
            config=config_factory("detection_cvpr_2019"),
            result_path=submission_json,
            eval_set=eval_set,
            output_dir=str(Path(submission_json).parent / "official_eval"),
            verbose=False,
        )
        metrics = ev.main(render_curves=False)
        return {
            "mAP": metrics["mean_ap"],
            "NDS": metrics["nd_score"],
            **{k: v for k, v in metrics.items()
               if k.startswith("mean_dist_aps") or k.startswith("tp_")},
        }
    except Exception as e:  # raw dataset missing, bad token set, ...
        print(f"official eval failed: {type(e).__name__}: {e}")
        return None


if __name__ == "__main__":
    main()

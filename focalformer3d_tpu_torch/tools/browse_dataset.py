"""Draw a sample's points and GT boxes from above to a PNG.

Port of ``tools/browse_dataset.py`` (the counterpart of the reference's
tools/misc/browse_dataset.py): the same flags and the same sample, a
synthetic scene (``--synthetic``, ``data/synthetic.make_scene`` from
``RandomState(--index)``) or sample ``--index`` of a nuScenes directory
through the test pipeline (or the train pipeline with
``--train-pipeline``), drawn over x, y in [-54, 54]:

    python -m focalformer3d_tpu_torch.tools.browse_dataset --synthetic
    python -m focalformer3d_tpu_torch.tools.browse_dataset \\
        --data-root data/nuscenes --index 3 --out sample3.png

The geometry is the JAX tool's ``render_bev``'s (``bev_geometry``): each
point's x and y, and each box's five-corner outline. The port draws it
with ``utils/png.py`` instead of matplotlib, which the card's machine
lacks: gray points of one pixel, red box edges, on a white ``SIZE`` x
``SIZE`` image, the JAX tool's 10-inch figure at 120 dpi (no axes or
ticks: the rasteriser draws no text). Reads no device.
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils import png

PC_RANGE = (-54, -54, 54, 54)  # x0, y0, x1, y1 of the drawing
SIZE = 1200  # pixels a side
# the nuScenes range the JAX tool's pipelines filter to
PIPELINE_RANGE = (-54.0, -54.0, -5.0, 54.0, 54.0, 3.0)


def bev_geometry(points: np.ndarray, boxes: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(xy (N, 2) float64, corners (M, 5, 2) float64): the points' x, y and
    each box's closed outline, computed as ``render_bev`` computes what it
    draws (its float32 cosines included)."""
    xy = np.stack([np.asarray(points[:, 0], np.float64),
                   np.asarray(points[:, 1], np.float64)], 1)
    base = np.array([[0.5, 0.5], [0.5, -0.5], [-0.5, -0.5], [-0.5, 0.5],
                     [0.5, 0.5]])
    outlines = []
    for b in boxes:
        cx, cy, dx, dy, yaw = b[0], b[1], b[3], b[4], b[6]
        c, s = np.cos(yaw), np.sin(yaw)
        corners = base * [dx, dy]
        outlines.append(corners @ np.array([[c, s], [-s, c]]) + [cx, cy])
    corners = (np.stack(outlines).astype(np.float64) if outlines
               else np.zeros((0, 5, 2)))
    return xy, corners


def render_bev(points: np.ndarray, boxes: np.ndarray, out_path: str,
               pc_range: Sequence[float] = PC_RANGE) -> png.Canvas:
    """Draw ``bev_geometry`` to an RGB PNG at ``out_path``; returns the
    canvas."""
    xy, corners = bev_geometry(points, boxes)
    canvas = png.Canvas(SIZE, SIZE, (pc_range[0], pc_range[2]),
                        (pc_range[1], pc_range[3]))
    canvas.points(xy, png.GRAY)
    for outline in corners:
        canvas.polyline(outline, png.RED)
    png.write_png(out_path, canvas.rgb)
    return canvas


def load_sample(args) -> Tuple[np.ndarray, np.ndarray]:
    """(points, gt_boxes) of the sample the flags name, as the JAX tool
    loads it."""
    if args.synthetic:
        from ..data import synthetic

        pts, boxes, _ = synthetic.make_scene(np.random.RandomState(
            args.index))
        return pts, boxes
    from ..data import nuscenes as nusc
    from ..data import pipelines as pl

    ann = args.ann_file or str(Path(args.data_root)
                               / "nuscenes_infos_train.pkl")
    pipe = (pl.train_pipeline(PIPELINE_RANGE, nusc.CLASS_NAMES)
            if args.train_pipeline else pl.test_pipeline(PIPELINE_RANGE))
    ds = nusc.NuScenesDataset(ann, data_root=args.data_root, pipeline=pipe)
    s = ds.get_sample(args.index, np.random.RandomState(0))
    return s["points"], s.get("gt_boxes", np.zeros((0, 9)))


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ann-file", default=None)
    p.add_argument("--data-root", default="data/nuscenes")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--index", type=int, default=0)
    p.add_argument("--train-pipeline", action="store_true")
    p.add_argument("--out", default="browse.png")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> png.Canvas:
    args = parse_args(argv)
    points, boxes = load_sample(args)
    canvas = render_bev(points, boxes, args.out)
    print(f"wrote {args.out}")
    return canvas


if __name__ == "__main__":
    main()

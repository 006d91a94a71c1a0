"""Training-log analysis: loss curves and the mean time an iteration.

Port of ``tools/analyze_logs.py`` (the counterpart of the reference's
tools/analysis_tools/analyze_logs.py). It reads both logs the train CLI
leaves: its printed lines ``epoch N iter M (T s/it) k=v ...`` kept as a
text file, and the ``train_log.jsonl`` of its work dir (the records with
``mode == "train"``). Per log it prints the log points and their mean
s/it, then per key of ``--keys`` and per epoch the mean and the last
value, in the JAX tool's words:

    python -m focalformer3d_tpu_torch.tools.analyze_logs \\
        work_dirs/ff3d_l/train_log.jsonl --keys loss grad_norm

``--plot-out`` draws each key's values over the log points to a PNG with
``utils/png.py`` (no matplotlib, which the card's machine lacks), one
colour a key, and prints which colour is which key.
"""
from __future__ import annotations

import argparse
import json
import re
from collections import defaultdict
from typing import List, Optional

from ..utils import png

LINE = re.compile(
    r"epoch (\d+) iter (\d+) \(([\d.]+)s/it\) (.*)"
)
PLOT_SIZE = (800, 600)  # width, height in pixels
MARGIN = 20  # pixels left free on each side of the curves


def parse(path: str) -> List[dict]:
    """The log's train points in order, each {"epoch", "iter", "s_per_it",
    <key>: value}; a JSON record keeps its other fields too."""
    rows = []
    for line in open(path):
        line = line.strip()
        if line.startswith("{"):
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if rec.get("mode") != "train":
                continue
            rec = dict(rec)
            rec["s_per_it"] = float(rec.pop("time", 0.0))
            rows.append(rec)
            continue
        m = LINE.search(line)
        if not m:
            continue
        ep, it, dt, rest = m.groups()
        kv = dict(
            (k, float(v)) for k, v in re.findall(r"(\S+)=([-\d.einf]+)", rest)
        )
        rows.append({"epoch": int(ep), "iter": int(it),
                     "s_per_it": float(dt), **kv})
    return rows


def plot(rows: List[dict], keys: List[str], out_path: str) -> dict:
    """Each key's values against the log point's index as a polyline, over
    the range of all of them; returns {key: colour name}."""
    series = {k: [(i, r[k]) for i, r in enumerate(rows) if k in r]
              for k in keys}
    vals = [v for pts in series.values() for _, v in pts
            if v == v and abs(v) != float("inf")]
    lo, hi = (min(vals), max(vals)) if vals else (0.0, 1.0)
    if hi == lo:
        lo, hi = lo - 0.5, hi + 0.5
    n = max(len(rows) - 1, 1)
    w, h = PLOT_SIZE
    # the curves fill the canvas less a margin on each side
    mx, my = MARGIN / (w - 2 * MARGIN), MARGIN / (h - 2 * MARGIN)
    canvas = png.Canvas(w, h, (-mx * n, n * (1 + mx)),
                        (lo - my * (hi - lo), hi + my * (hi - lo)))
    colours = {}
    for (k, pts), (name, rgb) in zip(series.items(),
                                     png.PALETTE * len(keys)):
        finite = [(i, v) for i, v in pts
                  if v == v and abs(v) != float("inf")]
        if len(finite) == 1:
            canvas.points(finite, rgb)
        elif finite:
            canvas.polyline(finite, rgb)
        colours[k] = name
    png.write_png(out_path, canvas.rgb)
    return colours


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("logs", nargs="+")
    p.add_argument("--keys", nargs="*", default=["loss"])
    p.add_argument("--plot-out", default=None)
    args = p.parse_args(argv)
    for path in args.logs:
        rows = parse(path)
        if not rows:
            print(f"{path}: no train lines found")
            continue
        avg_t = sum(r["s_per_it"] for r in rows) / len(rows)
        print(f"{path}: {len(rows)} log points, avg {avg_t:.3f}s/it")
        by_ep = defaultdict(list)
        for r in rows:
            by_ep[r["epoch"]].append(r)
        for k in args.keys:
            for ep in sorted(by_ep):
                vals = [r[k] for r in by_ep[ep] if k in r]
                if vals:
                    print(f"  epoch {ep}: {k} mean {sum(vals)/len(vals):.4f}"
                          f" last {vals[-1]:.4f}")
        if args.plot_out:
            colours = plot(rows, args.keys, args.plot_out)
            print("  colours: " + ", ".join(f"{k} {c}"
                                            for k, c in colours.items()))
            print(f"wrote {args.plot_out}")


if __name__ == "__main__":
    main()

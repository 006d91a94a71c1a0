"""Readings that the limits of ``correct`` are set from.

    python3 -m perfbench.calibrate --workload L.stream \\
        --seeds 11,12,13,14,15,16,17,18,19,20,21,22 --control 3

In one process (the set-up is long): for each seed, the program's
numbers (``judge``) after a short window at the cell's own load; then, on
the first ``--control`` seeds, the control's (the reference put in the
program's place, one step below the stated precision:
``reference/precision.py``; at inference the reference in the stated
dtype with each product's operands rounded to float8) and, for a training cell, the planted fault
"half of the batch left out, the mean taken over the rest" (the reference
on each batch's first half). One JSON line per reading, then a summary:
per number the largest program reading (the lower end of its limit) and
the smallest control reading (the upper end). A state left unchanged
reads 1 on ``change`` by its definition and needs no run. Each seed also
prints how many of the queries that the reference picks from the
program's heatmaps it would not pick from its own (``own_picks_differ``,
of ``queries``).

``--look`` (a training cell): per seed, the parameters whose change
reads the widest gaps (``judge.gaps``, with their first gradient's gap
and their reference gradient over the median parameter's), for three
runs against the float32 reference: the program; the reference with the
stated bfloat16 rounding of the sparse encoder's products
(``reference/precision.py``); and the port's ``plain`` engine (float32),
against the reference that picks from its heatmaps.
"""
from __future__ import annotations

import argparse
import json
import math
import sys

import torch


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--seconds", type=float, default=0.0,
                   help="window per seed (at least one pass over the pool)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--look", action="store_true",
                   help="training: name the widest gaps of the change")
    args = p.parse_args(argv)

    from . import bench, judge, loops
    from .reference.precision import control
    from .spec import load_cell

    cell = load_cell(args.workload)
    device = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sess = bench.Session(cell, device)
    sess.build()
    tr = cell.traffic
    seconds = args.seconds
    if sess.kind == "stream":
        seconds = max(seconds, (tr["pool"] + 1) / tr["rate_hz"])
    prec = cell.config["precision"]
    seeds = [int(s) for s in args.seeds.split(",")]
    rows = {"program": [], "control": [], "half_batch": []}
    ctrl_ref = None

    def emit(kind, seed, numbers):
        rows[kind].append(numbers)
        print(json.dumps({"reading": kind, "seed": seed, **numbers}),
              flush=True)

    for i, seed in enumerate(seeds):
        pr = sess.prepare(seed, False)
        w = sess.measure(pr, seconds, False) if not sess.train else None
        if sess.train:
            ref_run = sess.reference_steps(pr)
            emit("program", seed, judge.judge_train(pr.readings, ref_run))
            batch0 = loops.take(pr.pool, loops.batches_of(tr)[0])
            print(json.dumps({
                "losses": {"program": pr.readings["loss"],
                           "reference": ref_run["loss"]},
                "own_picks_differ": judge.own_picks_differ_train(
                    sess.ref, pr.state, batch0, pr.seeds.step,
                    pr.readings["picks"][0]),
                "queries": tr["batch"] * _queries(sess)}), flush=True)
            if args.look:
                look(sess, pr, ref_run, seed)
        else:
            emit("program", seed, sess.check(pr, w))
            kept = [(loops.take(pr.pool, w.kept[i][0]), w.kept[i])
                    for i in pr.keep]
            print(json.dumps({
                "values": [judge.judge_inference(sess.ref, scan,
                                                 *k[1:])["values"]
                           for scan, k in kept],
                "own_picks_differ": [judge.own_picks_differ(
                    sess.ref, scan, k[2]) for scan, k in kept],
                "queries": len(w.kept[pr.keep[0]][0]) * _queries(sess)}),
                flush=True)
        if i >= args.control:
            continue
        ref = sess.reference(pr.state)
        if sess.train:
            ctrl = sess.reference_steps(pr, lambda: control(
                ref.model, prec["control_train_fp8"]))
            emit("control", seed, judge.judge_train(ctrl, ref_run))
            half = sess.reference_steps(pr, half=True)
            emit("half_batch", seed, judge.judge_train(half, ref_run))
            continue
        if ctrl_ref is None:
            ctrl_ref = judge.Reference(cell.config, device,
                                       prec["infer_dtype"])
        ctrl_ref.load(pr.state)
        readings = []
        for idx in pr.keep:
            rws = w.kept[idx][0]
            scan = loops.take(pr.pool, rws)
            with control(ctrl_ref.model, prec["control_infer_fp8"],
                         prec["control_infer_exempt"]):
                vox, out, dec = ctrl_ref.infer(scan)
            readings.append(judge.judge_inference(ref, scan, vox, out, dec))
        emit("control", seed, judge.worst(readings))
    keys = rows["program"][0].keys()
    summary = {}
    for k in keys:
        lower = max(r[k] for r in rows["program"])
        upper = {kind: min(r[k] for r in rows[kind])
                 for kind in ("control", "half_batch") if rows[kind]}
        summary[k] = {"lower": lower, "upper": upper,
                      "ratio": {kind: (u / lower if lower > 0 else math.inf)
                                for kind, u in upper.items()}}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


def _queries(sess) -> int:
    """Queries a sample picks: every heatmap stage's proposals."""
    d = sess.ref.cfg.decoder
    return d.num_proposals * d.total_stages


def look(sess, pr, ref_run, seed: int, top: int = 5) -> None:
    """``--look``'s lines of one seed (see the module)."""
    from . import judge
    from .bench import first_steps
    from .program import Program
    from .reference.precision import control, round_bf16

    cell = sess.cell
    ref = sess.reference(pr.state)
    emu = sess.reference_steps(pr, lambda: control(
        ref.model, cell.config["precision"]["control_train_fp8"],
        round_to=round_bf16, tf32=False))
    plain = Program(cell.config, sess.device, True, engine="plain")
    plain.load(pr.state)
    b1_0 = judge.Reference.schedule_b1(cell.config, cell.traffic)
    plain_readings = first_steps(plain, pr, cell.traffic, b1_0)[3]
    del plain
    ref_plain = sess.reference_steps(pr, select=plain_readings["picks"])
    for name, (a, b) in {"program": (pr.readings, ref_run),
                         "bf16_reference": (emu, ref_run),
                         "plain": (plain_readings, ref_plain)}.items():
        change, grad = judge.gaps(a, b, "change"), judge.gaps(a, b, "grad")
        gn = {n: float(g.double().norm()) for n, g in b["grad"].items()}
        med = float(torch.tensor(list(gn.values())).median())
        worst = sorted(change, key=change.get, reverse=True)[:top]
        print(json.dumps({"look": name, "seed": seed, "change_worst": [
            [n, change[n], grad[n], gn[n] / med] for n in worst],
            "heatmap": judge.judge_train(a, b)["heatmap"]}), flush=True)


if __name__ == "__main__":
    sys.exit(main())

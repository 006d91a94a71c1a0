"""Set-up, window, check and metrics of one run of one cell.

``Session`` holds what a run builds once: the port's detector (the system
under test) and, once the window has closed, the reference. ``prepare``
gives it one seed's weights and pool and warms up the cell's shapes (in
training: runs the first steps, which the check follows); ``measure`` runs
the window; ``check`` holds what the window produced against the
reference. ``run_cell`` is one run of the benchmark; the calibration and
sweep tools drive the same pieces over several seeds or rates.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import subprocess
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import judge, loops, work
from .data.weights import make_state_dict
from .program import Program, build_kernels, kernel_launches
from .spec import PKG, Cell

NEVER = 1e30  # the compared numbers of a kept request that never came


def card(device) -> Dict[str, object]:
    """The card's name (as torch gives it) and power limit (as nvidia-smi
    gives it)."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "power_limit": None}
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={device.index or 0}"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "power_limit": line.split(",", 1)[1].strip()}


def load_reader(name: str):
    """``read`` of ``metrics/<name>.py``: a metric's own reader."""
    path = PKG / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Prepared:
    """One seed's inputs and, in training, the set-up steps' readings."""

    seeds: loops.Seeds
    state: Dict[str, torch.Tensor]
    pool: Dict[str, torch.Tensor]
    keep: List[int]
    readings: Optional[dict] = None
    opt_state: object = None
    step: object = None
    gen: Optional[torch.Generator] = None
    first: int = 0


class Session:
    def __init__(self, cell: Cell, device: torch.device):
        self.cell, self.device = cell, device
        self.kind = cell.traffic["loop"]
        self.train = self.kind == "train"
        self.program: Optional[Program] = None
        self.ref: Optional[judge.Reference] = None

    def build(self) -> Dict[str, float]:
        built = build_kernels() if self.device.type == "cuda" else {}
        self.program = Program(self.cell.config, self.device, self.train)
        return built

    def prepare(self, seed: int, trace: bool,
                traffic: Optional[dict] = None) -> Prepared:
        """Weights and pool from ``seed``, the cell's own shapes warmed up
        (with ``trace``, the profiler too)."""
        traffic = traffic or self.cell.traffic
        program, dev = self.program, self.device
        s = loops.seeds(seed)
        state = make_state_dict(program.state_shapes(), s.weights, dev)
        program.load(state)
        pool = loops.make_pool(traffic, self.cell.config, program.cfg,
                               s.data, dev)
        units = (traffic["pool"] if self.kind == "stream"
                 else traffic["pool"] // traffic["batch"])
        keep = sorted(int(x) for x in s.order.choice(
            units, traffic["check_items"], replace=False))
        p = Prepared(s, state, pool, keep)
        if self.train:
            self._first_steps(p, traffic, trace)
        else:
            warm = ([[r] for r in range(traffic["warmup"])]
                    if self.kind == "stream"
                    else loops.batches_of(traffic)[:traffic["warmup"]])
            for rows in warm:
                program.infer(loops.take(pool, rows))
            if trace:
                loops.profile_warmup(dev, lambda: program.infer(
                    loops.take(pool, warm[0])))
        sync(dev)
        return p

    def _first_steps(self, p: Prepared, traffic: dict, trace: bool):
        """The set-up's training steps, through the window's own step and
        feed on distinct batches: the reference follows them."""
        p.opt_state, p.step, p.gen, p.readings = first_steps(
            self.program, p, traffic,
            judge.Reference.schedule_b1(self.cell.config, traffic))
        p.first = traffic["check_steps"]
        if trace:
            batches = loops.batches_of(traffic)
            loops.profile_warmup(self.device, lambda: p.step(
                self.program.model, p.opt_state,
                loops.take(p.pool, batches[p.first]), p.gen))
            p.first += 1

    def measure(self, p: Prepared, seconds: float, trace: bool,
                traffic: Optional[dict] = None) -> loops.Window:
        traffic = traffic or self.cell.traffic
        if self.kind == "stream":
            w = loops.stream(self.program, p.pool, traffic, p.seeds.order,
                             seconds, trace, p.keep)
        elif self.kind == "offline":
            w = loops.offline(self.program, p.pool, traffic, p.seeds.order,
                              seconds, trace, p.keep)
        else:
            w = loops.train(self.program, p.step, p.opt_state, p.gen,
                            p.pool, traffic, seconds, trace, p.first)
        sync(self.device)
        return w

    def free_program(self) -> None:
        self.program = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, state) -> judge.Reference:
        if self.ref is None:
            self.ref = judge.Reference(self.cell.config, self.device)
        self.ref.load(state)
        return self.ref

    def limits(self) -> Dict[str, float]:
        return self.cell.config["limits"]["train" if self.train
                                          else "infer"]

    def check(self, p: Prepared, w: Optional[loops.Window]
              ) -> Dict[str, float]:
        """The compared numbers (``judge``) of the program's run."""
        traffic = self.cell.traffic
        ref = self.reference(p.state)
        if self.train:
            return judge.judge_train(p.readings, self.reference_steps(p))
        readings = []
        for idx in p.keep:
            if idx not in w.kept:  # never answered: not correct
                return {k: NEVER for k in self.limits()}
            rows, vox, out, dec = w.kept[idx]
            readings.append(judge.judge_inference(
                ref, loops.take(p.pool, rows), vox, out, dec))
        return judge.worst(readings)

    def reference_steps(self, p: Prepared, context=None,
                        half: bool = False, select=None) -> dict:
        """The reference's steps on the set-up's batches, picking the
        queries from the program's heatmaps of each step (or from
        ``select``'s)."""
        traffic = self.cell.traffic
        batches = loops.batches_of(traffic)
        return judge.reference_steps(
            self.reference(p.state), p.state,
            [loops.take(p.pool, batches[k])
             for k in range(traffic["check_steps"])],
            p.seeds.step, traffic["schedule_steps"],
            select or p.readings["picks"], context, half)


def first_steps(program: Program, p: Prepared, traffic: dict, b1_0: float):
    """``check_steps`` training steps of ``program`` from its loaded
    weights on the pool's first batches: (optimizer state, step function,
    its generator, the readings the check compares: per step the loss,
    its heatmap term and the heatmap logits the queries were picked from;
    the first gradient as the optimizer took it, from its first moment and
    the first update's ``b1_0``; each parameter's change)."""
    opt_state, step = program.make_train(traffic["schedule_steps"])
    gen = torch.Generator(device=program.device)
    gen.manual_seed(p.seeds.step)
    batches = loops.batches_of(traffic)
    losses, heat, grad, picks = [], [], None, []
    hook = program.model.register_forward_hook(
        lambda _m, _a, out: picks.append(
            out["dense_heatmap"].detach().float().clone()))
    for k in range(traffic["check_steps"]):
        m = step(program.model, opt_state, loops.take(p.pool, batches[k]),
                 gen)
        losses.append(float(m["loss"]))
        heat.append(float(m["loss_heatmap"]))
        if k == 0:
            grad = {n: mu.detach() / (1.0 - b1_0) for n, mu in
                    zip(opt_state.names, opt_state.mu)}
    hook.remove()
    named = dict(program.model.named_parameters())
    readings = {"loss": losses, "loss_heatmap": heat, "grad": grad,
                "picks": picks,
                "change": {n: named[n].detach() - p.state[n]
                           for n in opt_state.names}}
    return opt_state, step, gen, readings


def run_cell(cell: Cell, device: torch.device, seed: int, seconds: float,
             trace: bool, t_proc: float
             ) -> Tuple[dict, List[str], Dict[str, Tuple[float, float]]]:
    """(result line, earlier lines, {compared number: (value, limit)})."""
    traffic = cell.traffic
    notes: List[str] = []
    info = card(device)
    notes.append(f"device: {info['kind']}, power limit "
                 f"{info['power_limit']}")
    sess = Session(cell, device)
    built = sess.build()
    if built:
        notes.append("kernels built (s): " + ", ".join(
            f"{k} {v:.1f}" for k, v in built.items()))
    p = sess.prepare(seed, trace)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    launches0 = kernel_launches()
    setup_s = time.time() - t_proc

    w = sess.measure(p, seconds, trace)
    launches = {k: v - launches0[k] for k, v in kernel_launches().items()}
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    n_items = len(w.rows)
    notes.append(f"window: {n_items} {'steps' if sess.train else 'requests'}"
                 f" in {w.seconds:.3f} s; kernel launches per item "
                 + ", ".join(f"{k} {v / max(n_items, 1):.2f}"
                             for k, v in launches.items()))
    if w.lateness_ms:
        lat = np.asarray(w.lateness_ms)
        notes.append(f"generator lateness (ms, {len(lat)} scans that found "
                     f"the system idle): median "
                     f"{float(np.median(lat)):.4f}, p95 "
                     f"{float(np.percentile(lat, 95)):.4f}, max "
                     f"{float(lat.max()):.4f}")
    analysed = None
    if trace and w.profile is not None:
        from .trace import analyse

        analysed = analyse(w.profile)
        w.profile = None

    sess.free_program()  # the program's state goes before the reference
    numbers = sess.check(p, w)
    for rows in loops.batches_of({"batch": 1, "pool": traffic["pool"]}):
        occ = judge.occupancy(sess.ref, loops.take(p.pool, rows),
                              sess.train)[0]
        notes.append(f"occupancy scan {rows[0]}: " + "; ".join(
            f"{lv} {a} of {c} (dropped {d})" for lv, a, c, d in occ))
    checks = {k: (float(numbers[k]), float(v))
              for k, v in sess.limits().items()}
    n_failed = sum(w.batch for f in w.failed if f)
    kept_all = sess.train or len(w.kept) == len(p.keep)
    correct = n_failed == 0 and kept_all and all(
        v <= lim for v, lim in checks.values())

    ctx = {"kind": sess.kind, "window": w, "setup_s": setup_s,
           "trace": analysed}
    if trace:
        ctx["work"] = _work(sess, p, w, info["kind"])
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_line = {"platform": info["platform"], "kind": info["kind"],
                   "count": info["count"], "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": n_items * w.batch,
              "failed": n_failed, "metrics": metrics,
              "device": device_line}
    if trace:
        device_line["busy_s"] = analysed["busy_s"] if analysed else 0.0
        device_line["window_s"] = analysed["window_s"] if analysed else 0.0
        if analysed:
            result["breakdown"] = {"device_ops": analysed["device_ops"],
                                   "idle_gaps": analysed["idle_gaps"]}
    return result, notes, checks


def _work(sess: Session, p: Prepared, w: loops.Window, device_name: str):
    """Per window item, ``work.count`` of its inputs; None where the card
    has no peak table."""
    if device_name not in work.PEAKS:
        return None
    ref = sess.ref
    precision = sess.cell.config["precision"][
        "train" if sess.train else "infer"]
    per_rows: Dict[tuple, dict] = {}
    for rows in sorted({tuple(r) for r in w.rows}):
        batch = loops.take(p.pool, list(rows))
        if sess.train:
            def run(batch=batch):
                ref.model.train()
                vox = judge.preprocess_points(
                    ref.cfg, batch["points"], batch["points_mask"],
                    train=True)
                img = ({k: batch[k] for k in judge.IMG_KEYS}
                       if ref.cfg.input_img else None)
                gen = torch.Generator(device=ref.device)
                gen.manual_seed(0)
                ref.model(vox, batch["gt_boxes"], batch["gt_labels"],
                          batch["gt_valid"], gen, img_data=img)
        else:
            def run(batch=batch):
                ref.infer(batch)
        per_rows[rows] = work.count(ref.model, run, precision, device_name,
                                    train=sess.train)
    ref.model.eval()
    return [per_rows[tuple(r)] for r in w.rows]

"""One data-parallel training step over ``n`` processes.

Counterpart of ``__graft_entry__.dryrun_multichip``: it spawns ``n``
worker processes, joined over gloo, all on one device (the card unless
``--device cpu`` is given), each of which runs one ``make_train_step``
step of the tiny config on its shard of one global batch (batch 1 a
rank), and prints the global loss:

    python -m focalformer3d_tpu_torch.tools.dryrun_ddp [n] [--device cpu]

    dryrun_ddp(2): loss=... OK

gloo, since NCCL takes one rank a card and these ranks share one. The
worker (``one_step`` under ``--worker``) is also what the tests spawn, on
the CPU or two ranks on one card. On the card
it runs one untimed step first, so that the step it times and keeps pays
no first call's costs.
It reads the global batch and the denoising groups' noise from an ``.npz``
(``step_inputs``), builds the model from ``make_fake_state_dict`` of a
seed with its dropouts off and the groups' noise fixed (so that one step
is one function of the batch, as ``tests/test_torch_train_step.py`` holds
it), takes its rank's rows, runs the step on each engine it is given and
saves what the step left (global metrics, gradients, the state dict, the
kernels' launches, times, batch-norm collectives, peak memory) to one file
a rank and engine. The same ``one_step`` at world size 1 on the whole
batch is the reference a data-parallel step is held against.
``--plant`` runs the step once more per engine with one piece of the
data-parallel step broken (``planted``), to show that the comparison
fails it.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

BATCH_KEYS = ("points", "points_mask", "gt_boxes", "gt_labels", "gt_valid")
REPO = Path(__file__).resolve().parents[2]
MODULE = "focalformer3d_tpu_torch.tools.dryrun_ddp"
# tests/test_torch_train_step.py's tolerances (``compare``)
LOSS_TOL, GRAD_TOL, PARAM_TOL = 1e-5, 2e-4, 2e-5
# bfloat16's unit roundoff: the kernel engines round the convs' operands
# to it, and ``compare_to_floor`` holds their total loss to it
BF16_ROUNDOFF = 2.0 ** -9
# the pieces of the data-parallel step that ``planted`` can break: SyncBN
# whose backward keeps the rank's own cotangents only, the loss
# normalisers counted on the rank's shard, no gradient all-reduce
FAULTS = ("bn_backward", "local_counts", "no_grad_sum")


def step_inputs(cfg, seed: int, batch_size: int, n_points: int,
                n_boxes: int, max_gts: int, mode: str = "uniform"
                ) -> Dict[str, np.ndarray]:
    """A global batch of ``data/synthetic.make_batch`` from
    ``RandomState(seed)`` and the denoising groups' U(-1, 1) noise
    (B, add_gt_groups * G, 2) from ``RandomState(seed + 1)``."""
    from ..data import synthetic

    out = synthetic.make_batch(
        np.random.RandomState(seed), batch_size=batch_size,
        n_points=n_points, n_boxes=n_boxes, max_gts=max_gts,
        num_classes=cfg.decoder.num_classes,
        pc_range=cfg.voxel.point_cloud_range, mode=mode)
    shape = (batch_size, cfg.decoder.add_gt_groups * max_gts, 2)
    out["noise"] = np.random.RandomState(seed + 1).uniform(
        -1, 1, shape).astype(np.float32)
    return out


def _without_dropout(cfg):
    return dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, roi_dropout=0.0))


@contextlib.contextmanager
def planted(fault: Optional[str]):
    """Break one piece of the data-parallel step (one of ``FAULTS``) in
    this process while the context lasts; nothing for None."""
    from ..parallel import mesh

    if fault is None:
        yield
        return
    name, kind = {"bn_backward": ("all_reduce_sum", "bn"),
                  "local_counts": ("all_reduce_", "loss"),
                  "no_grad_sum": ("all_reduce_flat_", "grad")}[fault]
    real = getattr(mesh, name)

    def broken(t, k, *rest):
        if k != kind:
            return real(t, k, *rest)
        if fault == "local_counts":
            return t
        if fault == "no_grad_sum":
            return None
        s = t.detach().clone()  # the sum forward, the identity backward
        torch.distributed.all_reduce(s)
        return t + (s - t.detach())

    setattr(mesh, name, broken)
    try:
        yield
    finally:
        setattr(mesh, name, real)


def one_step(name: str, engine: str, inputs: Dict[str, np.ndarray],
             weights_seed: int, device: torch.device,
             warmup: bool = False) -> dict:
    """One ``make_train_step`` step of config ``name`` on ``engine`` from
    ``make_fake_state_dict(model, weights_seed)``, dropouts off, on this
    rank's rows of the global batch ``inputs`` (all of them at world size
    1), with the noise of ``inputs`` for the denoising groups. ``warmup``
    runs the step once first and puts the weights and statistics back, so
    that the step measured pays no first call's costs."""
    from ..configs import get_config
    from ..models import focal_decoder
    from ..models.detector import FocalFormer3D
    from ..parallel import mesh
    from ..training import optim, train_step
    from ..utils.ref_keys import make_fake_state_dict

    cfg_all = get_config(name)
    cfg = dataclasses.replace(_without_dropout(cfg_all["model"]),
                              sparse_engine=engine)
    model = FocalFormer3D(cfg)
    model.load_state_dict(make_fake_state_dict(model, seed=weights_seed),
                          strict=True)
    for mod in model.modules():  # the decoder layers' dropouts
        if isinstance(getattr(mod, "dropout", None), float):
            mod.dropout = 0.0
    model = model.to(device)
    tx = optim.make_optimizer(total_steps=10)
    step = train_step.make_train_step(cfg, cfg_all["loss"], tx)

    world, rank = mesh.world_size(), mesh.rank()
    b = inputs["points"].shape[0] // world
    rows = slice(rank * b, (rank + 1) * b)
    batch = {k: torch.from_numpy(inputs[k][rows]).to(device)
             for k in BATCH_KEYS}
    noise = torch.from_numpy(inputs["noise"][rows]).to(device)

    def fixed_noise(generator, shape, dev):
        if tuple(shape) != tuple(noise.shape):
            raise ValueError(f"noise of shape {tuple(shape)} asked for, "
                             f"{tuple(noise.shape)} given")
        return noise

    cuda = device.type == "cuda"
    marks = {}

    def mark(phase):
        if cuda:
            torch.cuda.synchronize(device)
        marks[phase] = time.perf_counter()

    real = focal_decoder.gt_group_noise
    focal_decoder.gt_group_noise = fixed_noise
    try:
        if warmup:
            start = {k: v.clone() for k, v in model.state_dict().items()}
            step(model, tx.init(list(model.parameters())), batch, None)
            model.load_state_dict(start)
            del start
        opt_state = tx.init(list(model.parameters()))
        train_step.reset_kernel_launches()
        mesh.reset_collectives()
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        mark("start")
        metrics = step(model, opt_state, batch, None, mark)
        launches = train_step.kernel_launches()
        collectives = mesh.collectives()
    finally:
        focal_decoder.gt_group_noise = real
    metrics = train_step.global_metrics(metrics)
    dp = marks.get(train_step.DP_PHASE)
    return {
        "config": name, "engine": engine, "rank": rank, "world": world,
        "metrics": {k: float(v) for k, v in metrics.items()},
        "grads": {n: p.grad.detach().cpu()
                  for n, p in model.named_parameters() if p.grad is not None},
        "state": {k: v.detach().cpu() for k, v in model.state_dict().items()},
        "launches": launches,
        "step_ms": (marks["optimizer"] - marks["start"]) * 1e3,
        "allreduce_ms": (dp - marks["backward"]) * 1e3 if dp else 0.0,
        "bn_collectives": collectives.get("bn", 0),
        "collectives": collectives,
        "peak_gib": (torch.cuda.max_memory_allocated(device) / 2**30
                     if cuda else None),
    }


def _rel(a: torch.Tensor, b: torch.Tensor, floor: float = 1e-12) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / max(float(b.abs().max()), floor))


def compare(got: dict, ref: dict) -> dict:
    """Hold a data-parallel step's result ``got`` against the world-size-1
    step ``ref`` (both of ``one_step``), tensor by tensor, at the
    tolerances of ``tests/test_torch_train_step.py``: every metric within
    ``LOSS_TOL`` relative (``num_pos`` exactly); every gradient within
    ``GRAD_TOL`` of its tensor's largest (one whose both sides lie below
    1e-5 of the step's largest gradient is rounding noise around an
    analytic zero, and is skipped); every state tensor within
    ``PARAM_TOL`` of its scale, plus, for a parameter, what the gradients'
    difference can move it through Adam's first update. Returns the worst
    share of its tolerance of each kind with the tensor's name, and ``ok``
    when none passes 1."""
    from ..training import optim

    gmax = max(float(g.abs().max()) for g in ref["grads"].values())
    if set(got["grads"]) != set(ref["grads"]):
        raise ValueError("the two steps have gradients of other parameters")
    keys = [k for k in ref["metrics"] if k != "assign_iterations"]
    errs = [(abs(got["metrics"][k] - ref["metrics"][k])
             / max(abs(ref["metrics"][k]), 1e-12) / LOSS_TOL, k)
            for k in keys]
    if got["metrics"]["num_pos"] != ref["metrics"]["num_pos"]:
        errs.append((float("inf"), "num_pos"))
    worst = {"loss": max(errs)}
    worst["grad"] = max(
        (_rel(got["grads"][k], g) / GRAD_TOL, k)
        for k, g in ref["grads"].items()
        if max(float(g.abs().max()),
               float(got["grads"][k].abs().max())) > 1e-5 * gmax)
    tx = optim.make_optimizer(total_steps=10)
    lr = tx.lr(0)
    clips = [min(1.0, tx.grad_clip / r["metrics"]["grad_norm"])
             for r in (got, ref)]
    worst["state"] = (0.0, "")
    for k, v in ref["state"].items():
        if not v.is_floating_point() or k.endswith("bev_pos"):
            continue
        r, g = v.double(), got["state"][k].double()
        allow = PARAM_TOL * max(float(r.abs().max()), 1e-3)
        if k in ref["grads"]:
            dg = (got["grads"][k].double() * clips[0]
                  - ref["grads"][k].double() * clips[1]).abs()
            allow = allow + 1.01 * lr * torch.clamp(dg / tx.eps, max=2.0)
        worst["state"] = max(worst["state"],
                             (float(((g - r).abs() / allow).max()), k))
    return {"ok": all(w <= 1.0 for w, _ in worst.values()),
            **{f"{kind}_worst": w for kind, w in worst.items()}}


def _flat(res: dict, part: str, keys) -> torch.Tensor:
    return torch.cat([res[part][k].double().reshape(-1) for k in keys])


def compare_to_floor(got: dict, ref: dict, reversed_: dict) -> dict:
    """Hold ``got`` against ``ref`` where tensor-by-tensor tolerances do
    not hold for the world-size-1 step itself: at full width, a change of
    the float32 sums' order alone (``reversed_``: ``ref``'s step on the
    batch in reverse order) flips top-k picks, Hungarian matches and, on a
    kernel engine, bf16 roundings, which move single loss terms by ~1e-2
    and single gradient tensors by up to ~1 of their largest element. So
    three global measures: all gradients together and the whole float
    state after the update (relative L2), each within the larger of its
    ``tests/test_torch_train_step.py`` tolerance and twice what the
    reversed batch moves it (sums over millions of elements, which the
    order moves by about the same amount each time), and the total loss
    (relative) within ``LOSS_TOL`` on ``plain`` and ``BF16_ROUNDOFF`` on a
    kernel engine. The loss is one number: on a kernel engine what the
    reversed batch moves it by changes threefold from one call to the
    next, and the same step on the same batch moves it by as much between
    calls, so twice one such reading is no bound (``PERF.md``). Each fault
    of ``FAULTS`` fails it at full width on the card (the card test
    ``test_full_width_two_rank_step_holds_the_floor``). Returns each
    measure, its tolerance and ``ok``."""
    out = {}
    loss_tol = LOSS_TOL if ref["engine"] == "plain" else BF16_ROUNDOFF
    for kind, tol in (("loss", loss_tol), ("grad", GRAD_TOL),
                      ("state", PARAM_TOL)):
        if kind == "loss":
            def err(r):
                return (abs(r["metrics"]["loss"] - ref["metrics"]["loss"])
                        / abs(ref["metrics"]["loss"]))
        else:
            part = "grads" if kind == "grad" else "state"
            keys = [k for k, v in ref[part].items() if v.is_floating_point()
                    and not k.endswith("bev_pos")]
            base = _flat(ref, part, keys)

            def err(r, part=part, keys=keys, base=base):
                return float((_flat(r, part, keys) - base).norm()
                             / base.norm())
        out[kind] = err(got)
        out[f"{kind}_floor"] = err(reversed_)
        out[f"{kind}_tol"] = (tol if kind == "loss"
                              else max(tol, 2 * out[f"{kind}_floor"]))
    out["ok"] = all(out[k] <= out[f"{k}_tol"]
                    for k in ("loss", "grad", "state"))
    return out


def result_path(out: str, engine: str, rank: int,
                fault: Optional[str] = None) -> str:
    return os.path.join(out, f"{engine}{'.' + fault if fault else ''}"
                             f".rank{rank}.pt")


def spawn(n: int, argv: Sequence[str], timeout: float, log_dir: str,
          module: str = MODULE,
          env: Optional[Dict[str, str]] = None) -> List[str]:
    """Start ``n`` ranks of ``python -m <module> <argv>`` (by default this
    module's worker: ``--worker`` goes first) with ``WORLD_SIZE`` /
    ``RANK`` / ``LOCAL_RANK`` set and ``env`` added, each logging to
    ``log_dir/worker<rank>.log``, and wait for all of them; returns the
    logs. A rank that fails, or a run past ``timeout`` seconds, kills every
    rank (the others would wait in a collective forever) and raises with
    the logs' ends."""
    if module == MODULE:
        argv = ["--worker", *argv]
    base = {**os.environ, **(env or {})}
    base["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    procs, logs = [], []
    try:
        for r in range(n):
            logs.append(os.path.join(log_dir, f"worker{r}.log"))
            with open(logs[-1], "w") as fh:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", module, *argv],
                    cwd=str(REPO), stdout=fh, stderr=subprocess.STDOUT,
                    env={**base, "WORLD_SIZE": str(n), "RANK": str(r),
                         "LOCAL_RANK": str(r)}))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        tails = []
        for r in bad:
            with open(logs[r]) as fh:
                tails.append(f"worker {r} (rc {procs[r].returncode}):\n"
                             + fh.read()[-3000:])
        raise RuntimeError(f"data-parallel workers failed or passed "
                           f"{timeout:.0f} s:\n" + "\n".join(tails))
    out = []
    for path in logs:
        with open(path) as fh:
            out.append(fh.read())
    return out


def _device(name: str) -> torch.device:
    """The train CLI's ``resolve_device`` (the card unless 'cpu' is asked
    for, raising without one; float32 without TF32), with the card's
    index made explicit."""
    from .train import resolve_device

    dev = resolve_device(name)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _worker(args) -> None:
    from ..parallel import mesh

    device = _device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(2)
    if not mesh.init_distributed("gloo", args.init_method):
        raise SystemExit("--worker runs under WORLD_SIZE and RANK")
    try:
        with np.load(args.inputs) as f:
            inputs = dict(f)
        for fault in [None] + [f for f in args.plant.split(",") if f]:
            for engine in args.engines.split(","):
                with planted(fault):
                    res = one_step(args.config, engine, inputs,
                                   args.weights_seed, device,
                                   warmup=fault is None
                                   and device.type == "cuda")
                torch.save(res, result_path(args.out, engine, mesh.rank(),
                                            fault))
                if device.type == "cuda":
                    torch.cuda.empty_cache()
    finally:
        mesh.shutdown()


def dryrun(n: int, device: str = "cuda", timeout: float = 600.0) -> float:
    """One step of the tiny config over ``n`` gloo workers on ``device``
    at batch 1 a rank; returns the global loss."""
    from ..configs import get_config

    _device(device)
    cfg = get_config("Tiny_L")["model"]
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(os.path.join(tmp, "inputs.npz"), **step_inputs(
            cfg, seed=0, batch_size=n, n_points=1500, n_boxes=4, max_gts=6))
        spawn(n, ["--init-method", f"file://{tmp}/rendezvous", "--device",
                  device, "--config", "Tiny_L", "--engines", "plain",
                  "--inputs", os.path.join(tmp, "inputs.npz"),
                  "--weights-seed", "0", "--out", tmp], timeout, tmp)
        res = torch.load(result_path(tmp, "plain", 0), weights_only=True)
    return res["metrics"]["loss"]


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n", type=int, nargs="?", default=2,
                   help="processes (default 2)")
    p.add_argument("--worker", action="store_true",
                   help="run as one rank (WORLD_SIZE and RANK set)")
    p.add_argument("--init-method", default="env://")
    p.add_argument("--device", default="cuda",
                   help="every rank's device: the card (default) or cpu")
    p.add_argument("--config", default="Tiny_L")
    p.add_argument("--engines", default="plain",
                   help="comma-separated engines, one step each")
    p.add_argument("--inputs", help="the .npz of step_inputs")
    p.add_argument("--weights-seed", type=int, default=0)
    p.add_argument("--out", help="directory of the results")
    p.add_argument("--plant", default="",
                   help="comma-separated FAULTS, after the clean steps: "
                        "one more step per engine with each")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    if args.worker:
        _worker(args)
        return
    loss = dryrun(args.n, args.device)
    if not np.isfinite(loss):
        raise SystemExit(f"dryrun_ddp({args.n}): loss={loss}")
    print(f"dryrun_ddp({args.n}): loss={loss:.4f} OK")


if __name__ == "__main__":
    main()

"""The comparison that decides ``correct``.

The plain reference (``reference/``, a frozen copy of the port's plain
paths in float32 with TF32 off, importing nothing of the port) works out
again, from the benchmark's own inputs and weights, what the timed path
produced, and each number below is held to its limit in the
configuration's file (``limits``):

Inference, over the kept requests (worst of them):

- ``voxels``: voxel coordinates and slots that differ from the
  reference's voxelization (integers; exact, limit 0);
- ``heatmap``: the dense heatmap logits of every stage, which the whole
  BEV path feeds (encoder, SECOND and neck, the fusion layers; for a
  camera config the camera BEV): worst stage's ||program - reference|| /
  ||reference||;
- ``boxes``: ``get_bboxes``' boxes over every query, each value (centre
  x, y, bottom z, three sizes, two velocities) apart, and the decoder's
  last rotation (its sine and cosine; the yaw that ``get_bboxes`` takes
  from them is ill conditioned where both are small): the median value's
  ||program - reference|| / ||reference||. The median, because with
  random weights the heads of the small values (bottom, velocity,
  rotation) give some seeds a reference norm that makes that value's
  distance several times the rest (PERF.md). The reference's boxes come
  from its own decoder run on the queries the program picked from its
  heatmaps: the picks are discrete, and the reference re-picks from the
  program's logits with the program's own arithmetic, so the distance
  measures the decoder and the decoding, not a near-tie (``calibrate.py``
  counts how many of its own picks differ);
- ``boxes_worst``: the same distance of the worst value, taken per
  scan, of the worst scan (a batch's distance over all its scans would
  hide one scan's fault); a configuration compares it only where the
  control separates from the program on it (PERF.md: on FocalFormer3D_L
  a small velocity or bottom on some seeds lets the program's tail meet
  the control);
- ``labels``: the queries whose class label differs from the reference's
  (integers; exact, limit 0);
- ``scores``: the widest gap between the program's and the reference's
  scores over every query; ``scores_l2``: their relative L2 distance.
  Each configuration's limits name the one that separates the program
  from the control on it.

Training, over the steps the set-up ran (the reference follows them from
the same weights, batches and generator seed, and, as at inference, its
head picks each step's queries from the program's heatmap logits of that
step):

- ``heatmap``: the first step's forward, its dense heatmap logits (batch
  statistics, before any update): worst stage's relative L2 distance;
- ``heat_loss``: the first step's heatmap loss term (no matching, no
  update): |program - reference| / |reference|;
- ``change``: each parameter's change over the steps, the gap between
  the program's norm and the reference's over the larger of the
  reference's norm and the median parameter's: the median parameter's
  gap;
- ``change_worst``: the worst parameter's gap of the same: a parameter
  left unmoved, or moved double, reads 1 on it.

Also computed for ``calibrate.py``, not compared (PERF.md gives their
readings and why): the worst step's total loss (``loss``, which the
Hungarian matching moves by near-ties), and the worst parameter's gap of
the first gradient as the optimizer took it (worked out from its first
moment after one step: ``grad``; ``grad_median``).
Parameters whose reference gradient is under a thousandth of the median
parameter's take no part: their moves under Adam are round-off (a key's
bias under softmax).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from .reference.ff3d.configs import get_config, with_compute_dtype
from .reference.ff3d.models.detector import FocalFormer3D, preprocess_points
from .reference.ff3d.training import optim
from .reference.train import IMG_KEYS, train_step
from .spec import as_run

GRAD_FLOOR = 1e-3
YAW = 6  # the yaw's column in get_bboxes' boxes


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


class Reference:
    """The reference detector of a stated configuration, float32 (or, for
    the control, the given ``dtype`` where the port's modules take one)."""

    def __init__(self, config: dict, device: torch.device,
                 dtype: str = "float32"):
        full = get_config(config["model"])
        cfg = with_compute_dtype(as_run(full["model"], config), dtype)
        self.cfg, self.lcfg, self.recipe = cfg, full["loss"], full["train"]
        self.device = device
        with torch.device(device):
            self.model = FocalFormer3D(cfg)

    def load(self, state: Dict[str, torch.Tensor]) -> None:
        self.model.load_state_dict(state, strict=True)

    def optimizer(self, schedule_steps: int) -> optim.ClipAdamW:
        return self.make_optimizer(self.recipe, schedule_steps)

    @staticmethod
    def schedule_b1(config: dict, traffic: dict) -> float:
        """beta1 of the recipe's first update: the first moment after one
        step is (1 - beta1) times the gradient the optimizer took."""
        tx = Reference.make_optimizer(get_config(config["model"])["train"],
                                      traffic["schedule_steps"])
        return float(tx.b1(0))

    @staticmethod
    def make_optimizer(r, schedule_steps: int) -> optim.ClipAdamW:
        return optim.make_optimizer(
            base_lr=r.base_lr, weight_decay=r.weight_decay,
            total_steps=schedule_steps, grad_clip=r.grad_clip,
            lr_target_ratio=r.lr_target_ratio,
            momentum_target_ratio=r.momentum_target_ratio,
            step_ratio_up=r.step_ratio_up)

    @torch.no_grad()
    def infer(self, scan: Dict[str, torch.Tensor],
              select_heatmaps: Optional[torch.Tensor] = None):
        self.model.eval()
        cfg = self.cfg
        vox = preprocess_points(cfg, scan["points"], scan["points_mask"])
        img = ({k: scan[k] for k in IMG_KEYS} if cfg.input_img else None)
        out = self.model(vox, img_data=img, select_heatmaps=select_heatmaps)
        return vox, out, self.model.get_bboxes(out, 200)


def judge_inference(ref: Reference, scan, vox, out, dec) -> Dict[str, float]:
    """The inference numbers of one kept request (see the module)."""
    r_vox, r_out, r_dec = ref.infer(scan, out["dense_heatmap"].float())
    m, rm = vox["voxel_mask"], r_vox["voxel_mask"]
    coords = torch.where(m[..., None], vox["coords"], -1)
    r_coords = torch.where(rm[..., None], r_vox["coords"], -1)
    voxels = int((m != rm).sum() + (coords != r_coords).any(-1).sum())
    hm, r_hm = out["dense_heatmap"].float(), r_out["dense_heatmap"]
    heatmap = max(rel(hm[:, s], r_hm[:, s]) for s in range(hm.shape[1]))
    b, rb = dec["bboxes"], r_dec["bboxes"]
    rot, r_rot = out["rot"][:, -1], r_out["rot"][:, -1]

    def values(i=slice(None)):
        return [rel(b[i, ..., c], rb[i, ..., c]) for c in range(b.shape[-1])
                if c != YAW] + [rel(rot[i], r_rot[i])]

    per_value = values()
    scores = (dec["scores"].double() - r_dec["scores"].double()).abs()
    labels = int((dec["labels"] != r_dec["labels"]).sum())
    return {"voxels": voxels, "heatmap": heatmap,
            "boxes": float(torch.tensor(per_value).median()),
            "boxes_worst": max(max(values(i)) for i in range(b.shape[0])),
            "labels": labels,
            "scores": float(scores.max()),
            "scores_l2": rel(dec["scores"], r_dec["scores"]),
            "values": per_value}


def picks_differ(forced: torch.Tensor, own: torch.Tensor) -> int:
    """How many of the queries picked (``query_index``, per sample) in one
    run are not among another run's picks."""
    return sum(int((~torch.isin(f, o)).sum()) for f, o in zip(forced, own))


@torch.no_grad()
def own_picks_differ(ref: Reference, scan, out) -> int:
    """At inference: how many of the queries that the reference picks from
    the program's heatmaps (``out``: the program's outputs) it would not
    pick from its own."""
    _, forced, _ = ref.infer(scan, out["dense_heatmap"].float())
    _, own, _ = ref.infer(scan)
    return picks_differ(forced["query_index"], own["query_index"])


@torch.no_grad()
def own_picks_differ_train(ref: Reference, state, batch, step_seed: int,
                           select: torch.Tensor) -> int:
    """In training: the same count on the first step's forward (batch
    statistics, the generator as the step seeds it), ``select`` the
    program's heatmap logits of that step."""
    ref.load(state)
    model = ref.model.train()
    vox = preprocess_points(ref.cfg, batch["points"], batch["points_mask"],
                            train=True)
    img = ({k: batch[k] for k in IMG_KEYS} if ref.cfg.input_img else None)
    picks = []
    for sel in (select, None):
        gen = torch.Generator(device=ref.device)
        gen.manual_seed(step_seed)
        picks.append(model(vox, batch["gt_boxes"], batch["gt_labels"],
                           batch["gt_valid"], gen, img_data=img,
                           select_heatmaps=sel)["query_index"])
    ref.load(state)  # the forwards moved the running statistics
    return picks_differ(*picks)


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    return {k: max(r[k] for r in readings) for k in readings[0]
            if k != "values"}


def reference_steps(ref: Reference, state0, batches, step_seed: int,
                    schedule_steps: int, select: List[torch.Tensor],
                    context=None, half: bool = False):
    """The reference's steps from ``state0`` on ``batches`` with a step
    generator seeded ``step_seed``: per step the loss, the first step's
    clipped gradient and the change of each parameter over the steps.
    ``select``: each step's heatmap logits to pick the queries from (the
    program's). ``context()`` wraps each step (the control's precision);
    ``half`` takes the first half of each batch alone (a planted
    fault)."""
    import contextlib

    ref.load(state0)
    tx = ref.optimizer(schedule_steps)
    state = tx.init(ref.model.named_parameters())
    gen = torch.Generator(device=ref.device)
    gen.manual_seed(step_seed)
    before = {n: p.detach().clone()
              for n, p in ref.model.named_parameters()}
    losses, heat, maps, grad = [], [], [], None
    for batch, pick in zip(batches, select):
        if half:
            n = batch["points"].shape[0] // 2
            batch = {k: v[:n] for k, v in batch.items()}
            pick = pick[:n]
        with (context() if context else contextlib.nullcontext()):
            r = train_step(ref.model, ref.lcfg, tx, state, batch, gen, pick)
        losses.append(r["loss"])
        heat.append(r["loss_heatmap"])
        maps.append(r["dense_heatmap"])
        if grad is None:
            grad = r["grad"]
    named = dict(ref.model.named_parameters())
    change = {n: named[n].detach() - before[n] for n in state.names}
    return {"loss": losses, "loss_heatmap": heat, "picks": maps,
            "grad": grad, "change": change}


def gaps(prog: dict, ref_run: dict, key: str) -> Dict[str, float]:
    """Per parameter that the reference's first gradient moves (see the
    module), the gap of ``key`` (``grad`` or ``change``): |program's norm
    - reference's| over the larger of the reference's norm and the median
    parameter's."""
    gn = {n: float(g.double().norm()) for n, g in ref_run["grad"].items()}
    med = float(torch.tensor(list(gn.values())).median())
    moved = [n for n, v in gn.items() if v >= GRAD_FLOOR * med]
    ref_n = {n: float(ref_run[key][n].double().norm()) for n in moved}
    med_n = float(torch.tensor(list(ref_n.values())).median())
    return {n: abs(float(prog[key][n].double().norm()) - ref_n[n])
            / max(ref_n[n], med_n) for n in moved}


def judge_train(prog: dict, ref_run: dict) -> Dict[str, float]:
    """The training numbers (see the module) of a run's readings (the
    program's, or a control's) against the reference's."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"],
                                                  ref_run["loss"]))

    def rel_gap(p, r):
        return abs(p - r) / abs(r)

    g = torch.tensor(list(gaps(prog, ref_run, "grad").values()),
                     dtype=torch.float64)
    c = torch.tensor(list(gaps(prog, ref_run, "change").values()),
                     dtype=torch.float64)
    hm, r_hm = prog["picks"][0], ref_run["picks"][0]
    n = min(hm.shape[0], r_hm.shape[0])  # a half batch's fault has fewer
    heatmap = max(rel(hm[:n, s], r_hm[:n, s]) for s in range(hm.shape[1]))
    return {"heatmap": heatmap,
            "heat_loss": rel_gap(prog["loss_heatmap"][0],
                                 ref_run["loss_heatmap"][0]),
            "change": float(c.median()), "loss": loss,
            "grad": float(g.max()), "grad_median": float(g.median()),
            "change_worst": float(c.max())}


@torch.no_grad()
def occupancy(ref: Reference, scan, train: bool = False) -> List[list]:
    """Per sample and level of the sparse encoder: [level, active voxels,
    capacity, voxels the capacity dropped]; level L0 is the voxelizer's
    cap (the test-time cap, or the training cap with ``train``), the
    others the levels the encoder builds sparse before its dense
    boundary."""
    from .reference.ff3d.models.sparse_encoder import Level
    from .reference.ff3d.ops import sparse_conv as sc
    from .reference.ff3d.ops.voxelize import point_voxel_coords

    cfg = ref.cfg
    vcfg = cfg.voxel
    cap = vcfg.max_voxels if train else (vcfg.max_voxels_test
                                         or vcfg.max_voxels)
    vox = preprocess_points(cfg, scan["points"], scan["points_mask"],
                            train=train)
    enc = ref.model.pts_middle_encoder
    bound = cfg.sparse_dense_from if train else cfg.sparse_dense_from_eval
    rows = []
    for b in range(scan["points"].shape[0]):
        c, ok = point_voxel_coords(vcfg, scan["points"][b],
                                   scan["points_mask"][b])
        occupied = torch.unique(c[ok], dim=0).shape[0]
        valid = vox["voxel_mask"][b:b + 1]
        lvl = Level.from_voxels(vox["coords"][b:b + 1], valid,
                                enc.sparse_shape)
        out = [["L0", int(valid.sum()), cap, max(occupied - cap, 0)]]
        for i in range(min(bound, len(enc.capacities)) - 1):
            pad = enc.down_paddings[i]
            o = sc.build_downsample(lvl.coords[0], lvl.valid[0], lvl.shape,
                                    3, 2, pad, enc.capacities[i + 1])
            lvl = Level(o[2], o[1][None], o[4][None], o[0][None])
            out.append([f"L{i + 1}", int(o[1].sum()), enc.capacities[i + 1],
                        int(o[3])])
        rows.append(out)
    return rows

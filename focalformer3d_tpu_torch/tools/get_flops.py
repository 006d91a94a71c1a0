"""Parameters, forward FLOPs and bytes of a model on one scan.

Port of ``tools/get_flops.py`` (the counterpart of the reference's
tools/analysis_tools/get_flops.py). The JAX tool reads XLA's cost model of
the compiled forward; the port has no compiler cost model, so it counts
the forward as it runs, ``preprocess_points`` through the model, on the
JAX tool's input (``data/synthetic.make_batch(RandomState(0))``, batch 1,
``--n-points`` points, with the config's cameras for a camera config) and
random weights (only shapes matter):

    python -m focalformer3d_tpu_torch.tools.get_flops FocalFormer3D_L
    python -m focalformer3d_tpu_torch.tools.get_flops FocalFormer3D_L \\
        --engine cuda_mxu --repeat 5

It prints the JAX tool's five lines (``config:``, ``params:``, ``forward
flops:``, ``bytes accessed:``, ``arithmetic intensity``), then one JSON
line with the exact integers. The count has five parts:

- ``dense``: every torch op outside the sparse convs and K2. FLOPs from
  ``torch.utils.flop_counter.FlopCounterMode`` (matmuls, convolutions,
  attention: two per multiply-add; elementwise ops count none); bytes by
  XLA's definition of "bytes accessed", each op's tensor operands (each
  once) plus its outputs, from a dispatch mode of this module
  (``ByteCounter``). Views and other aliasing ops, and allocations that
  write nothing (``empty``), count no bytes.
- ``sparse_conv``: each sparse conv of the encoder counted from its
  rulebook, per level (a conv belongs to the level it reads; ``conv_out``
  apart): FLOPs 2 x hits x C_in x C_out, a hit being a rule that reads an
  input row at a valid output site; bytes by ``_common.conv_bytes_flops``
  (each operand read once, the output written once). On ``cuda_zrun`` the
  hits are counted on the absolute rulebook that the level's z-run codes
  encode, so a level counts the same on every engine.
- ``plan_rules``: K2's rulebooks on ``cuda`` and ``cuda_mxu``, bytes by
  ``_common.rulebook_bytes`` (K2 does no arithmetic).
- ``index_build``: the kernel engines' column tables and strided output
  sets (``plan_builder_cuda.index_table`` and ``index_downsample``), their
  inputs read once and outputs written once (integer work, no FLOPs).
- ``local_attn``: the ``bevfusion`` fusion layers' local attention
  (``ops/local_attn``): FLOPs 4 x C x k^2 a position (two per
  multiply-add of the logits and of the weighted sum), bytes q, k and v
  read once and the output written once.

One scan counts the same on the card and the CPU but for what PyTorch
itself runs on one device only: on the CPU ``F.one_hot`` checks its
input's range (an ``aten.min``, an ``aten.max`` and two
``aten._local_scalar_dense``), which on the card it skips; the decoder's
one-hot calls add those to a count on the CPU. ``count_differs`` holds
two reports of one scan, the card's and the CPU's, to that
(``tests/test_torch_cuda.py::test_get_flops_on_card_counts_as_the_cpu``).

Both counting modes are suspended inside each conv
(``SparseEncoder._sparse_conv``, weight folding included), inside K2
(``plan_rules``), inside the index build's tables and output sets and
inside the local attention:
whatever runs there, the kernels on the card or their plain versions on
the CPU, counts as the function, so one scan counts the same on both
devices. ``--repeat N`` times N more forwards after the counted one
(nothing counted; host clock around each, ending in a synchronise) and
reports their median as ``forward_ms``.

It runs on the card unless ``--device cpu`` is given (TF32 off), and
raises where there is none.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import statistics
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from . import _common
from .train import load_config, resolve_device

IMG_KEYS = ("imgs", "lidar2img", "img_aug", "bev_aug")
# ops that alias their input or allocate without writing: no bytes
NO_BYTES = {"aten._unsafe_view", "aten.empty", "aten.empty_like",
            "aten.empty_strided", "aten.new_empty",
            "aten.new_empty_strided"}
# what PyTorch runs for one forward on the CPU alone: F.one_hot checks its
# classes' range there (a min, a max and two item()s a call), not on a card
CPU_ONLY_OPS = ("aten.min", "aten.max", "aten._local_scalar_dense")


def _aliases(func) -> bool:
    """True for a view or another op whose outputs alias an input without
    writing it."""
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _nbytes(tensors) -> int:
    seen, total = set(), 0
    for t in tensors:
        if isinstance(t, torch.Tensor) and id(t) not in seen:
            seen.add(id(t))
            total += t.numel() * t.element_size()
    return total


class ByteCounter(TorchDispatchMode):
    """Bytes accessed per op: its tensor operands' bytes (each tensor
    once) plus its outputs' bytes; views, aliasing ops and ``NO_BYTES``
    count none. ``by_op`` holds per op name [calls, bytes]."""

    def __init__(self):
        super().__init__()
        self.by_op: Dict[str, List[int]] = defaultdict(lambda: [0, 0])

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = str(func.overloadpacket)
        row = self.by_op[name]
        row[0] += 1
        if name not in NO_BYTES and not _aliases(func):
            row[1] += (_nbytes(tree_flatten((args, kwargs))[0])
                       + _nbytes(tree_flatten(out)[0]))
        return out


class Count:
    """The counting modes and the sparse parts of one forward."""

    def __init__(self):
        self.flops = FlopCounterMode(display=False)
        self.bytes = ByteCounter()
        self.levels: Dict[str, Dict[str, int]] = {}
        self.plan = {"calls": 0, "bytes": 0}
        self.index = {"calls": 0, "bytes": 0}
        self.local_attn = {"calls": 0, "flops": 0, "bytes": 0}

    def __enter__(self):
        self.flops.__enter__()
        self.bytes.__enter__()
        return self

    def __exit__(self, *exc):
        self.bytes.__exit__(*exc)
        self.flops.__exit__(*exc)

    def add_conv(self, level: str, x, rules, w, out_valid) -> None:
        nbytes, flops, hits = _common.conv_bytes_flops(x, rules, w,
                                                       out_valid)
        row = self.levels.setdefault(
            level, {"convs": 0, "hits": 0, "flops": 0, "bytes": 0})
        row["convs"] += 1
        row["hits"] += hits
        row["flops"] += flops
        row["bytes"] += nbytes

    def report(self) -> dict:
        flop_ops = {str(k): int(v) for k, v in
                    self.flops.get_flop_counts().get("Global", {}).items()}
        seen = self.bytes.by_op
        by_op = {}
        for name in sorted(set(seen) | set(flop_ops)):
            calls, nbytes = seen.get(name, (0, 0))
            by_op[name] = [calls, flop_ops.get(name, 0), nbytes]
        dense = {"flops": int(self.flops.get_total_flops()),
                 "bytes": sum(r[2] for r in by_op.values()),
                 "by_op": by_op}
        sparse = {"flops": sum(r["flops"] for r in self.levels.values()),
                  "bytes": sum(r["bytes"] for r in self.levels.values()),
                  "convs": sum(r["convs"] for r in self.levels.values()),
                  "levels": dict(sorted(self.levels.items()))}
        return {"flops": dense["flops"] + sparse["flops"]
                + self.local_attn["flops"],
                "bytes": dense["bytes"] + sparse["bytes"]
                + self.plan["bytes"] + self.index["bytes"]
                + self.local_attn["bytes"],
                "dense": dense, "sparse_conv": sparse,
                "plan_rules": dict(self.plan),
                "index_build": dict(self.index),
                "local_attn": dict(self.local_attn)}


def _conv_levels(enc) -> Dict[int, str]:
    """id of each sparse conv's weight module -> the level it reads: L0
    for conv_input, L<s> for stage s's convs (its strided conv included),
    conv_out apart."""
    from ..models.sparse_encoder import SpConvWeight

    out = {}
    for name, mod in enc.named_modules():
        if not isinstance(mod, SpConvWeight):
            continue
        if name.startswith("conv_input"):
            out[id(mod)] = "L0"
        elif name.startswith("conv_out"):
            out[id(mod)] = "conv_out"
        else:
            stage = name.split(".")[1]  # encoder_layers.encoder_layer<s+1>
            out[id(mod)] = f"L{int(stage[len('encoder_layer'):]) - 1}"
    return out


@contextlib.contextmanager
def observed(model, count: Count):
    """Route the encoder's sparse convs, K2, the index build's tables and
    output sets and the fusion layers' local attention through ``count``:
    each counted from its operands, then run with both counting modes
    off."""
    from ..models import focal_encoder as fe

    attn = fe.local_attention

    def local_attention(q, k, v, kernel_size=9):
        with _disable_current_modes():
            out = attn(q, k, v, kernel_size)
            count.local_attn["calls"] += 1
            count.local_attn["flops"] += 4 * q.numel() * kernel_size ** 2
            count.local_attn["bytes"] += _nbytes([q, k, v, out])
            return out

    fe.local_attention = local_attention
    try:
        with _observed_encoder(model, count):
            yield
    finally:
        fe.local_attention = attn


@contextlib.contextmanager
def _observed_encoder(model, count: Count):
    from ..models import sparse_encoder as se
    from ..ops.sparse_conv_zrun import zrun_rules

    enc = getattr(model, "pts_middle_encoder", None)
    if enc is None:  # a camera-only config has no sparse conv
        yield
        return
    levels = _conv_levels(enc)
    conv, k2 = enc._sparse_conv, se.plan_rules
    table, down = se.index_table, se.index_downsample

    def sparse_conv(x, index, wmod, bn, valid, engine, bwd=None):
        with _disable_current_modes():
            rules = (zrun_rules(index, x.shape[1]) if engine == "cuda_zrun"
                     else index)
            w = wmod.weight.reshape(-1, *wmod.weight.shape[-2:])
            count.add_conv(levels[id(wmod)], x, rules, w, valid)
            return conv(x, index, wmod, bn, valid, engine, bwd)

    def plan_rules(meta, colz, *args):
        with _disable_current_modes():
            rules = k2(meta, colz, *args)
            count.plan["calls"] += 1
            count.plan["bytes"] += _common.rulebook_bytes(meta, colz, rules)
            return rules

    def index_table(coords, valid, *args):
        with _disable_current_modes():
            meta = table(coords, valid, *args)
            count.index["calls"] += 1
            count.index["bytes"] += _nbytes([coords, valid, meta])
            return meta

    def index_downsample(coords, valid, *args):
        with _disable_current_modes():
            out = down(coords, valid, *args)
            count.index["calls"] += 1
            count.index["bytes"] += _nbytes([coords, valid, *out[:2],
                                             *out[3:]])
            return out

    enc._sparse_conv = sparse_conv
    se.plan_rules = plan_rules
    se.index_table, se.index_downsample = index_table, index_downsample
    try:
        yield
    finally:
        del enc._sparse_conv
        se.plan_rules = k2
        se.index_table, se.index_downsample = table, down


def make_inputs(cfg, n_points: int, device: torch.device):
    """The JAX tool's batch: (points, points_mask, camera inputs or
    None), on ``device``."""
    from ..data import synthetic

    batch = synthetic.make_batch(
        np.random.RandomState(0), batch_size=1, n_points=n_points,
        n_boxes=16, max_gts=32, num_classes=cfg.decoder.num_classes,
        pc_range=cfg.voxel.point_cloud_range, with_images=cfg.input_img,
        img_hw=cfg.lss.img_scale)
    t = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    img = {k: t[k] for k in IMG_KEYS} if cfg.input_img else None
    return t["points"], t["points_mask"], img


def build_model(cfg, device: torch.device):
    from ..models.detector import FocalFormer3D
    from ..utils.ref_keys import make_fake_state_dict

    model = FocalFormer3D(cfg).eval()
    model.load_state_dict(make_fake_state_dict(model, seed=0), strict=True)
    return model.to(device)


def count_params(model) -> int:
    """Parameters, as the JAX tool counts its ``params`` collection (batch
    norm statistics are buffers here, ``batch_stats`` there)."""
    return sum(p.numel() for p in model.parameters())


def forward(model, cfg, points, mask, img):
    from ..models.detector import preprocess_points

    vox = preprocess_points(cfg, points, mask) if cfg.input_pts else None
    return model(vox, img_data=img)


def count_forward(model, cfg, points, mask, img) -> dict:
    """One forward, counted: the ``Count.report`` dict."""
    with torch.no_grad(), Count() as count, observed(model, count):
        forward(model, cfg, points, mask, img)
    return count.report()


def time_forward(model, cfg, points, mask, img, repeat: int
                 ) -> Optional[float]:
    """Median ms of ``repeat`` forwards, each by host clock ending in a
    synchronise on a card; None for 0."""
    times = []
    with torch.no_grad():
        for _ in range(repeat):
            t0 = time.perf_counter()
            out = forward(model, cfg, points, mask, img)
            if points.is_cuda:
                torch.cuda.synchronize(points.device)
            times.append((time.perf_counter() - t0) * 1e3)
            del out
    return statistics.median(times) if times else None


def count_differs(card: dict, cpu: dict):
    """What differs between two reports of one scan, the card's and the
    CPU's: the totals, each dense op by name ([calls, FLOPs, bytes]), each
    sparse level, K2, the index build, the local attention; the ops of
    ``CPU_ONLY_OPS`` that only the CPU's count holds are set apart and
    must be ``F.one_hot``'s range check (a min and a max a call, two
    item()s). Returns (what differs, the CPU-only ops' rows)."""
    ops_a, ops_b = card["dense"]["by_op"], cpu["dense"]["by_op"]
    only = {op: ops_b[op] for op in CPU_ONLY_OPS
            if op in ops_b and op not in ops_a}
    out = [] if card["flops"] == cpu["flops"] else ["flops"]
    if card["bytes"] != cpu["bytes"] - sum(r[2] for r in only.values()):
        out.append("bytes")
    out += [f"{op} {ops_a.get(op)} against {ops_b.get(op)}"
            for op in sorted(set(ops_a) | set(ops_b))
            if op not in only and ops_a.get(op) != ops_b.get(op)]
    calls = {op: only.get(op, [0])[0] for op in CPU_ONLY_OPS}
    if only and not (calls["aten.min"] == calls["aten.max"] > 0 and
                     calls["aten._local_scalar_dense"]
                     == 2 * calls["aten.min"]):
        out.append(f"CPU-only ops {only} are not one_hot's range check")
    for part in ("sparse_conv", "plan_rules", "index_build", "local_attn"):
        if card.get(part) != cpu.get(part):
            out.append(part)
    return out, only


def parse_args(argv: Optional[List[str]] = None):
    from ..models.sparse_encoder import ENGINES

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("config", nargs="?", default="FocalFormer3D_L")
    p.add_argument("--n-points", type=int, default=200000)
    p.add_argument("--engine", default="auto", choices=ENGINES,
                   help="sparse engine (auto: cuda on a card, plain on "
                        "the CPU)")
    p.add_argument("--repeat", type=int, default=0,
                   help="forwards timed after the counted one (0: none)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default: the card, raises without one) "
                        "or 'cpu'")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = dataclasses.replace(load_config(args.config)["model"],
                              sparse_engine=args.engine)
    model = build_model(cfg, device)
    points, mask, img = make_inputs(cfg, args.n_points, device)
    rep = {"config": args.config, "device": device.type,
           "engine": args.engine, "n_points": args.n_points,
           "params": count_params(model),
           **count_forward(model, cfg, points, mask, img)}
    rep["forward_ms"] = time_forward(model, cfg, points, mask, img,
                                     args.repeat)
    flops, bytes_ = rep["flops"], rep["bytes"]
    print(f"config: {args.config}")
    print(f"params: {rep['params'] / 1e6:.2f} M")
    print(f"forward flops: {flops / 1e9:.2f} GFLOPs")
    print(f"bytes accessed: {bytes_ / 1e9:.2f} GB")
    print(f"arithmetic intensity: {flops / max(bytes_, 1):.1f} flop/byte")
    print(json.dumps(rep))
    return rep


if __name__ == "__main__":
    main()

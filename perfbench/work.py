"""The model's work on given inputs, counted by the benchmark itself.

Operations and bytes come from the reference's forward, never from a count
the port makes, so they are the same whatever engine or kernel the port
runs:

- each conv of the sparse encoder at its active rulebook pairs: pairs x
  Cin x Cout x 2 operations (the levels that the reference, like the port,
  runs dense are counted from their masks as the sparse convs they stand
  for); its bytes are each input row, weight and output row read or
  written once, two bytes an element (the encoder computes in bfloat16);
- every other product (matmul, conv, attention) at its shapes, by
  ``torch.utils.flop_counter.FlopCounterMode`` over the reference forward,
  attributed to the module it ran in.

A training step is three forwards' operations: each product's backward is
a gradient of its input and one of its weight, each as costly as the
product, but for the first sparse conv, whose input (the voxel features)
takes no gradient.

Each part's operations are divided by the peak of the precision that the
configuration states for it (``peaks.json``), so ``seconds_at_peak`` is the
least time the chip could take for the work.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

import torch
from torch.utils.flop_counter import FlopCounterMode

from .reference.ff3d.models import sparse_encoder as ref_encoder

PEAKS = json.loads((Path(__file__).parent / "peaks.json").read_text())
ENC = "pts_middle_encoder"
ROOT = "FocalFormer3D"


def peaks(device_name: str) -> Dict[str, float]:
    """The published peaks of the named card; KeyError for another."""
    return PEAKS[device_name]


def encoder_work(work: List[tuple]) -> Dict[str, float]:
    """Operations and bytes of the recorded encoder convs, by kind."""
    out = {"sparse_flops": 0.0, "dense_flops": 0.0, "bytes": 0.0,
           "first_flops": 0.0}
    for i, (kind, pairs, taps, cin, cout, rows_in, rows_out) in \
            enumerate(work):
        flops = 2.0 * float(pairs) * cin * cout
        out[f"{kind}_flops"] += flops
        if i == 0:
            out["first_flops"] = flops
        out["bytes"] += 2.0 * (float(rows_in) * cin + taps * cin * cout
                               + float(rows_out) * cout)
    return out


def _part(module: str, precision: Dict[str, str]) -> str:
    """The precision of a module: the longest prefix that the map names,
    else its default ``*``."""
    best = ""
    for prefix in precision:
        if prefix != "*" and (module == prefix
                              or module.startswith(prefix + ".")):
            best = max(best, prefix, key=len)
    return precision[best or "*"]


def count(model: torch.nn.Module, run, precision: Dict[str, str],
          device_name: str, train: bool = False) -> Dict[str, float]:
    """Count ``run()`` (a reference forward of ``model``) under the
    precision map (module prefix -> dtype name; ``*`` the default; the
    encoder's convs by ``sparse_convs`` and ``dense_convs`` when named).
    Returns the operations, the encoder's operations and bytes, and
    ``seconds_at_peak``."""
    pk = peaks(device_name)
    counter = FlopCounterMode(display=False)
    ref_encoder.WORK = []
    try:
        with torch.no_grad(), counter:
            run()
        enc = encoder_work(ref_encoder.WORK)
    finally:
        ref_encoder.WORK = None
    counts = counter.get_flop_counts()
    flops: Dict[str, float] = {}
    # each module's own products: its count less its children's
    own = {k: float(sum(v.values())) for k, v in counts.items()
           if k.startswith(ROOT + ".")}
    for name, total in own.items():
        rel = name[len(ROOT) + 1:]
        child = sum(v for k, v in own.items()
                    if k.startswith(name + ".") and "." not in
                    k[len(name) + 1:])
        dt = _part(rel, precision)
        flops[dt] = flops.get(dt, 0.0) + total - child
    top = float(sum(counts.get(ROOT, {}).values()))
    rest = top - sum(v for k, v in own.items()
                     if "." not in k[len(ROOT) + 1:])
    flops[precision["*"]] = flops.get(precision["*"], 0.0) + rest
    sparse_dt = precision.get("sparse_convs", _part(ENC, precision))
    dense_dt = precision.get("dense_convs", _part(ENC, precision))
    flops[sparse_dt] = flops.get(sparse_dt, 0.0) + enc["sparse_flops"]
    flops[dense_dt] = flops.get(dense_dt, 0.0) + enc["dense_flops"]
    if train:
        flops = {k: 3.0 * v for k, v in flops.items()}
        flops[sparse_dt] -= enc["first_flops"]
    return {"flops": sum(flops.values()), "flops_by_dtype": flops,
            "seconds_at_peak": sum(v / pk[k] for k, v in flops.items()),
            "encoder_flops": enc["sparse_flops"] + enc["dense_flops"],
            "encoder_bytes": enc["bytes"],
            "encoder_seconds_at_peak": max(
                (enc["sparse_flops"] + enc["dense_flops"]) / pk["bfloat16"],
                enc["bytes"] / pk["hbm_bytes_per_s"])}

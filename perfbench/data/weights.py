"""Seeded reference-format weights, made on the device.

The keys and shapes are the model's state dict (the port's detector and
the reference's copy have the same). Every leaf is drawn with one
``torch.Generator`` on the model's device, in two calls: batch-norm
running variances U(0.5, 2), counters 100, running means and biases
N(0, 0.1), the scales of normalisation layers (1-D ``weight``) 1 +
N(0, 0.1), and every product's weight N(0, 1 / fan-in). That is the
port's ``utils/ref_keys.make_fake_state_dict`` with two changes, for one
reason: there every leaf is N(0, 0.1), so each of the encoder's 21 convs
with its batch norm scales its input by about 0.2, the encoder's output
is its last biases whatever the scan, and a check of the BEV path could
not see the encoder at all. Here a conv keeps its input's scale, so the
boxes depend on the points. Leaves are filled in sorted key order, so one
seed gives one set of weights.
"""
from __future__ import annotations

from typing import Dict

import torch


def _fan_in(key: str, shape: torch.Size) -> int:
    """The inputs each output of a weight sums: the sparse convs' weights
    are (kz, ky, kx, in, out), every other (out, in, ...)."""
    n = shape.numel()
    return n // shape[-1] if len(shape) == 5 else n // shape[0]


def make_state_dict(shapes: Dict[str, torch.Size], seed: int,
                    device: torch.device) -> Dict[str, torch.Tensor]:
    """Float32 leaves (int64 counters) for ``shapes`` (key -> shape)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    keys = sorted(shapes)
    var = [k for k in keys if k.endswith("running_var")]
    normal = [k for k in keys if not k.endswith(("running_var",
                                                 "num_batches_tracked"))]
    sizes = [shapes[k].numel() for k in normal]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for k, part in zip(normal, torch.split(flat, sizes)):
        shape = shapes[k]
        if len(shape) >= 2:
            part = part / _fan_in(k, shape) ** 0.5
        elif k.endswith(".weight"):
            part = 1.0 + 0.1 * part
        else:
            part = 0.1 * part
        out[k] = part.view(shape)
    sizes = [shapes[k].numel() for k in var]
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 1.5 + 0.5
    for k, part in zip(var, torch.split(flat, sizes)):
        out[k] = part.view(shapes[k])
    for k in keys:
        if k.endswith("num_batches_tracked"):
            out[k] = torch.tensor(100, dtype=torch.int64, device=device)
    return out

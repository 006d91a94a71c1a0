"""Random reference-format weights for a port model.

Counterpart of ``focalformer3d_tpu.utils.ref_keys.make_fake_state_dict``
that needs no JAX package: the port's modules are named by the reference
checkpoint's keys, so the model's own state dict lists every key and shape.
The draws are the same ``numpy.random.RandomState`` calls in the same key
order, so both functions give equal arrays for one config and seed.
"""
from __future__ import annotations

import re
from typing import Dict, List

import numpy as np
import torch
from torch import nn

# the head's per-round modules, listed round by round in the reference
_PER_ROUND = ("decoder", "pos_embed_learned", "prediction_heads")


# module lists that the reference lists element by element, interleaved:
# (regex with the parent, the list's index and the rest; the lists in order)
_INTERLEAVED = (
    (re.compile(r"(img_neck)\.(lateral_convs|fpn_convs)\.(\d+)\..*"),
     ("lateral_convs", "fpn_convs")),
    (re.compile(r"(.*\.P_IML)\.(query_project|key_project)\.(\d+)\..*"),
     ("query_project", "key_project")),
)


def reference_key_order(model: nn.Module) -> List[str]:
    """The model's state-dict keys in the reference listing's order.

    That is the model's own order with three changes: the head's per-round
    modules come round by round (decoder.r, pos_embed_learned.r,
    prediction_heads.r) where torch lists each ModuleList whole; FPN's
    lateral and output convs, and a local-attention block's query and key
    projections, come element by element (lateral_convs.i, fpn_convs.i);
    and the head's ``bev_pos`` buffer comes last where torch lists a
    module's own buffers before its children's."""
    keys = list(model.state_dict())

    def per_round(k):
        p = k.split(".")
        return p[0] == "pts_bbox_head" and p[1] in _PER_ROUND

    first = next((i for i, k in enumerate(keys) if per_round(k)), 0)
    group_start: Dict[str, int] = {}
    for i, k in enumerate(keys):
        for pat, _ in _INTERLEAVED:
            g = pat.fullmatch(k)
            if g:
                group_start.setdefault(g.group(1), i)

    def rank(ik):
        i, k = ik
        if k.endswith(".bev_pos"):
            return (len(keys), 0, 0, i)
        if per_round(k):
            p = k.split(".")
            return (first, int(p[2]), _PER_ROUND.index(p[1]), i)
        for pat, lists in _INTERLEAVED:
            g = pat.fullmatch(k)
            if g:
                return (group_start[g.group(1)], int(g.group(3)),
                        lists.index(g.group(2)), i)
        return (i, 0, 0, 0)

    return [k for _, k in sorted(enumerate(keys), key=rank)]


def make_fake_state_dict(model: nn.Module,
                         seed: int = 0) -> Dict[str, torch.Tensor]:
    """Random-valued state dict for ``model`` (CPU tensors), loadable with
    ``strict=True``: batch-norm running variances U(0.5, 2), counters 100,
    everything else N(0, 0.1)."""
    rng = np.random.RandomState(seed)
    own = model.state_dict()
    out = {}
    for k in reference_key_order(model):
        shape = tuple(own[k].shape)
        if k.endswith("num_batches_tracked"):
            v = np.asarray(100, np.int64)
        elif k.endswith("running_var"):
            v = rng.uniform(0.5, 2.0, shape).astype(np.float32)
        else:
            v = rng.normal(0, 0.1, shape).astype(np.float32)
        out[k] = torch.from_numpy(v)
    return out

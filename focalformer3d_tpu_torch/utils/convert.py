"""Weight bridge between the JAX package's flax variables and the port.

The port's modules are named by the reference checkpoint's keys, so a
reference-format state dict (``utils/ref_keys.make_fake_state_dict`` or a
converted release) loads with ``load_state_dict(..., strict=True)`` as it
is; spconv weights keep their (kz, ky, kx, I, O) layout and are reshaped to
(K, I, O) at call time.

``from_jax_variables`` (and ``from_flax``, for any set of reference keys,
such as one submodule's) goes the other way round from the JAX package's
``convert_tree``: it inverts ``build_mapping`` and its ``t2f_*`` layout
transforms (the port's copy in ``utils/jax_keys.py``). Every transform is a
pure rearrangement (transpose, flip, reshape, slice), so instead of writing
each inverse by hand it pushes an index array through the forward transform
and scatters the flax values back to the positions they came from; a key
whose elements are not all covered raises.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from .jax_keys import absent, build_mapping, reference_state_shapes


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    out = {}
    for k, v in tree.items():
        key = prefix + (str(k),)
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def from_flax(variables: Mapping[str, Any],
              shapes: Dict[str, Tuple[int, ...]]) -> Dict[str, torch.Tensor]:
    """Flax variables (``{"params": ..., "batch_stats": ...}``) -> the
    tensors of the reference keys ``shapes`` ({key: shape}), through
    ``build_mapping``. A key with no mapping (an unlearned buffer) is
    returned as zeros; a mapped key whose elements the variables do not
    all cover raises."""
    mapping = build_mapping(shapes)
    flat = _flatten(variables)
    sd = {}
    for key, shape in shapes.items():
        if key not in mapping:
            dtype = torch.int64 if key.endswith("num_batches_tracked") else \
                torch.float32
            sd[key] = torch.zeros(shape, dtype=dtype)
            continue
        n = int(np.prod(shape, dtype=np.int64))
        idx = np.arange(n).reshape(shape)
        w = np.zeros(n, np.float32)
        seen = np.zeros(n, bool)
        for coll, path, tf in mapping[key]:
            val = flat.get((coll,) + tuple(path))
            src = tf(idx) if tf is not None else idx
            if val is None or val.shape != src.shape:
                continue
            w[src.ravel()] = val.ravel()
            seen[src.ravel()] = True
        if not seen.all():
            raise KeyError(f"flax variables do not cover {key} {shape}")
        sd[key] = torch.from_numpy(w.reshape(shape))
    return sd


def from_jax_variables(variables: Mapping[str, Any],
                       cfg) -> Dict[str, torch.Tensor]:
    """Flax variables of the JAX package's ``FocalFormer3D``
    (``{"params": ..., "batch_stats": ...}`` as numpy arrays) -> the port's
    state dict for the same ``cfg``. Buffers that carry no learned state
    (``num_batches_tracked``, ``bev_pos``, the LSS ``frustum``) are
    returned as zeros; keys of a branch the model does not build
    (``jax_keys.absent``) are left out."""
    return from_flax(variables, {
        k: v for k, v in reference_state_shapes(cfg).items()
        if not absent(cfg, k)})

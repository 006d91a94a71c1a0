"""Turn a reference-format ``.pth`` checkpoint into a checkpoint of the port.

Port of ``tools/convert_checkpoint.py``. The port's modules carry the
reference checkpoint's key names, so converting is checking: every key of
the config's inventory (the model's state dict, in the order of
``utils/ref_keys.reference_key_order``) is looked up in the ``.pth``'s
``state_dict`` with its shape, and the result is written as
``out_dir/state.pt`` in the layout of ``training/checkpoint.py`` (no
optimizer state, step 0), which the test CLI's ``--checkpoint`` and the
train CLI's ``--load-from`` read:

    python -m focalformer3d_tpu_torch.tools.convert_checkpoint \\
        FocalFormer3D_L ref.pth work_dirs/ff3d_l_ref [--require-full]

A key the ``.pth`` lacks, or has with another shape, is written as zeros (as
the JAX tool leaves a flax leaf it cannot fill at zero), and a key the
inventory lacks is dropped; the summary counts both. A key of a branch the
reference builds and the config's model does not (the point branch of the
camera-only ``DeformFormer3D_C_R50``, ``utils/jax_keys.absent``) is skipped, as
the JAX tool skips it. Buffers that carry no learned state (batch-norm
counters, the head's ``bev_pos``, the LSS ``frustum``) are not required.
``--require-full`` exits with an error, writing nothing, if a key is missing,
extra or of another shape.
"""
from __future__ import annotations

import argparse
import dataclasses
import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch


@dataclasses.dataclass
class Report:
    """The keys of one conversion: taken from the ``.pth``; required and
    missing; present with another shape (key, its shape, the inventory's);
    in the ``.pth`` but not in the inventory; not required and missing;
    of a branch the model does not build."""

    loaded: List[str]
    missing: List[str]
    mismatched: List[Tuple[str, tuple, tuple]]
    unexpected: List[str]
    defaulted: List[str]
    skipped: List[str] = dataclasses.field(default_factory=list)

    @property
    def full(self) -> bool:
        return not (self.missing or self.mismatched or self.unexpected)

    def summary(self) -> str:
        def head(keys):
            return ", ".join(map(str, keys[:5])) + (
                " ..." if len(keys) > 5 else "")

        lines = [f"loaded {len(self.loaded)} tensors; {len(self.missing)} "
                 f"missing, {len(self.mismatched)} of another shape, "
                 f"{len(self.unexpected)} not in the inventory, "
                 f"{len(self.defaulted)} unlearned buffers defaulted, "
                 f"{len(self.skipped)} skipped (module absent)"]
        for name, keys in (("missing", self.missing),
                           ("another shape", self.mismatched),
                           ("not in the inventory", self.unexpected)):
            if keys:
                lines.append(f"  {name}: {head(keys)}")
        return "\n".join(lines)


def load_reference_state(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of a ``.pth``'s ``state_dict`` (or of the file itself
    where it is a bare state dict). Loaded with ``weights_only=True``: a
    checkpoint that needs arbitrary unpickling is refused."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("state_dict", ckpt)
    return {k: v for k, v in sd.items() if torch.is_tensor(v)}


def convert(config: str, pth: str, out_dir: str,
            require_full: bool = False) -> Report:
    """Convert ``pth`` for the named config into ``out_dir/state.pt``."""
    from ..configs import get_config
    from ..models.detector import FocalFormer3D
    from ..training.checkpoint import STATE_FILE
    from ..utils.jax_keys import IGNORED, absent
    from ..utils.ref_keys import reference_key_order

    cfg = get_config(config)["model"]
    with torch.device("meta"):
        model = FocalFormer3D(cfg)
    own = model.state_dict()
    src = load_reference_state(pth)
    extra = sorted(set(src) - set(own))
    report = Report([], [], [], [k for k in extra if not absent(cfg, k)], [],
                    [k for k in extra if absent(cfg, k)])
    out = {}
    for k in reference_key_order(model):
        want = tuple(own[k].shape)
        v = src.get(k)
        if v is not None and tuple(v.shape) == want:
            out[k] = v.to(own[k].dtype).contiguous()
            report.loaded.append(k)
            continue
        out[k] = torch.zeros(want, dtype=own[k].dtype)
        if v is not None:
            report.mismatched.append((k, tuple(v.shape), want))
        elif any(re.fullmatch(p, k) for p in IGNORED):
            report.defaulted.append(k)
        else:
            report.missing.append(k)
    print(report.summary(), flush=True)
    if require_full and not report.full:
        raise SystemExit(f"conversion of {pth} for {config} is incomplete")
    path = Path(out_dir)
    path.mkdir(parents=True, exist_ok=True)
    torch.save({"state_dict": out,
                "opt_state": {"mu": {}, "nu": {}, "count": 0}, "step": 0,
                "meta": {"config": config, "converted_from": str(pth)}},
               path / STATE_FILE)
    print(f"wrote {path / STATE_FILE}", flush=True)
    return report


def main(argv: Optional[List[str]] = None) -> Report:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("config")
    p.add_argument("pth")
    p.add_argument("out_dir")
    p.add_argument("--require-full", action="store_true")
    a = p.parse_args(argv)
    return convert(a.config, a.pth, a.out_dir, a.require_full)


if __name__ == "__main__":
    main()

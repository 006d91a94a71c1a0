"""Write a reference-format ``.pth`` checkpoint with random weights.

Port of ``tools/make_fake_checkpoint.py``. No released FocalFormer3D
weights ship with the repo, so this writes a ``.pth`` whose ``state_dict``
has the keys and shapes of a released checkpoint of the config (the port's
model is named by them) and values from ``utils/ref_keys
.make_fake_state_dict``, for ``tools/convert_checkpoint.py`` to turn into a
checkpoint of the port:

    python -m focalformer3d_tpu_torch.tools.make_fake_checkpoint \\
        FocalFormer3D_L ff3d_l.pth [--seed 0]

The model is built on the meta device: nothing is allocated but the
weights written.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import torch


def write(config: str, out_path: str, seed: int = 0) -> int:
    """Write ``{"state_dict": ..., "meta": {"synthetic": True}}`` to
    ``out_path``; returns the number of tensors."""
    from ..configs import get_config
    from ..models.detector import FocalFormer3D
    from ..utils.ref_keys import make_fake_state_dict

    cfg = get_config(config)["model"]
    with torch.device("meta"):
        model = FocalFormer3D(cfg)
    sd = make_fake_state_dict(model, seed)
    torch.save({"state_dict": sd, "meta": {"synthetic": True}}, out_path)
    return len(sd)


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("config")
    p.add_argument("out")
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    n = write(a.config, a.out, a.seed)
    print(f"wrote {a.out} ({n} tensors)")


if __name__ == "__main__":
    main()

"""Print a named config fully resolved (port of ``tools/print_config.py``,
the counterpart of the reference's tools/misc/print_config.py):

    python -m focalformer3d_tpu_torch.tools.print_config FocalFormer3D_L
    python -m focalformer3d_tpu_torch.tools.print_config   # the names
"""
from __future__ import annotations

import argparse
import dataclasses
import pprint
from typing import List, Optional

from ..configs import available, get_config


def to_dict(obj):
    if dataclasses.is_dataclass(obj):
        return {
            f.name: to_dict(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
        }
    if isinstance(obj, dict):
        return {k: to_dict(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_dict(v) for v in obj)
    return obj


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(description="Print a named config")
    p.add_argument("config", nargs="?", default=None)
    a = p.parse_args(argv)
    if a.config is None:
        print("available:", ", ".join(available()))
    else:
        pprint.pprint(to_dict(get_config(a.config)), width=100)


if __name__ == "__main__":
    main()

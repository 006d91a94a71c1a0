"""What ``BENCHMARK.json`` and the files it names say about one cell.

A cell names a configuration (``configs/<name>.json`` by the config's
``file``) and a traffic mix (``traffic/<name>.json``); the configuration
names its scans' sensor rig (``"scan"``: ``scans/<name>.json``). The
harness finds each by name, so a later cell needs only new files and
entries. Every file is read relative to the working directory, the
checkout's root. The configuration file states the model as it is run:
the port's config name, its sizes (checked against the port's and the
reference's config), the voxel caps it is run with (set on both), the
precision of each part, and the limits of the comparison that decides
``correct``.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, List

# the benchmark's folder, relative to the checkout's root
PKG = Path(__package__)

# stated key -> path of attributes in the detector config, checked
CHECKED = {
    "point_cloud_range": ("voxel", "point_cloud_range"),
    "voxel_size": ("voxel", "voxel_size"),
    "max_num_points": ("voxel", "max_num_points"),
    "sparse_shape": ("sparse_shape",),
    "encoder_channels": ("encoder_channels",),
    "down_paddings": ("down_paddings",),
    "sparse_out_channels": ("sparse_out_channels",),
    "sparse_dense_from": ("sparse_dense_from",),
    "sparse_dense_from_eval": ("sparse_dense_from_eval",),
    "second_channels": ("second_channels",),
    "second_layers": ("second_layers",),
    "fpn_channels": ("fpn_channels",),
    "hidden": ("hidden",),
    "neck_layers": ("neck_layers",),
    "iterbev": ("iterbev",),
    "input_img": ("input_img",),
    "img_backbone_depth": ("img_backbone_depth",),
    "img_scale": ("lss", "img_scale"),
    "num_classes": ("decoder", "num_classes"),
    "num_proposals": ("decoder", "num_proposals"),
    "num_decoder_layers": ("decoder", "num_decoder_layers"),
    "multistage_heatmap": ("decoder", "multistage_heatmap"),
    "reuse_first_heatmap": ("decoder", "reuse_first_heatmap"),
    "num_heads": ("decoder", "num_heads"),
    "code_size": ("decoder", "code_size"),
    "vfe_type": ("vfe_type",),
    "vfe_channels": ("vfe_channels",),
}
# stated key -> path, set on the config as the benchmark runs it
SET = {
    "max_voxels": ("voxel", "max_voxels"),
    "max_voxels_test": ("voxel", "max_voxels_test"),
    "capacities": ("capacities",),
    "out_capacity": ("out_capacity",),
}


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def _listed(metric: Dict[str, Any], cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(workload: str) -> Cell:
    """The cell named ``workload`` of ``BENCHMARK.json``; KeyError for a
    name it lacks."""
    bench = json.loads(Path("BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(cells: {sorted(cells)})")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads(Path(conf["file"]).read_text())
    traffic = json.loads((PKG / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    return Cell(workload, int(w["chips"]), config, traffic,
                [m for m in bench["end_to_end"] if _listed(m, workload)],
                [m for m in bench["per_layer"] if _listed(m, workload)])


def load_rig(name: str) -> Dict[str, Any]:
    """The sensor rig ``scans/<name>.json`` (``data/synthetic.py``);
    ValueError for a name that has no file."""
    path = PKG / "scans" / f"{name}.json"
    if not path.is_file():
        have = sorted(p.stem for p in (PKG / "scans").glob("*.json"))
        raise ValueError(f"no scan rig {name!r} (rigs: {have})")
    return json.loads(path.read_text())


def _get(obj, path):
    for p in path:
        obj = getattr(obj, p)
    return obj


def _set(obj, path, value):
    if len(path) == 1:
        return dataclasses.replace(obj, **{path[0]: value})
    return dataclasses.replace(obj, **{path[0]: _set(getattr(obj, path[0]),
                                                     path[1:], value)})


def _plain(v):
    if isinstance(v, (tuple, list)):
        return [_plain(x) for x in v]
    return v


def as_run(cfg, stated: Dict[str, Any]):
    """``cfg`` (a detector config of the port or of the reference) with the
    stated caps set; ValueError where a stated size differs from it."""
    for key, path in CHECKED.items():
        if key in stated and _plain(_get(cfg, path)) != stated[key]:
            raise ValueError(f"the configuration states {key} = "
                             f"{stated[key]}, the model's config has "
                             f"{_plain(_get(cfg, path))}")
    for key, path in SET.items():
        if key in stated:
            v = stated[key]
            cfg = _set(cfg, path, tuple(v) if isinstance(v, list) else v)
    return cfg

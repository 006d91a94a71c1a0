"""Tiny cells for the CPU tests: ``BENCHMARK.json``'s cells on the port's
``Tiny_L`` (and a six-camera ``Tiny_LC`` registered in both the port's and
the reference's config registries), and a Waymo-path cell on
``Tiny_Waymo_L`` made of new files alone, with their own limits, set from
CPU readings like the cells' own (``calibrate.py``)."""
from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
HERE = Path(__file__).resolve().parent


def tiny_lc(configs):
    """``Tiny_L`` with six 64 x 96 cameras, ResNet-50 + FPN and the LSS
    (the port's camera CLI tests' ``Tiny_LC``), from a config module."""
    cfg = configs.get_config("Tiny_L")
    m = cfg["model"]
    lss = configs.LSSConfig(
        img_scale=(64, 96), camera_depth_range=(1.0, 9.0, 1.0),
        pc_range=m.voxel.point_cloud_range, downsample=4, grid=2.0,
        input_channels=256, cam_channels=8, out_channels=m.hidden)
    cfg["model"] = dataclasses.replace(
        m, neck_layers=2, iterbev="bevfusion", input_img=True,
        use_grid_mask=True, cam_proj="lss", lss=lss, bev_shape=(8, 8),
        freeze_img=True, freeze_camlss=True, freeze_pts=True,
        decoder=dataclasses.replace(m.decoder, multistage_heatmap=2,
                                    reuse_first_heatmap=False))
    cfg["img_scale"] = lss.img_scale
    return cfg


def register(monkeypatch) -> None:
    from focalformer3d_tpu_torch import configs as port
    from perfbench.reference.ff3d import configs as ref

    for mod in (port, ref):
        monkeypatch.setitem(mod._REGISTRY, "Tiny_LC",
                            lambda mod=mod: tiny_lc(mod))


def write_root(root: Path) -> Path:
    """A checkout (``copy_benchmark``) whose ``BENCHMARK.json`` is the
    repo's with each configuration's file the tiny one."""
    copy_benchmark(root)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    tiny = {"FocalFormer3D_L": HERE / "Tiny_L.json",
            "FocalFormer3D_LC": HERE / "Tiny_LC.json"}
    for c in bench["configs"]:
        c["file"] = str(tiny[c["name"]])
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def copy_benchmark(root: Path) -> Path:
    """A checkout holding a copy of ``BENCHMARK.json`` and ``perfbench/``
    (the port is found on the path)."""
    shutil.copytree(REPO / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache",
                                                  "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


WAYMO_CELL = "Waymo.stream"
WAYMO_METRIC = "hardvfe_ms.stream"


def write_waymo_root(root: Path) -> Path:
    """A checkout (``copy_benchmark``) with one more cell that new files
    and entries alone make: ``Tiny_Waymo_L`` (HardVFE, code size 8, a
    reused first heatmap stage) on the Waymo rig scaled to its range
    (``waymo_tiny``), a traffic mix, and a per-layer metric of the
    HardVFE's stage."""
    copy_benchmark(root)
    pb = root / "perfbench"
    shutil.copy(HERE / "Tiny_Waymo_L.json", pb / "configs")
    shutil.copy(HERE / "waymo_tiny.json", pb / "scans")
    (pb / "traffic" / "stream_waymo_tiny.json").write_text(json.dumps(
        {**json.loads((pb / "traffic" / "stream_L.json").read_text()),
         "rate_hz": 6.0, "pool": 4, "check_items": 2}))
    (pb / "metrics" / f"{WAYMO_METRIC}.py").write_text(
        "from perfbench.metrics import _read\n\n\n"
        "def read(ctx):\n"
        "    return _read.stage_ms(ctx, 'stream', ('HardVFE',))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "Tiny_Waymo_L", "source": "tests",
        "file": "perfbench/configs/Tiny_Waymo_L.json", "reduced": [],
        "why": "a test's Waymo-path configuration"})
    bench["workloads"].append({
        "name": WAYMO_CELL, "config": "Tiny_Waymo_L",
        "traffic": "stream_waymo_tiny", "chips": 1,
        "why": "a test's Waymo-path cell"})
    for m in bench["end_to_end"]:
        if m["name"].startswith("latency"):
            m["workloads"].append(WAYMO_CELL)
    bench["per_layer"].append({
        "name": WAYMO_METRIC, "unit": "ms", "better": "lower",
        "source": "program_span", "layer": "HardVFE (models/vfe.py)",
        "moves": "latency_p50_ms", "workloads": [WAYMO_CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root

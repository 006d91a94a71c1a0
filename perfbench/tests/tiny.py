"""Tiny cells for the CPU tests: ``BENCHMARK.json``'s cells on the port's
``Tiny_L`` (and a six-camera ``Tiny_LC`` registered in both the port's and
the reference's config registries), with their own limits, set from CPU
readings like the cells' own (``calibrate.py``)."""
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

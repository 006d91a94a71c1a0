"""``Waymo_L.stream`` at the tests' tiny size on the CPU: FocalFormer3D_Waymo_L
replaced by ``Tiny_Waymo_L`` on the tests' own rig (``waymo_tiny``). The
cell runs correct untraced and traced, a planted fault and the control
are caught, its pools are the pinned ones, and its configuration keeps
the ``waymo`` rig."""
from __future__ import annotations

import hashlib
import json
import shutil

import pytest
import torch

from perfbench import loops, spec
from perfbench.reference.ff3d import configs as ref_configs
from perfbench.tests import tiny
from perfbench.tests.test_perfbench_cells import (KEYS, _perturb_one_weight,
                                                  _run)

CELL = "Waymo_L.stream"
CONFIG = "FocalFormer3D_Waymo_L"
TINY = {"FocalFormer3D_L": "Tiny_L.json", "FocalFormer3D_LC": "Tiny_LC.json",
        CONFIG: "Tiny_Waymo_L.json"}
PINNED = json.loads((tiny.HERE / "pool_digests_waymo.json").read_text())


def _bench():
    return json.loads((tiny.REPO / "BENCHMARK.json").read_text())


def _rig(name):
    """The repo's rigs, and the tests' own ``waymo_tiny``."""
    path = tiny.HERE / f"{name}.json"
    return (json.loads(path.read_text()) if path.is_file()
            else spec.load_rig(name))


@pytest.fixture
def root(tmp_path, monkeypatch):
    """A checkout whose ``BENCHMARK.json`` is the repo's with each
    configuration's file the tiny one, and ``waymo_tiny`` among the
    scans."""
    tiny.register(monkeypatch)
    root = tiny.copy_benchmark(tmp_path / "checkout")
    shutil.copy(tiny.HERE / "waymo_tiny.json", root / "perfbench" / "scans")
    bench = _bench()
    for c in bench["configs"]:
        c["file"] = str(tiny.HERE / TINY[c["name"]])
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.chdir(root)
    return root


def test_the_cell_runs_correct_with_its_metrics(root, capsys):
    line, err = _run(root, capsys, CELL)
    assert set(line) == KEYS
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    want = {m["name"] for m in _bench()["end_to_end"]
            if CELL in m.get("workloads", [CELL])}
    assert set(line["metrics"]) == want == {"latency_p50_ms",
                                            "latency_p95_ms", "setup_s"}
    for name, c in line["check"].items():
        assert f"check {name} {c['value']!r} limit {c['limit']!r}" in err


def test_a_traced_run_reports_the_hardvfe_stage(root, capsys):
    line, _ = _run(root, capsys, CELL, trace=1)
    listed = {m["name"] for m in _bench()["per_layer"]
              if CELL in m.get("workloads", [CELL])}
    assert line["correct"] is True
    assert set(line["metrics"]) <= listed
    assert line["metrics"]["hardvfe_ms.stream"]["value"] > 0
    # no device: no device metric
    assert not any(n.startswith(("mfu", "device_idle"))
                   or "roofline" in n for n in line["metrics"])


def test_a_planted_weight_fault_is_not_correct(root, capsys, monkeypatch):
    _perturb_one_weight(monkeypatch)
    line, err = _run(root, capsys, CELL)
    assert line["correct"] is False
    assert "FAILED" in err


def test_the_control_fails_the_limits(root, capsys):
    """The control (the reference with fp8 operands where bf16 is
    stated, in the program's place) reads over a limit that the program
    keeps."""
    from perfbench import calibrate

    rc = calibrate.main(["--workload", CELL, "--seeds", "21", "--control",
                         "1", "--seconds", "2", "--device", "cpu"])
    assert rc == 0
    rows = [json.loads(x) for x in capsys.readouterr().out.splitlines()
            if x.startswith('{"reading"')]
    limits = json.loads((tiny.HERE / TINY[CONFIG]).read_text())[
        "limits"]["infer"]
    assert {r["reading"] for r in rows} == {"program", "control"}
    for r in rows:
        over = [k for k in limits if r[k] > limits[k]]
        assert bool(over) == (r["reading"] != "program"), r


def digests(pool):
    """As ``test_perfbench_pools.digests``: the key, dtype and shape, then
    the array's bytes."""
    out = {}
    for k in sorted(pool):
        a = pool[k].contiguous().numpy()
        h = hashlib.sha256(f"{k} {a.dtype} {a.shape}".encode())
        h.update(a.tobytes())
        out[k] = h.hexdigest()
    return out


@pytest.mark.parametrize("seed", PINNED["seeds"])
@pytest.mark.parametrize("size", ("full", "tiny"))
def test_the_pools_are_the_pinned_ones(monkeypatch, size, seed):
    """The full pool takes ~6 s here: sixteen 180k-point frames."""
    monkeypatch.chdir(tiny.REPO)
    monkeypatch.setattr(loops, "load_rig", _rig)
    traffic = spec.load_cell(CELL).traffic
    files = {c["name"]: tiny.REPO / c["file"] for c in _bench()["configs"]}
    path = files[CONFIG] if size == "full" else tiny.HERE / TINY[CONFIG]
    config = json.loads(path.read_text())
    full = ref_configs.get_config(config["model"])
    pool = loops.make_pool(traffic, config, spec.as_run(full["model"], config),
                           loops.seeds(seed).data, torch.device("cpu"))
    assert digests(pool) == PINNED["digests"][f"{CELL} {size} {seed}"]


def test_the_configuration_keeps_the_waymo_rig():
    files = {c["name"]: tiny.REPO / c["file"] for c in _bench()["configs"]}
    assert json.loads(files[CONFIG].read_text())["scan"] == "waymo"
    assert _rig("waymo") == spec.load_rig("waymo")

"""``LC_Proj.stream`` at the tests' tiny size on the CPU:
FocalFormer3D_LC_Proj replaced by ``Tiny_LC_Proj`` (``Tiny_LC`` with the
cameras fused by I2P projection on a 3 x 8 x 8 grid), registered in the
port's and the reference's config registries. The cell runs correct
untraced and traced, a traced run reports the camera projection's stages,
and a planted fault in ``I2P_block`` and the control are caught."""
from __future__ import annotations

import dataclasses
import json

import pytest

from perfbench.tests import tiny
from perfbench.tests.test_perfbench_cells import KEYS, _run

CELL = "LC_Proj.stream"
CONFIG = "FocalFormer3D_LC_Proj"
TINY = {"FocalFormer3D_L": "Tiny_L.json", "FocalFormer3D_LC": "Tiny_LC.json",
        "FocalFormer3D_Waymo_L": "Tiny_Waymo_L.json",
        CONFIG: "Tiny_LC_Proj.json"}
I2P = "imgpts_neck.fusion_blocks.0.I2P_block"


def tiny_lc_proj(configs):
    """``Tiny_LC`` with ``cam_proj="i2p"`` (the port's camera CLI tests'
    ``Tiny_LC_Proj``), from a config module."""
    cfg = tiny.tiny_lc(configs)
    cfg["model"] = dataclasses.replace(cfg["model"], cam_proj="i2p",
                                       max_points_height=3,
                                       freeze_camlss=False)
    return cfg


def _bench():
    return json.loads((tiny.REPO / "BENCHMARK.json").read_text())


def _listed(kind):
    return {m["name"] for m in _bench()[kind]
            if CELL in m.get("workloads", [CELL])}


@pytest.fixture
def root(tmp_path, monkeypatch):
    """A checkout whose ``BENCHMARK.json`` is the repo's with each
    configuration's file the tiny one."""
    from focalformer3d_tpu_torch import configs as port
    from perfbench.reference.ff3d import configs as ref

    tiny.register(monkeypatch)
    for mod in (port, ref):
        monkeypatch.setitem(mod._REGISTRY, "Tiny_LC_Proj",
                            lambda mod=mod: tiny_lc_proj(mod))
    root = tiny.copy_benchmark(tmp_path / "checkout")
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
    assert set(line["metrics"]) == _listed("end_to_end") == {
        "latency_p50_ms", "latency_p95_ms", "setup_s"}
    for name, c in line["check"].items():
        assert f"check {name} {c['value']!r} limit {c['limit']!r}" in err


def test_a_traced_run_reports_the_camera_projection(root, capsys):
    line, _ = _run(root, capsys, CELL, trace=1)
    assert line["correct"] is True
    assert set(line["metrics"]) <= _listed("per_layer")
    for name in ("i2p_ms.stream", "camera_ms.stream", "bev_ms.stream"):
        assert line["metrics"][name]["value"] > 0, name
    # no device: no device metric, the roofline among them
    assert not any(n.startswith(("mfu", "device_idle"))
                   or "roofline" in n for n in line["metrics"])


def _perturb_i2p(monkeypatch):
    """A checkpoint-layout fault in the projection alone: I2P's value
    projection loaded transposed."""
    from perfbench import program

    load = program.Program.load

    def perturbed(self, state):
        state = dict(state)
        k = f"{I2P}.learnedAlign.v_proj_weight"
        state[k] = state[k].T.contiguous()
        load(self, state)

    monkeypatch.setattr(program.Program, "load", perturbed)


def test_a_planted_fault_in_i2p_is_not_correct(root, capsys, monkeypatch):
    _perturb_i2p(monkeypatch)
    line, err = _run(root, capsys, CELL)
    assert line["correct"] is False
    assert "FAILED" in err


def test_the_control_fails_the_limits(root, capsys):
    """The control (the reference with fp8 operands where bf16 is
    stated, TF32 where float32 is, in the program's place) reads over a
    limit that the program keeps."""
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

"""Each cell end to end at the tests' tiny sizes on the CPU, and the
planted faults that its check must catch."""
from __future__ import annotations

import json

import pytest
import torch

from perfbench import run
from perfbench.tests import tiny

CELLS = ("L.stream", "L.train", "LC.stream", "L.offline")
KEYS = {"correct", "attempted", "failed", "metrics", "device", "check"}


@pytest.fixture
def root(tmp_path, monkeypatch):
    tiny.register(monkeypatch)
    root = tiny.write_root(tmp_path / "checkout")
    monkeypatch.chdir(root)
    return root


def _run(root, capsys, workload, trace=0, seed=2**31 + 12345, seconds=3.0):
    rc = run.main(["--workload", workload, "--seed", str(seed),
                   "--seconds", str(seconds), "--trace", str(trace),
                   "--device", "cpu"])
    out, err = capsys.readouterr()
    assert rc == 0, err[-3000:]
    line = json.loads(out.strip().splitlines()[-1])
    return line, err


def _bench():
    return json.loads((tiny.REPO / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct_with_its_metrics(root, capsys, workload):
    line, err = _run(root, capsys, workload)
    assert set(line) == KEYS
    assert list(line)[-1] == "check"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    want = {m["name"] for m in _bench()["end_to_end"]
            if workload in m.get("workloads", [workload])}
    assert set(line["metrics"]) == want
    assert line["device"]["platform"] == "cpu"
    for name, c in line["check"].items():
        assert f"check {name} {c['value']!r} limit {c['limit']!r}" in err


@pytest.mark.parametrize("workload", ("L.stream", "L.train"))
def test_traced_run_reports_per_layer_metrics(root, capsys, workload):
    line, _ = _run(root, capsys, workload, trace=1)
    listed = {m["name"] for m in _bench()["per_layer"]
              if workload in m.get("workloads", [workload])}
    assert line["correct"] is True
    assert set(line["metrics"]) <= listed
    assert any(n.endswith("_ms.stream") or n.endswith("_ms.train")
               for n in line["metrics"])
    # no device: no device metric, no breakdown
    assert not any(n.startswith(("mfu", "device_idle"))
                   or "roofline" in n for n in line["metrics"])
    assert "breakdown" not in line
    assert line["device"]["busy_s"] == 0.0


def test_no_card_exits_without_a_result(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tiny.write_root(tmp_path / "checkout"))
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = run.main(["--workload", "L.stream", "--seed", "1", "--seconds",
                   "1", "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc == 2 and out == "" and "CUDA" in err


def _perturb_one_weight(monkeypatch):
    """A checkpoint-layout fault: one square conv weight loaded with its
    input and output channels swapped."""
    from perfbench import program

    load = program.Program.load

    def perturbed(self, state):
        state = dict(state)
        k = "pts_backbone.blocks.0.3.weight"
        state[k] = state[k].transpose(0, 1).contiguous()
        load(self, state)

    monkeypatch.setattr(program.Program, "load", perturbed)


def _answer_altered(monkeypatch):
    """One answer's class changed where ``get_bboxes`` produces it."""
    from focalformer3d_tpu_torch.models import detector

    get = detector.FocalFormer3D.get_bboxes

    def altered(self, out, max_out=200):
        dec = get(self, out, max_out)
        dec["labels"][0, 0] = (dec["labels"][0, 0] + 1) % 4
        return dec

    monkeypatch.setattr(detector.FocalFormer3D, "get_bboxes", altered)


def _state_unchanged(monkeypatch):
    from focalformer3d_tpu_torch.training import optim

    def frozen(self, grads, state, params):
        state.count += 1
        return torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)))

    monkeypatch.setattr(optim.ClipAdamW, "update", frozen)


def _half_batch(monkeypatch):
    from focalformer3d_tpu_torch.training import train_step

    loss = train_step.detection_loss

    def half(dcfg, lcfg, out, gt_boxes, gt_labels, gt_valid):
        n = gt_boxes.shape[0] // 2
        sub = {k: v[:n] if torch.is_tensor(v) and v.dim() and
               v.shape[0] == gt_boxes.shape[0] else v
               for k, v in out.items()}
        return loss(dcfg, lcfg, sub, gt_boxes[:n], gt_labels[:n],
                    gt_valid[:n])

    monkeypatch.setattr(train_step, "detection_loss", half)


@pytest.mark.parametrize("workload,fault", [
    ("L.stream", _perturb_one_weight),
    ("L.stream", _answer_altered), ("L.offline", _answer_altered),
    ("LC.stream", _perturb_one_weight), ("L.train", _perturb_one_weight),
    ("L.train", _state_unchanged), ("L.train", _half_batch)])
def test_planted_fault_is_not_correct(root, capsys, monkeypatch, workload,
                                      fault):
    fault(monkeypatch)
    line, err = _run(root, capsys, workload)
    assert line["correct"] is False
    assert "FAILED" in err


@pytest.mark.parametrize("workload", ("L.stream", "LC.stream", "L.train"))
def test_control_fails_the_limits(root, capsys, workload):
    """The control (the reference one step below the stated precision, in
    the program's place) and, in training, half of the batch left out,
    each read over a limit of the cell's configuration."""
    from perfbench import calibrate

    rc = calibrate.main(["--workload", workload, "--seeds", "21",
                         "--control", "1", "--seconds", "2", "--device",
                         "cpu"])
    assert rc == 0
    rows = [json.loads(x) for x in capsys.readouterr().out.splitlines()
            if x.startswith('{"reading"')]
    conf = json.loads((tiny.HERE / ("Tiny_LC.json" if "LC" in workload
                                    else "Tiny_L.json")).read_text())
    limits = conf["limits"]["train" if workload == "L.train" else "infer"]
    kinds = {r["reading"] for r in rows}
    assert kinds == ({"program", "control", "half_batch"}
                     if workload == "L.train" else {"program", "control"})
    for r in rows:
        over = [k for k in limits if r[k] > limits[k]]
        assert bool(over) == (r["reading"] != "program"), r

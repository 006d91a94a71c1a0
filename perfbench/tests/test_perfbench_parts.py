"""The benchmark's parts on their own: the work counts, the trace
analysis, the control's rounding, the seeded weights, the files that the
harness finds by name, and that nothing it loads is JAX's."""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import types

import pytest
import torch

from perfbench import trace, work
from perfbench.data.weights import make_state_dict
from perfbench.reference.ff3d.models import sparse_encoder as ref_encoder
from perfbench.judge import picks_differ
from perfbench.reference.precision import (E4M3_MAX, control, round_bf16,
                                           round_fp8)
from perfbench.tests import tiny

BANNED = {"jax", "jaxlib", "flax", "optax", "focalformer3d_tpu"}
ENV = {**os.environ, "PYTHONPATH": str(tiny.REPO)}


def test_encoder_work_by_hand():
    rec = [("sparse", 10, 27, 4, 8, 6, 5), ("dense", 3, 3, 8, 2, 5, 2)]
    got = work.encoder_work(rec)
    assert got["sparse_flops"] == 2 * 10 * 4 * 8
    assert got["dense_flops"] == 2 * 3 * 8 * 2
    assert got["first_flops"] == 2 * 10 * 4 * 8
    assert got["bytes"] == 2 * (6 * 4 + 27 * 4 * 8 + 5 * 8) \
        + 2 * (5 * 8 + 3 * 8 * 2 + 2 * 2)


def test_sparse_conv_records_its_active_pairs():
    # 4 input rows (4 is the miss sentinel), 2 taps, 3 outputs, the last
    # one inactive: the active pairs are the hits of the first two outputs
    rules = torch.tensor([[[0, 4, 2], [1, 3, 4]]], dtype=torch.int32)
    valid = torch.tensor([[True, True, False]])
    x, w = torch.randn(1, 4, 3), torch.randn(2, 3, 5)
    ref_encoder.WORK = []
    try:
        y = ref_encoder.apply_conv_plain(x, rules, w, valid)
        kind, pairs, taps, cin, cout, rows_in, rows_out = \
            ref_encoder.WORK[0]
    finally:
        ref_encoder.WORK = None
    assert (kind, int(pairs), taps, cin, cout) == ("sparse", 3, 2, 3, 5)
    assert int(rows_in) == 4 and int(rows_out) == 2
    want = x[0, 0] @ w[0] + x[0, 1] @ w[1]
    assert torch.allclose(y[0, 0], want, atol=1e-6)


def test_dense_level_counts_pairs_from_its_masks():
    mask = torch.zeros(1, 3, 3, 3, dtype=torch.bool)
    mask[0, 1, 1, 1] = mask[0, 1, 1, 2] = True
    ref_encoder.WORK = []
    try:
        ref_encoder._dense_work(mask, mask, (3, 3, 3), 1, 1, 4, 6)
        kind, pairs, taps, cin, cout, rows_in, rows_out = \
            ref_encoder.WORK[0]
    finally:
        ref_encoder.WORK = None
    # each of the two active sites sees itself and the other
    assert (kind, int(pairs), taps, cin, cout) == ("dense", 4, 27, 4, 6)
    assert int(rows_in) == int(rows_out) == 2


def _event(name, a_ms, b_ms, cuda):
    from torch.autograd import DeviceType

    return types.SimpleNamespace(
        name=name, device_type=DeviceType.CUDA if cuda else DeviceType.CPU,
        time_range=types.SimpleNamespace(start=a_ms * 1e3, end=b_ms * 1e3))


def test_trace_busy_idle_and_gaps():
    events = [_event(trace.ITEM, 0, 10, False),
              _event(trace.ITEM, 0, 10, True),  # its device-side range
              _event("k1", 1, 3, True), _event("k2", 2, 4, True),
              _event("k1", 6, 7, True), _event("aten::item", 4, 6, False),
              _event("aten::nonzero", 4.5, 5.5, False),
              _event("k1", 12, 13, True)]  # outside every item
    got = trace.analyse(types.SimpleNamespace(events=lambda: events))
    assert got["busy_s"] == pytest.approx(0.004)
    assert got["window_s"] == pytest.approx(0.010)
    assert got["device_ops"][0] == ["k1", pytest.approx(0.004)]
    gaps = dict(got["idle_gaps"])
    assert gaps["aten::nonzero"] == pytest.approx(0.002)
    assert gaps["no host operation"] == pytest.approx(0.004)


def test_fp8_rounding_and_its_scope():
    x = torch.linspace(-3, 5, 101)
    q = round_fp8(x)
    scale = 5 / E4M3_MAX
    grid = (q / scale).to(torch.float8_e4m3fn).float() * scale
    assert torch.equal(q, grid) and not torch.equal(q, x)
    assert float((q - x).abs().max()) <= 5 * 2 ** -4

    model = torch.nn.Sequential(torch.nn.Linear(8, 8), torch.nn.Linear(8, 8))
    x = torch.randn(4, 8)
    full = model(x)
    with control(model, ["0"]):
        part = model(x)
    with control(model, [""], ["1"]):
        exempt = model(x)
    want = model[1](torch.nn.functional.linear(
        round_fp8(x), round_fp8(model[0].weight), model[0].bias))
    assert torch.allclose(part, want, atol=1e-6)
    assert torch.allclose(exempt, want, atol=1e-6)
    assert not torch.allclose(part, full)
    with pytest.raises(ValueError):
        with control(model, ["2"]):
            pass


def test_bf16_rounding_for_the_look():
    """The look's rounding: each product's operands to bfloat16 in the
    named module, TF32 left as it was, the gradient straight through."""
    x = torch.linspace(-3, 5, 101, requires_grad=True)
    q = round_bf16(x)
    assert torch.equal(q, x.detach().to(torch.bfloat16).float())
    q.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))

    model = torch.nn.Sequential(torch.nn.Linear(8, 8), torch.nn.Linear(8, 8))
    x = torch.randn(4, 8)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    with control(model, ["0"], round_to=round_bf16, tf32=False):
        part = model(x)
        assert torch.backends.cuda.matmul.allow_tf32 is False
    want = model[1](torch.nn.functional.linear(
        round_bf16(x), round_bf16(model[0].weight), model[0].bias))
    assert torch.equal(part, want)
    assert torch.backends.cuda.matmul.allow_tf32 == tf32


def test_picks_differ_counts_picks_missing_from_the_other_run():
    forced = torch.tensor([[3, 7, 9, 12], [0, 1, 2, 3]])
    own = torch.tensor([[9, 3, 8, 13], [3, 2, 1, 0]])
    assert picks_differ(forced, own) == 2  # 7 and 12; order aside
    assert picks_differ(own, own) == 0


def test_weights_are_seeded_and_scaled():
    shapes = {"a.weight": torch.Size([64, 32, 3, 3]),
              "b.conv.weight": torch.Size([3, 3, 3, 16, 32]),
              "b.bn.weight": torch.Size([32]), "b.bn.bias": torch.Size([32]),
              "b.bn.running_var": torch.Size([32]),
              "b.bn.num_batches_tracked": torch.Size([])}
    cpu = torch.device("cpu")
    a = make_state_dict(shapes, 2**33 + 5, cpu)
    b = make_state_dict(shapes, 2**33 + 5, cpu)
    c = make_state_dict(shapes, 6, cpu)
    assert all(torch.equal(a[k], b[k]) for k in shapes)
    assert not torch.equal(a["a.weight"], c["a.weight"])
    assert a["a.weight"].std().item() == pytest.approx(
        (32 * 9) ** -0.5, rel=0.1)
    assert a["b.conv.weight"].std().item() == pytest.approx(
        (27 * 16) ** -0.5, rel=0.1)
    assert abs(a["b.bn.weight"].mean().item() - 1) < 0.1
    v = a["b.bn.running_var"]
    assert v.min() >= 0.5 and v.max() <= 2.0
    assert int(a["b.bn.num_batches_tracked"]) == 100


@pytest.mark.parametrize("model,rig,part", [
    ("Tiny_L", tiny.REPO / "perfbench" / "scans" / "radial.json",
     "pts_backbone"),
    ("Tiny_Waymo_L", tiny.HERE / "waymo_tiny.json", "pts_voxel_encoder")])
def test_work_count_follows_the_precision_map(model, rig, part):
    """A part the map states in float32 (the HardVFE, which computes in
    float32, for the Waymo path) is counted at float32's peak."""
    from perfbench.reference.ff3d.configs import get_config
    from perfbench.reference.ff3d.models.detector import (FocalFormer3D,
                                                          preprocess_points)
    from perfbench.data import synthetic
    import numpy as np

    cfg = get_config(model)["model"]
    model = FocalFormer3D(cfg).eval()
    model.load_state_dict(make_state_dict(
        {k: v.shape for k, v in model.state_dict().items()}, 1,
        torch.device("cpu")))
    b = synthetic.make_batch(np.random.RandomState(0),
                             json.loads(rig.read_text()), 1, 1500, 6, 24,
                             cfg.decoder.num_classes,
                             cfg.voxel.point_cloud_range)
    vox = preprocess_points(cfg, torch.from_numpy(b["points"]),
                            torch.from_numpy(b["points_mask"]))
    name = next(iter(work.PEAKS))
    pk = work.PEAKS[name]
    bf = work.count(model, lambda: model(vox), {"*": "bfloat16"}, name)
    mixed = work.count(model, lambda: model(vox),
                       {"*": "bfloat16", part: "float32"}, name)
    assert bf["flops"] == pytest.approx(mixed["flops"])
    assert bf["seconds_at_peak"] == pytest.approx(
        bf["flops"] / pk["bfloat16"])
    f32 = mixed["flops_by_dtype"]["float32"]
    assert 0 < f32 < mixed["flops"]
    assert mixed["seconds_at_peak"] == pytest.approx(
        f32 / pk["float32"] + (mixed["flops"] - f32) / pk["bfloat16"])
    # the encoder's convs count their active pairs, not the padded gather
    assert 0 < bf["encoder_flops"] < 2 * 27 * 8 * 16 * 4096 * 21


def _banned(code: str):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.')[0] for m in "
                          "sys.modules}))"], capture_output=True, text=True,
                         env=ENV, cwd=tiny.REPO, check=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]
                          .replace("'", '"')))


def test_reference_imports_nothing_of_the_port_or_jax():
    top = _banned("import perfbench.judge, perfbench.work, "
                  "perfbench.reference.precision, perfbench.reference.train,"
                  " perfbench.data.synthetic, perfbench.data.weights")
    assert not top & (BANNED | {"focalformer3d_tpu_torch"})


def test_a_run_loads_no_jax(tmp_path):
    root = tiny.write_root(tmp_path / "checkout")
    r = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload",
                        "L.stream", "--seed", "9", "--seconds", "3",
                        "--trace", "0", "--device", "cpu"],
                       capture_output=True, text=True, env=ENV, cwd=root,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.strip().splitlines()[-1])["correct"]
    top = _banned("from perfbench import run, bench, loops, program")
    assert not top & BANNED


def test_a_new_cell_and_metric_need_only_new_files(tmp_path):
    root = tiny.copy_benchmark(tmp_path / "checkout")
    pb = root / "perfbench"
    (pb / "traffic" / "stream_dummy.json").write_text(json.dumps(
        {**json.loads((pb / "traffic" / "stream_L.json").read_text()),
         "rate_hz": 6.0, "pool": 4, "check_items": 1}))
    (pb / "metrics" / "dummy_count.stream.py").write_text(
        "def read(ctx):\n"
        "    return float(len(ctx['window'].rows))\n")
    conf = json.loads((tiny.HERE / "Tiny_L.json").read_text())
    (pb / "configs" / "Dummy_L.json").write_text(json.dumps(conf))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "Dummy_L", "source": "tests",
                             "file": "perfbench/configs/Dummy_L.json",
                             "reduced": [], "why": "a test's cell"})
    bench["workloads"].append({"name": "Dummy.stream", "config": "Dummy_L",
                               "traffic": "stream_dummy", "chips": 1,
                               "why": "a test's cell"})
    for m in bench["end_to_end"]:
        if m["name"].startswith("latency"):
            m["workloads"].append("Dummy.stream")
    bench["per_layer"].append({"name": "dummy_count.stream", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "tests", "moves": "latency_p50_ms",
                               "workloads": ["Dummy.stream"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for trace_on in (0, 1):
        r = subprocess.run(
            [sys.executable, "-m", "perfbench.run", "--workload",
             "Dummy.stream", "--seed", "3", "--seconds", "1",
             "--trace", str(trace_on), "--device", "cpu"],
            capture_output=True, text=True, env=ENV, cwd=root, timeout=600)
        assert r.returncode == 0, r.stderr[-2000:]
        line = json.loads(r.stdout.strip().splitlines()[-1])
        assert line["correct"]
        want = ({"dummy_count.stream"} if trace_on else
                {"latency_p50_ms", "latency_p95_ms", "setup_s"})
        assert want <= set(line["metrics"])
    assert line["metrics"]["dummy_count.stream"]["value"] == 6.0


def _run_cell(root, workload, trace_on, seed):
    r = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload", workload,
         "--seed", str(seed), "--seconds", "1", "--trace", str(trace_on),
         "--device", "cpu"],
        capture_output=True, text=True, env=ENV, cwd=root, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_a_waymo_path_cell_needs_only_new_files(tmp_path):
    """Tiny_Waymo_L (HardVFE, code size 8, a reused first heatmap stage)
    on its own rig, traffic and metric: files the repo lacks and entries
    in ``BENCHMARK.json``. It runs correct untraced and traced, and its
    control fails a limit that the program keeps."""
    root = tiny.write_waymo_root(tmp_path / "checkout")
    for path in (tiny.REPO / "perfbench").rglob("*"):
        rel = path.relative_to(tiny.REPO)
        if path.is_file() and not {"tests", "__pycache__", ".cache"} & set(
                rel.parts):
            assert (root / rel).read_bytes() == path.read_bytes(), rel
    untraced = _run_cell(root, tiny.WAYMO_CELL, 0, 2**31 + 777)
    assert untraced["correct"] and untraced["failed"] == 0
    assert set(untraced["metrics"]) == {"latency_p50_ms", "latency_p95_ms",
                                        "setup_s"}
    traced = _run_cell(root, tiny.WAYMO_CELL, 1, 2**31 + 778)
    assert traced["correct"]
    assert traced["metrics"][tiny.WAYMO_METRIC]["value"] > 0
    r = subprocess.run(
        [sys.executable, "-m", "perfbench.calibrate", "--workload",
         tiny.WAYMO_CELL, "--seeds", "21", "--control", "1", "--seconds",
         "1", "--device", "cpu"],
        capture_output=True, text=True, env=ENV, cwd=root, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    rows = {x["reading"]: x for x in map(json.loads, r.stdout.splitlines())
            if "reading" in x}
    limits = json.loads((tiny.HERE / "Tiny_Waymo_L.json").read_text())[
        "limits"]["infer"]
    assert not [k for k in limits if rows["program"][k] > limits[k]]
    assert [k for k in limits if rows["control"][k] > limits[k]]


@pytest.mark.parametrize("stated", [
    {"vfe_type": "HardSimpleVFE"}, {"code_size": 10},
    {"vfe_channels": [32]}, {"reuse_first_heatmap": False}])
def test_a_wrong_statement_raises(stated):
    """A configuration that names FocalFormer3D_Waymo_L and states what it
    is not raises, against the port's config and the reference's."""
    from focalformer3d_tpu_torch.configs import get_config as port_config
    from perfbench.reference.ff3d.configs import get_config as ref_config
    from perfbench.spec import as_run

    right = {"model": "FocalFormer3D_Waymo_L", "vfe_type": "HardVFE",
             "vfe_channels": [64], "code_size": 8,
             "reuse_first_heatmap": True, "multistage_heatmap": 2}
    for get_config in (port_config, ref_config):
        cfg = get_config("FocalFormer3D_Waymo_L")["model"]
        as_run(cfg, right)
        with pytest.raises(ValueError, match=next(iter(stated))):
            as_run(cfg, {**right, **stated})


NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


def test_benchmark_json_keeps_to_its_contract():
    bench = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    cells = {w["name"]: w for w in bench["workloads"]}
    confs = {c["name"]: c for c in bench["configs"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for w in cells.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in confs and w["chips"] == 1
        assert (tiny.REPO / "perfbench" / "traffic"
                / f"{w['traffic']}.json").exists()
        assert NAME.fullmatch(w["name"]) and len(w["why"]) <= 200
    for c in confs.values():
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (tiny.REPO / c["file"]).exists()
        assert c["reduced"] == json.loads(
            (tiny.REPO / c["file"]).read_text())["reduced"]
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in \
        e2e["setup_s"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (tiny.REPO / "perfbench" / "metrics"
                / f"{m['name']}.py").exists()
        assert set(m.get("workloads", [])) <= set(cells)
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
    for cell in cells:
        got = [m for m in bench["end_to_end"]
               if cell in m.get("workloads", [cell])]
        assert len(got) >= 2 and any(
            cell in m.get("workloads", []) for m in bench["per_layer"])
    assert len(json.dumps(bench)) < 64 * 1024


def test_without_the_port_a_run_fails_and_prints_no_result(tmp_path):
    root = tiny.copy_benchmark(tmp_path / "checkout")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload",
                        "L.stream", "--seed", "1", "--seconds", "1",
                        "--trace", "0", "--device", "cpu"],
                       capture_output=True, text=True, env=env, cwd=root,
                       timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""

"""The port's benchmark CLI on the CPU (``--device cpu``, Tiny_L, a few
hundred points): it prints exactly one JSON line, right after its timing
and before its diagnostics, with the numbers of every engine asked for;
then the stage split and the per-level occupancy of each engine (inference)
or SECOND's first conv2d in its six variants (``--train``, which times
each engine of ``--engines`` in turns and gives each a row of the line).
Nothing is timed by a device here: the stage split reads the host clock
and the conv2d variants are "not measured"."""
import json

import numpy as np
import pytest
import torch

from focalformer3d_tpu_torch.tools import benchmark

torch.set_num_threads(2)
COMMON = ["Tiny_L", "--device", "cpu", "--samples", "2", "--warmup", "1",
          "--n-points", "400"]


def _json_lines(out):
    lines = out.splitlines()
    found = []
    for i, line in enumerate(lines):
        if line.startswith("{"):
            found.append((i, json.loads(line)))
    return lines, found


@pytest.mark.parametrize("engines", ["plain", "plain,cuda_mxu"])
def test_inference_json_line_comes_before_the_diagnostics(capsys, engines):
    result = benchmark.main(COMMON + ["--engines", engines,
                                      "--big-batch", "2"])
    lines, found = _json_lines(capsys.readouterr().out)
    assert len(found) == 1
    i, rec = found[0]
    assert rec == json.loads(json.dumps(result))
    names = engines.split(",")
    assert sorted(rec["engines"]) == sorted(names)
    assert rec["dtype"] == "bfloat16" and rec["device"]["platform"] == "cpu"
    for row in rec["engines"].values():
        s = row["ms_per_scan"]
        assert s["n"] == 2 and s["min"] <= s["median"] <= s["max"]
        assert row["ms_per_scan_pipelined"] > 0
        assert row["ms_per_scan_batch2"]["n"] == 3
    after = lines[i + 1:]
    for e in names:
        split = [x for x in after if x.startswith(f"stage split {e} ")]
        occ = [x for x in after if x.startswith(f"occupancy {e} ")]
        assert len(split) == 1 and len(occ) == 1
        assert "index build" in split[0] and "decoder" in split[0]
        assert occ[0].count(" of ") >= 3
    assert not any(x.startswith("stage split") for x in lines[:i])


def test_train_json_line_and_conv2d_variants(capsys):
    result = benchmark.main(COMMON + ["--train", "--batch-size", "2"])
    lines, found = _json_lines(capsys.readouterr().out)
    assert len(found) == 1
    i, rec = found[0]
    assert rec["benchmark"] == "train" and rec["batch_size"] == 2
    assert rec == json.loads(json.dumps(result))
    engines = benchmark.CARD_ENGINES.split(",")  # the default, in turns
    assert list(rec["engines"]) == engines
    for e, row in rec["engines"].items():
        assert row["ms_per_step"]["n"] == 3 and row["ms_per_step_first"] > 0
        assert sorted(row["split_ms"]) == sorted(
            ["voxelize", "forward", "loss", "backward", "optimizer"])
        assert np.isfinite(row["loss"]) and row["peak_memory_gib"] is None
        assert set(row["launches_per_step"].values()) == {0}  # CPU
        assert sum(x.startswith(f"train step [Tiny_L] {e}: ")
                   for x in lines[:i]) == 1
    conv = [x for x in lines[i + 1:] if x.startswith("SECOND conv2d 0 ")]
    assert [x.split("[")[1].split("]")[0][0] for x in conv] == \
        list("abcdef")
    assert all("not measured (no card)" in x for x in conv)


def test_no_card_raises_without_cpu_flag(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        benchmark.main(["Tiny_L"])

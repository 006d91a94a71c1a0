"""``spans.py`` on hand-built profiles, and its window on a tiny cell on
the CPU, where the profile has no device event and every value is None."""
from __future__ import annotations

import json
import types

import pytest

from perfbench import spans, trace
from perfbench.tests import tiny


def _event(name, a_ms, b_ms, cuda=False):
    from torch.autograd import DeviceType

    return types.SimpleNamespace(
        name=name, device_type=DeviceType.CUDA if cuda else DeviceType.CPU,
        time_range=types.SimpleNamespace(start=a_ms * 1e3, end=b_ms * 1e3))


def _profile(events):
    return types.SimpleNamespace(events=lambda: events)


EVENTS = [
    _event(trace.ITEM, 0, 20), _event(trace.ITEM, 0, 20, True),
    _event("ff3d/index build/L0", 1, 9), _event("ff3d/decoder", 10, 19),
    _event("ff3d/decoder/layer 0", 12, 15.5),
    _event("k", 0, 2, True), _event("k", 4, 5, True),
    _event("k", 9, 11, True), _event("k", 14, 15, True),
    _event("k", 17, 20, True),
    # launches and syncs, by their start
    _event("cudaLaunchKernel", 1.5, 1.6), _event("cuLaunchKernelEx", 3, 3.1),
    _event("cudaLaunchKernelExC", 12.5, 12.6),
    _event("cudaStreamSynchronize", 13, 14),
    _event("cudaMemcpyAsync", 13, 13.1),  # not a sync
    _event("cudaDeviceSynchronize", 19.5, 20),  # outside every span
    _event("cudaLaunchKernel", 25, 25.1),  # outside every item
    _event("aten::nonzero", 5, 6),  # host ops name no gap here
]


def test_gaps_go_to_the_innermost_span_and_calls_count_inside():
    got = spans.analyse(_profile(EVENTS))
    assert got["items"] == 1 and got["window_ms"] == pytest.approx(20)
    s = got["spans"]
    # gaps: 2-4 and 5-9 in the index build, 11-14 in layer 0, 15-17 in
    # the decoder (its midpoint past the layer's end)
    assert s["index build/L0"]["idle_ms"] == pytest.approx(6)
    assert s["decoder/layer 0"]["idle_ms"] == pytest.approx(3)
    assert s["decoder"]["idle_ms"] == pytest.approx(2)
    assert got["idle_ms"] == pytest.approx(11)
    assert got["idle_in_spans_ms"] == pytest.approx(11)
    assert s["index build/L0"]["launches"] == 2
    assert s["decoder/layer 0"]["launches"] == 1
    assert s["decoder/layer 0"]["syncs"] == 1
    assert s["decoder"]["launches"] == s["decoder"]["syncs"] == 0
    assert got["launches"] == 3 and got["syncs"] == 2
    assert got["outside"]["syncs"] == 1
    assert s["decoder"]["host_ms"] == pytest.approx(9)
    vals = spans.layer_values(got)
    assert vals == {"index_build_idle_ms": pytest.approx(6),
                    "decoder_idle_ms": pytest.approx(5),
                    "index_build_launches": 2, "decoder_launches": 1,
                    "host_syncs": 1}
    lines = spans.notes(got)
    assert lines[0].startswith("span ff3d/decoder: host 9.0000 ms")
    assert "100.00% of it inside a span" in lines[-1]


def test_values_are_per_item_and_idle_outside_spans_is_kept_apart():
    events = EVENTS + [_event(trace.ITEM, 30, 40), _event("k", 30, 31, True)]
    got = spans.analyse(_profile(events))
    assert got["items"] == 2
    assert got["outside"]["idle_ms"] == pytest.approx(9 / 2)
    assert got["idle_in_spans_ms"] == pytest.approx(11 / 2)
    assert got["spans"]["index build/L0"]["launches"] == 1


@pytest.mark.parametrize("drop", ["device", "spans"])
def test_without_device_events_or_spans_every_value_is_none(drop):
    keep = [e for e in EVENTS
            if not (drop == "device" and e.name == "k")
            and not (drop == "spans" and e.name.startswith("ff3d/"))]
    got = spans.analyse(_profile(keep))
    assert got is None
    assert set(spans.layer_values(got).values()) == {None}
    assert spans.notes(got) == [
        "spans: the profile has no device event or no ff3d/ span"]


def test_window_on_a_tiny_cell_reads_nothing_on_the_cpu(
        tmp_path, capsys, monkeypatch):
    tiny.register(monkeypatch)
    monkeypatch.chdir(tiny.write_root(tmp_path / "checkout"))
    rc = spans.main(["--workload", "L.stream", "--seed", str(2**31 + 7),
                     "--seconds", "1", "--untraced-seconds", "0.5",
                     "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    line = json.loads(out[-1])
    assert set(line["layer_values"].values()) == {None}
    assert line["idle_in_spans_pct"] is None
    assert line["traced"]["failed"] == 0
    assert "stage_sum_p50_ms" in line["traced"]
    assert line["untraced_before"]["latency_p50_ms"] > 0
    assert 0 < line["span_cost_us"]["null_us"] < \
        line["span_cost_us"]["recording_us"]

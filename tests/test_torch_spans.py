"""The port's spans (``utils/profiler.span``) and its section timer, on the
CPU at Tiny_L's size:

- under ``torch.profiler`` a Tiny_L inference and a Tiny_L training step
  open the ``ff3d/`` ranges of every stage, nested where the work nests,
  with an ``index build/L<k>`` and a ``sparse convs/L<k>`` for every sparse
  level the encoder builds;
- the stages that ``mark`` receives are the same, in the same order, with
  and without a profiler recording, and are the lists the stage metrics
  read (the LiDAR, LSS and I2P configs, the training step);
- with no profiler recording and no ``mark`` a span site is the shared
  null context: a Tiny_L inference and training step run with the range
  constructors and CUDA events replaced by ones that raise;
- ``T`` times a section and waits for what it names.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from focalformer3d_tpu_torch import configs
from focalformer3d_tpu_torch.data import synthetic
from focalformer3d_tpu_torch.models.detector import (FocalFormer3D,
                                                     preprocess_points)
from focalformer3d_tpu_torch.training import optim
from focalformer3d_tpu_torch.training.train_step import (PHASES,
                                                         make_train_step)
from focalformer3d_tpu_torch.utils import profiler
from focalformer3d_tpu_torch.utils.ref_keys import make_fake_state_dict

torch.set_num_threads(2)

# Tiny_L (encoder_channels of four levels, dense from L2 at eval)
INFER_STAGES = ["index build", "sparse convs"] * 4 + [
    "dense tail", "SECOND + neck", "FocalEncoder", "decoder"]
INFER_SPANS = [
    "voxelize", "index build/L0", "sparse convs/L0", "index build/L1",
    "sparse convs/L1", "index build/L1", "sparse convs/L1",
    "index build/L2", "sparse convs/L2", "dense tail", "SECOND + neck",
    "FocalEncoder", "decoder", "decoder/heatmap 0", "decoder/heatmap 1",
    "decoder/layer 0", "decoder/layer 1", "get_bboxes"]


def _setup(engine="plain"):
    c = configs.get_config("Tiny_L")
    cfg = dataclasses.replace(c["model"], sparse_engine=engine)
    batch = synthetic.make_batch(
        np.random.RandomState(0), batch_size=1, n_points=1500, n_boxes=3,
        max_gts=6, num_classes=cfg.decoder.num_classes,
        pc_range=cfg.voxel.point_cloud_range, mode="radial")
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    model = FocalFormer3D(cfg)
    model.load_state_dict(make_fake_state_dict(model, seed=3), strict=True)
    tx = optim.make_optimizer(total_steps=4)
    step = make_train_step(cfg, c["loss"], tx)
    return cfg, model, batch, tx, step


@pytest.fixture(scope="module")
def tiny():
    return _setup()


def _infer(cfg, model, batch, mark=None):
    model.eval()
    with torch.no_grad():
        vox = preprocess_points(cfg, batch["points"], batch["points_mask"])
        return model.get_bboxes(model(vox, mark=mark), 50)


def _train(model, batch, tx, step, mark=None):
    gen = torch.Generator()
    gen.manual_seed(0)
    return step(model, tx.init(model.named_parameters()), batch, gen, mark)


def _ranges(prof):
    """(start, end, name) of the ff3d/ ranges, by start."""
    return sorted((e.time_range.start, e.time_range.end,
                   e.name[len(profiler.PREFIX):]) for e in prof.events()
                  if e.name.startswith(profiler.PREFIX))


def _parent(ranges, k):
    """The innermost range that holds range ``k``."""
    a, b, _ = ranges[k]
    inside = [r for j, r in enumerate(ranges)
              if j != k and r[0] <= a and b <= r[1]]
    return max(inside)[2] if inside else None


def test_span_is_the_shared_null_context_with_nothing_recording():
    assert profiler.span("a") is profiler.span("b/c")
    with profiler.span("a") as got:
        assert got is None
    marks = []
    with profiler.span("index build/L3", marks.append):
        pass
    with profiler.span("allreduce", marks.append, "gradient all-reduce"):
        pass
    with pytest.raises(KeyError):
        with profiler.span("decoder", marks.append):
            raise KeyError("x")
    assert marks == ["index build", "gradient all-reduce"]


def test_span_sites_open_no_range_and_record_no_event(tiny, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span site ran with nothing recording")

    monkeypatch.setattr(profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    cfg, model, batch, tx, step = tiny
    dec = _infer(cfg, model, batch)
    assert torch.isfinite(dec["scores"]).all()
    assert torch.isfinite(_train(model, batch, tx, step)["loss"])


def test_inference_spans_nest_and_mark_as_before(tiny):
    cfg, model, batch, _, _ = tiny
    plain = []
    _infer(cfg, model, batch, plain.append)
    traced = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _infer(cfg, model, batch, traced.append)
    assert plain == traced == INFER_STAGES
    ranges = _ranges(prof)
    assert [r[2] for r in ranges] == INFER_SPANS
    parents = {r[2]: _parent(ranges, k) for k, r in enumerate(ranges)}
    for name in INFER_SPANS:
        want = "decoder" if name.startswith("decoder/") else None
        assert parents[name] == want, name
    levels = {n.rsplit("L", 1)[1] for n in INFER_SPANS
              if n.startswith("index build/")}
    assert levels == {"0", "1", "2"}
    # the spans hold the inference's aten ops but for glue between them
    ops = [e for e in prof.events() if e.name.startswith("aten::")
           and e.cpu_parent is None]
    inside = [e for e in ops if any(a <= e.time_range.start <= b
                                    for a, b, _ in ranges)]
    assert len(inside) >= 0.9 * len(ops)


def test_all_sparse_engine_spans_every_level_and_conv_out():
    cfg, model, batch, _, _ = _setup("cuda_mxu")
    marks = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _infer(cfg, model, batch, marks.append)
    assert marks == ["index build", "sparse convs"] * 8 + [
        "SECOND + neck", "FocalEncoder", "decoder"]
    names = [r[2] for r in _ranges(prof)]
    n = len(cfg.encoder_channels)
    for k in range(n + 1):  # conv_out's level is the last
        want = 1 if k == 0 or k == n else 2
        assert names.count(f"index build/L{k}") == want
        assert names.count(f"sparse convs/L{k}") == want
    assert "dense tail" not in names


def _camera_setup(cam_proj):
    """Tiny_L with six 64 x 96 cameras, ResNet-50 + FPN and the LSS or I2P
    (the camera CLI tests' Tiny_LC and Tiny_LC_Proj)."""
    m = configs.get_config("Tiny_L")["model"]
    lss = configs.LSSConfig(
        img_scale=(64, 96), camera_depth_range=(1.0, 9.0, 1.0),
        pc_range=m.voxel.point_cloud_range, downsample=4, grid=2.0,
        input_channels=256, cam_channels=8, out_channels=m.hidden)
    cfg = dataclasses.replace(
        m, neck_layers=2, iterbev="bevfusion", input_img=True,
        cam_proj=cam_proj, lss=lss, bev_shape=(8, 8), max_points_height=3,
        sparse_engine="plain", decoder=dataclasses.replace(
            m.decoder, multistage_heatmap=2, reuse_first_heatmap=False))
    batch = synthetic.make_batch(
        np.random.RandomState(0), batch_size=1, n_points=1500, n_boxes=3,
        max_gts=6, num_classes=cfg.decoder.num_classes,
        pc_range=cfg.voxel.point_cloud_range, mode="radial",
        with_images=True, img_hw=lss.img_scale)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    model = FocalFormer3D(cfg)
    model.load_state_dict(make_fake_state_dict(model, seed=3), strict=True)
    return cfg, model.eval(), batch


@pytest.mark.parametrize("cam_proj,camera", [
    ("lss", ["LSS lift", "LSS splat", "BevEncode"]), ("i2p", ["I2P"])])
def test_camera_spans_nest_in_the_fusion_and_mark_as_before(cam_proj,
                                                            camera):
    cfg, model, batch = _camera_setup(cam_proj)
    img = {k: batch[k] for k in ("imgs", "lidar2img", "img_aug", "bev_aug")}
    marks = []
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            torch.no_grad():
        vox = preprocess_points(cfg, batch["points"], batch["points_mask"])
        model(vox, mark=marks.append, img_data=img)
    assert marks == (["image backbone + FPN"] + INFER_STAGES[:-3]
                     + ["SECOND + neck"] + camera
                     + ["FocalEncoder", "decoder"])
    ranges = _ranges(prof)
    parents = {r[2]: _parent(ranges, k) for k, r in enumerate(ranges)}
    assert parents["image backbone + FPN"] is None
    for name in camera:
        assert parents[name] == "FocalEncoder"


def test_training_step_spans_nest_and_mark_its_phases(tiny):
    _, model, batch, tx, step = tiny
    plain = []
    _train(model, batch, tx, step, plain.append)
    traced = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _train(model, batch, tx, step, traced.append)
    assert plain == traced == list(PHASES)
    ranges = _ranges(prof)
    names = [r[2] for r in ranges]
    top = [r[2] for k, r in enumerate(ranges) if _parent(ranges, k) is None]
    assert top == ["inputs", "forward", "loss", "backward", "optimizer"]
    parents = {r[2]: _parent(ranges, k) for k, r in enumerate(ranges)}
    assert parents["voxelize"] == "inputs"
    assert parents["loss/assign"] == "loss"
    assert parents["decoder"] == parents["index build/L0"] == "forward"
    # training: dense from L3, which the last strided conv writes
    assert {n for n in names if n.startswith("index build/")} == {
        f"index build/L{k}" for k in range(4)}
    assert "get_bboxes" not in names


def test_section_timer_waits_and_times():
    with profiler.T("outer") as outer:
        with profiler.T("inner") as t:
            t.sync({"a": torch.ones(3), "b": [torch.zeros(1)]})
    assert t.ms is not None and 0.0 <= t.ms <= outer.ms
    with profiler.T("skipped", enable=False) as off:
        assert off is None

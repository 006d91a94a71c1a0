"""The head's blocks and what its CUDA graphs need, on the CPU at Tiny_L's
size (the card's captures and replays: ``tests/test_torch_cuda.py``):

- the head makes its constants (the BEV size, the value levels' sizes of
  every deformable cross-attention, the point-cloud range) on the device
  by fills: an eval call of the head under a counting dispatch mode
  makes no ``aten.lift_fresh`` (a tensor from a Python list, on a card a
  blocking copy from the host), its second call the same ops as its
  first, and the fills give the bits ``torch.tensor`` gives;
- the forward is ``_blocks``, one block a span of ``_block_spans``, in
  every mask mode and with three heatmap stages, eagerly on the CPU;
- ``utils/graphs.GraphCache`` runs a key's first call eagerly, captures
  at its second and replays at every later one, counting blocks;
  moving or casting the head drops its graphs;
- ``train_step.kernel_launches`` carries the head's three block counters,
  0 on the CPU, in eval and in a training step.
"""
import collections
import dataclasses
import types

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from focalformer3d_tpu_torch import configs
from focalformer3d_tpu_torch.data import synthetic
from focalformer3d_tpu_torch.models import focal_decoder as fd
from focalformer3d_tpu_torch.models.detector import (FocalFormer3D,
                                                     preprocess_points)
from focalformer3d_tpu_torch.models.layers import filled
from focalformer3d_tpu_torch.training import optim, train_step
from focalformer3d_tpu_torch.utils import graphs
from focalformer3d_tpu_torch.utils.ref_keys import make_fake_state_dict

torch.set_num_threads(2)
DECODER_KEYS = ("decoder_graph_replay", "decoder_graph_capture",
                "decoder_eager")
VARIANTS = {
    "Tiny_L": ("Tiny_L", {}),
    "pos": ("Tiny_L", dict(mask_heatmap_mode="pos")),
    "boxcls": ("Tiny_L", dict(mask_heatmap_mode="boxcls",
                              heatmap_box=True)),
    "classaware_reg": ("Tiny_L", dict(classaware_reg=True)),
    "three_stages": ("Tiny_Waymo_L", dict(multistage_heatmap=2)),
}


class _Ops(TorchDispatchMode):
    """Counts the aten ops of the calls made under it."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


def _setup(variant, batch_size=1):
    """The detector of ``variant`` (plain engine, seeded weights, eval)
    and the head's arguments on a radial scan: (model, lidar_feat,
    stage_feats)."""
    name, delta = VARIANTS[variant]
    m = configs.get_config(name)["model"]
    neck = 2 if variant == "three_stages" else m.neck_layers
    cfg = dataclasses.replace(m, sparse_engine="plain", neck_layers=neck,
                              decoder=dataclasses.replace(m.decoder,
                                                          **delta))
    batch = synthetic.make_batch(
        np.random.RandomState(0), batch_size=batch_size, n_points=1500,
        n_boxes=3, max_gts=6, num_classes=cfg.decoder.num_classes,
        pc_range=cfg.voxel.point_cloud_range, mode="radial")
    model = FocalFormer3D(cfg)
    model.load_state_dict(make_fake_state_dict(model, seed=3), strict=True)
    model.eval()
    got = {}
    hook = model.pts_bbox_head.register_forward_pre_hook(
        lambda mod, args: got.update(args=args[:2]))
    with torch.no_grad():
        model(preprocess_points(cfg, torch.from_numpy(batch["points"]),
                                torch.from_numpy(batch["points_mask"])))
    hook.remove()
    lidar_feat, stage_feats = got["args"]
    return model, lidar_feat, list(stage_feats), cfg, batch


@pytest.fixture(scope="module")
def tiny():
    return _setup("Tiny_L")


def test_a_tensor_from_a_python_list_shows_in_the_count():
    with _Ops() as probe:
        torch.tensor([1.0, 2.0])
        filled((1.0, 2.0), "cpu")
    assert probe.ops["aten.lift_fresh"] == 1


def test_the_eval_head_makes_no_tensor_from_a_python_list(tiny):
    model, lidar_feat, stage_feats, _, _ = tiny
    head = model.pts_bbox_head
    counts, outs = [], []
    for _ in range(2):
        with torch.no_grad(), _Ops() as probe:
            outs.append(head(lidar_feat, stage_feats))
        assert not [op for op in probe.ops if "lift_fresh" in op]
        counts.append(probe.ops)
    assert counts[0] == counts[1]
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k]), k


@pytest.mark.parametrize("values", [
    (-54.0, -54.0, -5.0, 54.0, 54.0, 3.0),
    (-75.2, -75.2, -2.0, 75.2, 75.2, 4.0), (180, 180), (0.1, 1e-7, 1 / 3)])
def test_fills_give_the_bits_of_a_tensor_from_a_list(values):
    got = filled(values, "cpu")
    want = torch.tensor(values, dtype=torch.float32)
    assert got.dtype == torch.float32 and torch.equal(got, want)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_the_forward_is_one_block_a_span(variant):
    """``forward`` equals ``_blocks`` run through; each block but the last
    yields None and the last the output dict; one span a block, the
    heatmap stages' and rounds' between the blocks of the dense heatmap,
    the queries and the output stack."""
    model, lidar_feat, stage_feats, cfg, _ = _setup(variant)
    head = model.pts_bbox_head
    dc = cfg.decoder
    spans = head._block_spans()
    assert spans == ([None] + [f"decoder/heatmap {i}"
                               for i in range(dc.total_stages)]
                     + [None] + [f"decoder/layer {r}"
                                 for r in range(dc.num_decoder_layers)]
                     + [None])
    with torch.no_grad():
        runs, replayed = head._block_runs(
            lidar_feat, head._maps(stage_feats), None, None, None, None)
        got = list(runs)
        want = head(lidar_feat, stage_feats)
    assert not replayed and len(got) == len(spans)
    assert got[:-1] == [None] * (len(spans) - 1)
    assert set(got[-1]) == set(want)
    for k in want:
        assert torch.equal(got[-1][k], want[k]), k
    assert want["dense_heatmap"].shape[1] == dc.total_stages


class _FakeGraphs:
    """Stands in for ``BlockGraphs`` on the CPU: counts as it would."""

    made = []

    def __init__(self, build, n_blocks, inputs, counter, kind):
        self.inputs = [t.clone() for t in inputs]
        self.build, self.counter, self.kind = build, counter, kind
        for _ in range(n_blocks):
            counter.add(kind + "_graph_capture")
        _FakeGraphs.made.append(self)

    def replay(self, inputs):
        for buf, t in zip(self.inputs, inputs):
            buf.copy_(t)
        for out in self.build(*self.inputs):
            self.counter.add(self.kind + "_graph_replay")
            yield out


def test_graph_cache_is_eager_then_captures_then_replays(monkeypatch):
    monkeypatch.setattr(graphs, "BlockGraphs", _FakeGraphs)
    _FakeGraphs.made.clear()
    counter = types.SimpleNamespace(counts=collections.Counter())
    counter.add = lambda kind: counter.counts.update([kind])
    cache = graphs.GraphCache(counter, "t")

    def build(x):
        yield None
        yield x * 2

    seen = []
    for key, x in [("a", 1.0), ("a", 2.0), ("a", 3.0), ("b", 4.0),
                   ("a", 5.0)]:
        blocks, replayed = cache.run(key, build, 2, (torch.tensor(x),))
        seen.append((replayed, float(list(blocks)[-1])))
    assert seen == [(False, 2.0), (True, 4.0), (True, 6.0), (False, 8.0),
                    (True, 10.0)]
    assert len(_FakeGraphs.made) == 1
    assert counter.counts == {"t_graph_replay": 6, "t_graph_capture": 2,
                              "t_eager": 4}
    assert cache.graphs["b"] is None
    cache.clear()
    assert cache.graphs == {}


def test_moving_or_casting_the_head_drops_its_graphs(tiny):
    head = fd.FocalDecoder(configs.get_config("Tiny_L")["model"].decoder)
    for move in (lambda h: h.float(), lambda h: h.to("cpu")):
        head._graphs.graphs["key"] = None
        move(head)
        assert head._graphs.graphs == {}
    model = tiny[0]
    model.pts_bbox_head._graphs.graphs["key"] = None
    model.to("cpu")  # the detector's move reaches the head
    assert model.pts_bbox_head._graphs.graphs == {}


def test_kernel_launches_carry_the_head_counters_at_zero_on_the_cpu(tiny):
    model, _, _, cfg, batch = tiny
    train_step.reset_kernel_launches()
    with torch.no_grad():
        model.get_bboxes(model(preprocess_points(
            cfg, torch.from_numpy(batch["points"]),
            torch.from_numpy(batch["points_mask"]))), 50)
    got = train_step.kernel_launches()
    assert {k: got[k] for k in DECODER_KEYS} == dict.fromkeys(DECODER_KEYS,
                                                              0)
    tx = optim.make_optimizer(total_steps=4)
    step = train_step.make_train_step(cfg, configs.get_config("Tiny_L")[
        "loss"], tx)
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    gen = torch.Generator()
    gen.manual_seed(0)
    model.train()
    try:
        step(model, tx.init(model.named_parameters()), b, gen)
    finally:
        model.eval()
    got = train_step.kernel_launches()
    assert set(got.values()) == {0}

"""The port's training loop, train CLI, prefetcher, profiler and the
configs' loss / train parts, against the JAX package's.

Tiny_L on the CPU (engine ``plain``), 2 epochs x 2 iterations:

- ``run_training`` writes text and JSON log records whose keys equal the
  JAX loop's (the JAX ``run_training`` run on a stub step that returns the
  JAX train step's metric names, taken from ``jax.eval_shape`` of that
  step), a checkpoint per epoch, pruned by ``keep_last``;
- a run stopped after epoch 1 and resumed gives the same parameters,
  ``OptState`` and schedule step, bit for bit, as an unbroken run (the
  step's generator is re-seeded from the run's seed and the step);
- ``make_optimizer(cyclic=False)`` holds LR and b1 constant;
- ``tools/train.py --synthetic --device cpu`` trains, saves, prunes and
  auto-resumes; without ``--synthetic`` it reads a nuScenes infos pkl and
  raises, naming it, where there is none (the dataset branch itself:
  ``tests/test_torch_dataset_cli.py``); the CLIs turn TF32 off;
- the prefetcher passes the cases of ``tests/test_data.py``; the
  profiler's stage clock times on the host clock (its timer and spans:
  ``tests/test_torch_spans.py``);
- ``configs.get_config`` gives JAX's loss config, training recipe, class
  names and dataset for both ported configs.
"""
import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focalformer3d_tpu.configs import get_config as jax_get_config
from focalformer3d_tpu.models.detector import FocalFormer3D as JaxFF3D
from focalformer3d_tpu.models.detector import preprocess_points as jax_prep
from focalformer3d_tpu.training import loop as jloop
from focalformer3d_tpu.training import optim as joptim
from focalformer3d_tpu.training.train_step import TrainState
from focalformer3d_tpu.training.train_step import make_train_step as jstep
from focalformer3d_tpu_torch import configs as tconfigs
from focalformer3d_tpu_torch.data import synthetic
from focalformer3d_tpu_torch.data.prefetch import prefetch
from focalformer3d_tpu_torch.models.detector import FocalFormer3D
from focalformer3d_tpu_torch.tools import train as train_cli
from focalformer3d_tpu_torch.training import checkpoint as ckpt
from focalformer3d_tpu_torch.training import loop
from focalformer3d_tpu_torch.training import optim
from focalformer3d_tpu_torch.training.train_step import make_train_step
from focalformer3d_tpu_torch.utils import profiler
from focalformer3d_tpu_torch.utils.ref_keys import make_fake_state_dict

torch.set_num_threads(2)
CPU = torch.device("cpu")
CONFIGS = ("Tiny_L", "FocalFormer3D_L")


def _cfg():
    c = tconfigs.get_config("Tiny_L")
    return dataclasses.replace(c["model"], sparse_engine="plain"), c["loss"]


def _batches(cfg, epoch, iters=2):
    rng = np.random.RandomState(100 + epoch)
    for _ in range(iters):
        yield synthetic.make_batch(
            rng, batch_size=2, n_points=1500, n_boxes=3, max_gts=6,
            num_classes=cfg.decoder.num_classes,
            pc_range=cfg.voxel.point_cloud_range, mode="radial")


def _fresh(cfg, tx):
    model = FocalFormer3D(cfg)
    model.load_state_dict(make_fake_state_dict(model, seed=3), strict=True)
    return model, tx.init(model.named_parameters())


def _train(work, epochs, start=0, model=None, opt_state=None, lines=None,
           keep_last=None):
    cfg, lcfg = _cfg()
    tx = optim.make_optimizer(total_steps=4)
    if model is None:
        model, opt_state = _fresh(cfg, tx)
    loop.run_training(
        make_train_step(cfg, lcfg, tx), model, opt_state,
        lambda e: _batches(cfg, e), epochs=epochs, device=CPU,
        start_epoch=start, seed=5, work_dir=str(work), keep_last=keep_last,
        log_interval=1, log_fn=(lines.append if lines is not None
                                else lambda _: None),
        json_log_path=str(work / "log.jsonl"))
    return model, opt_state, tx


def _jax_metric_names():
    """The JAX Tiny_L train step's metric names, from its traced shapes."""
    c = jax_get_config("Tiny_L")
    cfg = c["model"]
    b = {k: jnp.asarray(v) for k, v in next(_batches(cfg, 0)).items()}
    model = JaxFF3D(cfg)
    tx = joptim.make_optimizer(total_steps=4)
    vox = jax_prep(cfg, b["points"], b["points_mask"], train=True)
    variables = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "gt": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)}, vox, None, True,
        b["gt_boxes"], b["gt_labels"], b["gt_valid"]))
    state = jax.eval_shape(lambda v: TrainState(
        v["params"], v["batch_stats"], tx.init(v["params"]),
        jnp.zeros((), jnp.int32)), variables)
    _, metrics = jax.eval_shape(jstep(cfg, c["loss"], tx), state, b,
                                jax.random.PRNGKey(1))
    return sorted(metrics)


@pytest.fixture(scope="module")
def jax_records(tmp_path_factory):
    """Records of the JAX loop, 1 epoch x 2 iterations of a stub step that
    returns the JAX train step's metrics."""
    names = _jax_metric_names()
    work = tmp_path_factory.mktemp("jax")

    def step(state, batch, rng):
        return state + 1, {k: jnp.float32(0.5) for k in names}

    def batches(epoch):
        for _ in range(2):
            yield {"x": np.zeros(2, np.float32)}

    lines = []
    jloop.run_training(step, jnp.zeros((), jnp.int32), batches, epochs=1,
                       log_interval=1, log_fn=lines.append,
                       json_log_path=str(work / "log.jsonl"),
                       save_checkpoints=False)
    recs = [json.loads(x) for x in (work / "log.jsonl").read_text()
            .splitlines()]
    return names, recs, lines


@pytest.fixture(scope="module")
def unbroken(tmp_path_factory):
    work = tmp_path_factory.mktemp("unbroken")
    lines = []
    model, opt_state, tx = _train(work, 2, lines=lines, keep_last=1)
    return work, model, opt_state, tx, lines


def test_log_records_have_the_jax_keys(jax_records, unbroken):
    names, jrecs, jlines = jax_records
    work, *_rest, lines = unbroken
    recs = [json.loads(x) for x in (work / "log.jsonl").read_text()
            .splitlines()]
    assert [r["mode"] for r in recs] == ["train", "train", "epoch"] * 2
    for mode in ("train", "epoch"):
        want = [sorted(r) for r in jrecs if r["mode"] == mode][0]
        for r in recs:
            if r["mode"] == mode:
                assert sorted(r) == want
    train = [r for r in recs if r["mode"] == "train"]
    assert [(r["epoch"], r["iter"]) for r in train] == [(0, 1), (0, 2),
                                                        (1, 1), (1, 2)]
    assert all(np.isfinite(r[k]) for r in train for k in names)
    # the text lines: the same metric names, sorted, as in the JAX loop
    jtext = [x for x in jlines if x.startswith("epoch 0 iter 1 ")][0]
    text = [x for x in lines if x.startswith("epoch 0 iter 1 ")][0]
    keys = [kv.split("=")[0] for kv in text.split(") ")[1].split()]
    jkeys = [kv.split("=")[0] for kv in jtext.split(") ")[1].split()]
    assert keys == jkeys == sorted(names)


def test_checkpoints_written_and_pruned(unbroken):
    work, model, opt_state, *_ = unbroken
    assert ckpt.list_epochs(str(work)) == [2]
    payload = ckpt.load_payload(str(work / "epoch_2"))
    assert payload["step"] == opt_state.count == 4
    for k, v in model.state_dict().items():
        assert torch.equal(payload["state_dict"][k], v), k


def test_resumed_run_equals_unbroken_run(unbroken, tmp_path):
    _, model, opt_state, tx, _ = unbroken
    _train(tmp_path, 1)  # stops after epoch 1
    cfg, _ = _cfg()
    m2, s2 = _fresh(cfg, tx)
    assert ckpt.auto_resume(str(tmp_path), m2, s2) == 1
    assert s2.count == 2 and tx.lr(s2.count) == tx.lr(2)
    _train(tmp_path, 2, start=1, model=m2, opt_state=s2)
    assert s2.count == opt_state.count == 4
    assert s2.names == opt_state.names
    got, ref = m2.state_dict(), model.state_dict()
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    for a, b in zip(s2.mu + s2.nu, opt_state.mu + opt_state.nu):
        assert torch.equal(a, b)


def test_restore_gives_params_opt_state_and_step(unbroken):
    work, model, opt_state, tx, _ = unbroken
    cfg, _ = _cfg()
    m2, s2 = _fresh(cfg, tx)
    assert ckpt.auto_resume(str(work), m2, s2) == 2
    assert s2.count == opt_state.count
    for k, v in model.state_dict().items():
        assert torch.equal(m2.state_dict()[k], v), k
    for a, b in zip(s2.mu + s2.nu, opt_state.mu + opt_state.nu):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cyclic", [False, True])
def test_cyclic_false_holds_lr_and_b1(cyclic):
    tx = optim.make_optimizer(base_lr=2e-4, base_b1=0.9, total_steps=10,
                              cyclic=cyclic)
    jtx_lr = [2e-4] * 12 if not cyclic else [
        float(joptim.cyclic_schedule(2e-4, 10)(i)) for i in range(12)]
    lrs = [tx.lr(i) for i in range(12)]
    if not cyclic:
        assert lrs == jtx_lr
        assert [tx.b1(i) for i in range(12)] == [0.9] * 12
    else:
        np.testing.assert_allclose(lrs, jtx_lr, rtol=1e-6)
        assert len(set(lrs)) > 5


def test_train_cli_synthetic(tmp_path, capsys):
    args = ["Tiny_L", "--synthetic", "--device", "cpu", "--epochs", "2",
            "--iters-per-epoch", "2", "--keep-last", "1", "--log-interval",
            "1", "--work-dir", str(tmp_path), "--no-tensorboard"]
    run = train_cli.main(args)
    assert run.start_epoch == 0 and run.opt_state.count == 4
    assert ckpt.list_epochs(str(tmp_path)) == [2]
    recs = [json.loads(x) for x in (tmp_path / "train_log.jsonl")
            .read_text().splitlines()]
    losses = [r["loss"] for r in recs if r["mode"] == "train"]
    assert len(losses) == 4 and all(np.isfinite(losses))
    again = train_cli.main(args)
    assert again.start_epoch == 2 and again.opt_state.count == 4
    for k, v in run.model.state_dict().items():
        assert torch.equal(again.model.state_dict()[k], v), k
    assert "auto-resumed from epoch 2" in capsys.readouterr().out


@pytest.mark.parametrize("extra", [
    [], ["--data-root", "no/such/nuscenes"],
    ["--ann-file", "no/such/nuscenes_infos_train.pkl"]])
def test_train_cli_dataset_branches_raise(tmp_path, extra):
    """Without ``--synthetic`` the CLI reads the infos pkl of
    ``--data-root`` (default ``data/nuscenes``) or ``--ann-file``; where
    there is none it raises, naming the file, and writes nothing."""
    with pytest.raises(FileNotFoundError, match="nuscenes_infos_train.pkl"):
        train_cli.main(["Tiny_L", "--device", "cpu", "--work-dir",
                        str(tmp_path), *extra])
    assert not list(tmp_path.iterdir())


def test_train_cli_needs_a_card_unless_cpu_is_asked_for(monkeypatch,
                                                        tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        train_cli.main(["Tiny_L", "--synthetic", "--work-dir",
                        str(tmp_path)])
    assert not list(tmp_path.iterdir())


def test_cli_precision_is_float32():
    """The CLIs' shared ``resolve_device`` turns TF32 off, which PyTorch
    allows for cuDNN by default, so a CLI computes float32 as float32."""
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = [f.allow_tf32 for f in flags]
    try:
        for f in flags:
            f.allow_tf32 = True
        assert train_cli.resolve_device("cpu") == CPU
        assert [f.allow_tf32 for f in flags] == [False, False]
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v


def test_step_seed_depends_on_seed_and_step_alone():
    seeds = {loop.step_seed(s, t) for s in range(3) for t in range(50)}
    assert len(seeds) == 150
    assert loop.step_seed(4, 17) == loop.step_seed(4, 17)


class TestPrefetcher:
    """``tests/test_data.py::TestPrefetcher`` on the port's copy."""

    def test_order_and_completion(self):
        assert list(prefetch(iter(range(100)), depth=3)) == list(range(100))

    def test_exception_propagates(self):
        def gen():
            yield 1
            yield 2
            raise ValueError("producer failed")

        it = prefetch(gen(), depth=2)
        assert next(it) == 1
        assert next(it) == 2
        with pytest.raises(ValueError, match="producer failed"):
            next(it)

    def test_overlap(self):
        def slow_gen():
            for i in range(6):
                time.sleep(0.05)
                yield i

        t0 = time.perf_counter()
        for _ in prefetch(slow_gen(), depth=2):
            time.sleep(0.05)
        assert time.perf_counter() - t0 < 0.5  # serial would be ~0.6 s


@pytest.mark.parametrize("name", CONFIGS)
def test_config_loss_train_and_names_equal_jax(name):
    j, t = jax_get_config(name), tconfigs.get_config(name)
    assert sorted(t) == sorted(j)
    assert dataclasses.asdict(t["train"]) == dataclasses.asdict(j["train"])
    assert dataclasses.asdict(t["loss"]) == dataclasses.asdict(j["loss"])
    assert tuple(t["class_names"]) == tuple(j["class_names"])
    assert t["dataset"] == j["dataset"]


def test_profiler_stage_clock():
    clock = profiler.StageClock(CPU, ("a", "b", "c"))
    clock.start()
    time.sleep(0.02)
    clock.mark("a")
    clock.mark("b")
    time.sleep(0.02)
    clock.mark("a")
    split = clock.split()
    assert list(split) == ["a", "b", "c"] and split["c"] == 0.0
    assert split["a"] >= 35.0 and 0.0 <= split["b"] < split["a"]

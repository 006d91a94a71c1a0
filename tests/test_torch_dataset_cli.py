"""The port's train and test CLIs on a written nuScenes-format directory.

Tiny_L on the CPU (``--device cpu``), on a directory that
``chip_smoke.write_nuscenes`` writes from the port's synthetic scenes (the
writer phase 10 of ``chip_smoke.py`` uses), with the GT database of the
port's ``create_gt_database``:

- the train CLI trains 2 epochs of 1 step with GT-paste and Fading,
  saves ``epoch_2`` and auto-resumes; the test CLI scores that checkpoint
  on 2 samples, prints the metrics' JSON line and writes the submission
  and the tracking file;
- the first two collated batches that the port's CLI hands its loop equal,
  bit for bit, the batches that the JAX CLI's code path
  (``tools/train.py``'s nuScenes branch, run with its state
  initialisation and loop replaced) hands its loop for the same
  ``--seed``, with and without CBGS;
- ``--tta*`` and a Waymo config raise, naming the ROADMAP item that ports
  them; ``print_config`` lists and prints the port's configs;
  ``create_nuscenes_infos`` raises without the nuscenes-devkit.
"""
import importlib.util
import itertools
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from focalformer3d_tpu_torch.configs import get_config
from focalformer3d_tpu_torch.tools import create_data
from focalformer3d_tpu_torch.tools import print_config
from focalformer3d_tpu_torch.tools import test as test_cli
from focalformer3d_tpu_torch.tools import train as train_cli
from focalformer3d_tpu_torch.training import loop as tloop

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
MAX_POINTS = 6000


def write_tiny(root, seed=3, samples=4):
    """A Tiny_L-sized directory with its GT database; returns its root."""
    cfg_all = get_config("Tiny_L")
    ann = chip_smoke.write_nuscenes(
        root, seed=seed, samples=samples, points=1500, sweeps=2,
        pc_range=cfg_all["model"].voxel.point_cloud_range,
        classes=cfg_all["class_names"], boxes=4)
    create_data.create_gt_database(ann, str(root), str(root))
    return Path(root)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_tiny(tmp_path_factory.mktemp("nuscenes"))


def test_written_directory_has_the_infos_format(dataset):
    import pickle

    with open(dataset / "nuscenes_infos_val.pkl", "rb") as f:
        infos = pickle.load(f)["infos"]
    assert len(infos) == 4
    for info in infos:
        assert {"token", "lidar_path", "timestamp", "sweeps", "gt_boxes",
                "gt_names", "gt_velocity", "num_lidar_pts", "valid_flag",
                "lidar2ego_rotation", "lidar2ego_translation",
                "ego2global_rotation", "ego2global_translation"} <= set(info)
        assert info["gt_boxes"].shape == (4, 7)
        assert len(info["sweeps"]) == 2
        assert (info["num_lidar_pts"] > 0).any()
    assert (dataset / "nuscenes_dbinfos_train.pkl").exists()


def test_train_then_test_cli(dataset, tmp_path, capsys):
    work = tmp_path / "work"
    argv = ["Tiny_L", "--device", "cpu", "--data-root", str(dataset),
            "--epochs", "2", "--iters-per-epoch", "1", "--log-interval", "1",
            "--max-points", str(MAX_POINTS), "--work-dir", str(work),
            "--no-tensorboard"]
    run = train_cli.main(argv)
    out = capsys.readouterr().out
    assert out.count("loss=") == 2
    assert f"saved {work}/epoch_2" in out
    assert run.opt_state.count == 2
    assert [type(t).__name__ for t in run.pipeline.transforms][0] \
        == "GlobalRotScaleTrans"  # Fading took ObjectSample out
    again = train_cli.main(argv)
    assert again.start_epoch == 2
    assert "auto-resumed from epoch 2" in capsys.readouterr().out

    sub, trk = tmp_path / "sub.json", tmp_path / "trk.json"
    res = test_cli.main([
        "Tiny_L", "--device", "cpu", "--data-root", str(dataset),
        "--checkpoint", str(work / "epoch_2"), "--limit", "2",
        "--max-points", str(MAX_POINTS), "--out", str(sub),
        "--tracking-out", str(trk)])
    out = capsys.readouterr().out
    metrics = json.loads(next(x for x in out.splitlines()
                              if x.startswith("{")))
    assert set(metrics) == set(res.metrics)
    assert {"mAP", "mATE", "mASE", "mAOE", "mAVE", "nds_no_attr",
            "AP_car"} <= set(metrics)
    assert "nds_no_attr averages 9 terms" in out
    assert res.samples == 2 and len(res.ground_truth) == 2
    got = json.loads(sub.read_text())["results"]
    assert sorted(got) == ["sample_0000", "sample_0001"]
    assert all(0 < len(a) <= 500 for a in got.values())
    assert set(json.loads(trk.read_text())["results"]) == set(got)


def _jax_train_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_train_cli", REPO / "tools" / "train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _first_batches(batch_iter, hooks, n=2):
    for h in hooks:
        h.before_train_epoch(0, getattr(h, "pipeline", None))
    return [{k: np.asarray(v) for k, v in b.items()}
            for b in itertools.islice(batch_iter(0), n)]


@pytest.mark.parametrize("extra", [[], ["--no-cbgs"]])
def test_cli_batches_equal_jax(dataset, tmp_path, monkeypatch, extra):
    from focalformer3d_tpu.training import loop as jloop
    from focalformer3d_tpu.training import train_step as jstep
    from focalformer3d_tpu.training.train_step import TrainState
    import jax.numpy as jnp

    args = ["Tiny_L", "--data-root", str(dataset), "--epochs", "2",
            "--iters-per-epoch", "2", "--batch-size", "2", "--seed", "5",
            "--max-points", str(MAX_POINTS), "--no-tensorboard", *extra]
    got = {}

    def jax_loop(step, state, batch_iter, **kw):
        got["jax"] = _first_batches(batch_iter, kw["hooks"])

    def port_loop(step, model, opt_state, batch_iter, **kw):
        got["port"] = _first_batches(batch_iter, kw["hooks"])

    # the JAX CLI with its state initialisation and its loop replaced
    monkeypatch.setattr(jstep, "create_train_state", lambda *a: (None, (
        TrainState({}, {}, (), jnp.zeros((), jnp.int32)))))
    monkeypatch.setattr(jloop, "run_training", jax_loop)
    monkeypatch.setattr(sys, "argv", [
        "train.py", *args, "--work-dir", str(tmp_path / "jax")])
    _jax_train_cli().main()
    monkeypatch.setattr(tloop, "run_training", port_loop)
    train_cli.main([*args, "--device", "cpu", "--work-dir",
                    str(tmp_path / "port")])
    assert len(got["jax"]) == len(got["port"]) == 2
    for b_port, b_jax in zip(got["port"], got["jax"]):
        assert set(b_port) == set(b_jax)
        for k in b_jax:
            assert b_port[k].dtype == b_jax[k].dtype, k
            np.testing.assert_array_equal(b_port[k], b_jax[k], err_msg=k)
        assert b_port["gt_valid"].any() and b_port["points_mask"].any()


@pytest.mark.parametrize("cli,argv,match", [
    (test_cli, ["Tiny_L", "--tta"], "Queue 1 item 9"),
    (test_cli, ["Tiny_L", "--tta-cache-dir", "x"], "Queue 1 item 9"),
    (test_cli, ["Tiny_L", "--tta-ensemble", "a", "b"], "Queue 1 item 9"),
    (test_cli, ["FocalFormer3D_Waymo_L"], "Queue 1 item 10"),
    (train_cli, ["Tiny_Waymo_L", "--synthetic"], "Queue 1 item 10"),
])
def test_unported_options_raise(cli, argv, match, tmp_path):
    with pytest.raises(NotImplementedError, match=match):
        cli.main([*argv, "--device", "cpu", "--work-dir", str(tmp_path)]
                 if cli is train_cli else [*argv, "--device", "cpu"])


def test_test_cli_needs_a_card_unless_cpu_is_asked_for(dataset, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        test_cli.main(["Tiny_L", "--data-root", str(dataset)])


def test_print_config(capsys):
    print_config.main([])
    assert capsys.readouterr().out.strip() == \
        "available: FocalFormer3D_L, Tiny_L"
    print_config.main(["Tiny_L"])
    out = capsys.readouterr().out
    assert "'model':" in out and "'sparse_shape': (25, 64, 64)" in out


def test_create_nuscenes_infos_needs_the_devkit(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "nuscenes", None)
    with pytest.raises(SystemExit, match="nuscenes-devkit"):
        create_data.create_nuscenes_infos(str(tmp_path))


def test_import_walk_covers_the_dataset_modules():
    from test_torch_imports import _port_files

    files = {str(f.relative_to(REPO)) for f in _port_files()}
    for mod in ("data/transforms.py", "data/nuscenes.py",
                "data/pipelines.py", "data/native/__init__.py",
                "core/eval_nuscenes.py", "core/results.py",
                "tools/test.py", "tools/create_data.py",
                "tools/print_config.py"):
        assert "focalformer3d_tpu_torch/" + mod in files, mod

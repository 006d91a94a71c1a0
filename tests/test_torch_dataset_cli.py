"""The port's train and test CLIs on a written nuScenes-format directory.

Tiny_L on the CPU (``--device cpu``), on a directory that
``data/synthetic_dirs.write_nuscenes`` writes from the port's synthetic
scenes (the writer of the card tests' directories), with the GT database
of the port's ``create_gt_database``:

- the train CLI trains 2 epochs of 1 step with GT-paste and Fading,
  saves ``epoch_2`` and auto-resumes; the test CLI scores that checkpoint
  on 2 samples, prints the metrics' JSON line and writes the submission
  and the tracking file;
- the first two collated batches that the port's CLI hands its loop equal,
  bit for bit, the batches that the JAX CLI's code path
  (``tools/train.py``'s nuScenes branch, run with its state
  initialisation and loop replaced) hands its loop for the same
  ``--seed``, with and without CBGS;
- the test CLI's TTA: ``--tta`` gives, per sample, the port's own eval
  step run once per pass on the augmented points, then
  ``merge_tta_results`` (the merge ``tests/test_torch_tta.py`` holds
  against JAX): masks and labels exactly, boxes within 1e-5;
  ``--tta-cache-dir`` writes caches that the JAX ``load_ensemble`` reads;
  ``--tta-ensemble`` over two caches gives ``merge_aug_boxes`` of their
  ``load_ensemble``, without building a model;
- ``convert_checkpoint`` turns a ``make_fake_checkpoint`` ``.pth`` into a
  checkpoint the test CLI loads strictly, with the ``.pth``'s values;
  ``--require-full`` fails on a dropped, an extra or a reshaped key;
- the train CLI's nuScenes branch on a dynamic-voxelization DeformFormer3D
  (Tiny_L with the DeformFormer3D deltas, the config injected);
- a Waymo config whose head asks for the ``pos`` or ``boxcls`` mask mode
  runs through the test and train CLIs;
  ``print_config`` lists and prints the port's 13 configs;
  ``create_nuscenes_infos`` raises without the nuscenes-devkit.
"""
import dataclasses
import importlib.util
import itertools
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from focalformer3d_tpu_torch.configs import get_config
from focalformer3d_tpu_torch.data import synthetic_dirs
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
    ann = synthetic_dirs.write_nuscenes(
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


@pytest.fixture(scope="module")
def waymo_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("waymo")
    cfg_all = get_config("Tiny_Waymo_L")
    synthetic_dirs.write_waymo(
        root, seed=2, frames=3, points=3000,
        pc_range=cfg_all["model"].voxel.point_cloud_range,
        classes=cfg_all["class_names"], boxes=6)
    return root


@pytest.mark.parametrize("cli,argv,mode", [
    (test_cli, ["Tiny_Waymo_L_masked", "--limit", "2", "--max-points",
                str(MAX_POINTS)], "pos"),
    (train_cli, ["Tiny_Waymo_L_masked", "--synthetic", "--epochs", "1",
                 "--iters-per-epoch", "1", "--batch-size", "1",
                 "--log-interval", "1", "--no-tensorboard"], "boxcls"),
])
def test_unported_options_raise(cli, argv, mode, waymo_dir, tmp_path,
                                monkeypatch):
    """The head mask modes other than 'poscls', which the CLIs refused
    until ROADMAP Queue 1 item 10c ported them, now run through them: the
    test CLI on a written Waymo directory with 'pos', the train CLI on the
    synthetic stream with 'boxcls' (with its dense box heads,
    ``heatmap_box``, which JAX's head requires for it), on a Waymo
    config that asks for the mode."""
    from focalformer3d_tpu_torch import configs as tconfigs

    def masked():
        cfg = get_config("Tiny_Waymo_L")
        model = cfg["model"]
        return {**cfg, "model": dataclasses.replace(
            model, decoder=dataclasses.replace(
                model.decoder, mask_heatmap_mode=mode,
                heatmap_box=mode == "boxcls"))}

    monkeypatch.setitem(tconfigs._REGISTRY, "Tiny_Waymo_L_masked", masked)
    if cli is train_cli:
        run = cli.main([*argv, "--device", "cpu", "--work-dir",
                        str(tmp_path)])
        assert run.opt_state.count == 1
        assert any(".heatmap_box_head." in k
                   for k in run.model.state_dict())
        recs = [json.loads(x) for x in open(tmp_path / "train_log.jsonl")]
        assert np.isfinite([r["loss"] for r in recs
                            if r["mode"] == "train"]).all()
    else:
        run = cli.main([*argv, "--device", "cpu", "--data-root",
                        str(waymo_dir)])
        assert run.samples == 2
        assert all(np.isfinite(v) for v in run.metrics.values())


def test_test_cli_needs_a_card_unless_cpu_is_asked_for(dataset, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        test_cli.main(["Tiny_L", "--data-root", str(dataset)])


def test_print_config(capsys):
    print_config.main([])
    assert capsys.readouterr().out.strip() == (
        "available: DeformFormer3D_C_R50, DeformFormer3D_L, "
        "DeformFormer3D_L_dynamic, DeformFormer3D_Waymo15_L, "
        "DeformFormer3D_Waymo_L, FocalFormer3D_L, FocalFormer3D_LC, "
        "FocalFormer3D_LC_Proj, FocalFormer3D_LC_TTA, "
        "FocalFormer3D_Waymo15_L, FocalFormer3D_Waymo_L, Tiny_L, "
        "Tiny_Waymo_L")
    print_config.main(["Tiny_L"])
    out = capsys.readouterr().out
    assert "'model':" in out and "'sparse_shape': (25, 64, 64)" in out


def test_create_nuscenes_infos_needs_the_devkit(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "nuscenes", None)
    with pytest.raises(SystemExit, match="nuscenes-devkit"):
        create_data.create_nuscenes_infos(str(tmp_path))


# ---------------------------------------------------------------------------
# test-time augmentation
# ---------------------------------------------------------------------------

def _tta_run(dataset, tmp_path, seed, *extra, limit=2):
    return test_cli.main([
        "Tiny_L", "--device", "cpu", "--data-root", str(dataset),
        "--limit", str(limit), "--max-points", str(MAX_POINTS), "--seed",
        str(seed), "--max-out", "16", *extra])


def _per_pass_reference(dataset, seed, limit=2):
    """Per sample: the port's eval step on each double-flip pass of the
    sample's points, then ``merge_tta_results``, the kept boxes."""
    from focalformer3d_tpu_torch.core import merge_augs as ma
    from focalformer3d_tpu_torch.data import nuscenes as nusc
    from focalformer3d_tpu_torch.data import pipelines as pl
    from focalformer3d_tpu_torch.models.detector import FocalFormer3D
    from focalformer3d_tpu_torch.training.train_step import make_eval_step
    from focalformer3d_tpu_torch.utils.ref_keys import make_fake_state_dict

    cfg_all = get_config("Tiny_L")
    cfg, classes = cfg_all["model"], list(cfg_all["class_names"])
    model = FocalFormer3D(cfg)
    model.load_state_dict(make_fake_state_dict(model, seed=seed))
    step = make_eval_step(cfg, 16)
    ds = nusc.NuScenesDataset(
        str(dataset / "nuscenes_infos_val.pkl"), data_root=str(dataset),
        classes=classes, pipeline=pl.test_pipeline(
            cfg.voxel.point_cloud_range), test_mode=True)
    rng = np.random.RandomState(0)
    augs = ma.tta_augs({})
    assert augs == [(1.0, False, False), (1.0, True, False),
                    (1.0, False, True), (1.0, True, True)]
    out = {}
    for j in range(limit):
        s = ds.get_sample(j, rng)
        results = []
        for _, fh, fv in augs:
            pts = s["points"].copy()
            pts[:, 1] *= -1 if fh else 1
            pts[:, 0] *= -1 if fv else 1
            b = nusc.collate([dict(s, points=pts)], classes,
                             max_points=MAX_POINTS,
                             max_gts=cfg.decoder.max_gts // 4)
            b.pop("tokens")
            dec = step(model, {k: torch.from_numpy(v) for k, v in b.items()})
            results.append({k: dec[k][0] for k in ("bboxes", "scores",
                                                   "labels", "mask")})
        m = ma.merge_tta_results(ma.TTAConfig(num_classes=len(classes)),
                                 results, *zip(*augs))
        out[s["token"]] = {k: m[src][m["mask"]].numpy() for k, src in (
            ("boxes", "bboxes"), ("scores", "scores"), ("labels", "labels"))}
    return out


def _assert_same_predictions(got, ref):
    assert sorted(got) == sorted(ref)
    for tok in ref:
        np.testing.assert_array_equal(got[tok]["labels"], ref[tok]["labels"])
        np.testing.assert_array_equal(got[tok]["scores"], ref[tok]["scores"])
        np.testing.assert_allclose(got[tok]["boxes"], ref[tok]["boxes"],
                                   rtol=0, atol=1e-5)
        assert len(ref[tok]["labels"]) > 0


def test_tta_cli_is_the_per_pass_eval_and_merge(dataset, tmp_path):
    sub = tmp_path / "sub.json"
    run = _tta_run(dataset, tmp_path, 3, "--tta", "--out", str(sub))
    assert run.passes == 4 and run.seconds_merge > 0
    _assert_same_predictions(run.predictions, _per_pass_reference(dataset, 3))
    got = json.loads(sub.read_text())["results"]
    assert sorted(got) == ["sample_0000", "sample_0001"]
    # 4 passes of 16 kept boxes: more than one pass's, duplicates merged
    assert all(16 < len(a) < 64 for a in got.values())


def test_tta_caches_and_the_ensemble(dataset, tmp_path):
    from focalformer3d_tpu.core import merge_augs as jma
    from focalformer3d_tpu_torch.core import merge_augs as ma

    caches = [str(tmp_path / "A"), str(tmp_path / "B")]
    for seed, cache in zip((3, 4), caches):
        _tta_run(dataset, tmp_path, seed, "--tta", "--tta-cache-dir", cache)
    tokens = ["sample_0000", "sample_0001"]
    for tok in tokens:
        # the JAX package reads the port's cache
        got = ma.load_ensemble(caches[:1], tok, 64)
        ref = jma.load_ensemble(caches[:1], tok, 64)
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype
            np.testing.assert_array_equal(g, r)
        assert 16 < got[3].sum() <= 64  # 4 passes of 16 valid candidates
    run = _tta_run(dataset, tmp_path, 0, "--tta-ensemble", *caches)
    assert run.passes == 0
    cfg = ma.TTAConfig(num_classes=4)
    for tok in tokens:
        cands = ma.load_ensemble(caches, tok, pad_to=16 * 8 * 2)
        m = ma.merge_aug_boxes(cfg, *(torch.from_numpy(x)[None]
                                      for x in cands))
        ref = {k: m[src][m["mask"]].numpy() for k, src in (
            ("boxes", "bboxes"), ("scores", "scores"), ("labels", "labels"))}
        _assert_same_predictions({tok: run.predictions[tok]}, {tok: ref})


def test_tta_ensemble_builds_no_model(dataset, tmp_path, monkeypatch):
    from focalformer3d_tpu_torch.models import detector

    cache = str(tmp_path / "A")
    _tta_run(dataset, tmp_path, 3, "--tta", "--tta-cache-dir", cache,
             limit=1)

    def no_model(*a, **k):
        raise AssertionError("the ensemble built a model")

    monkeypatch.setattr(detector, "FocalFormer3D", no_model)
    run = _tta_run(dataset, tmp_path, 3, "--tta-ensemble", cache, limit=1)
    assert len(run.predictions["sample_0000"]["scores"]) > 0


# ---------------------------------------------------------------------------
# checkpoint conversion
# ---------------------------------------------------------------------------

def test_convert_a_fake_checkpoint_then_test(dataset, tmp_path):
    from focalformer3d_tpu_torch.models.detector import FocalFormer3D
    from focalformer3d_tpu_torch.tools import convert_checkpoint as conv
    from focalformer3d_tpu_torch.tools import make_fake_checkpoint as fake
    from focalformer3d_tpu_torch.training import checkpoint as ckpt

    pth = tmp_path / "ref.pth"
    fake.main(["Tiny_L", str(pth), "--seed", "7"])
    report = conv.main(["Tiny_L", str(pth), str(tmp_path / "conv"),
                        "--require-full"])
    assert report.full and len(report.loaded) == 421
    ref = torch.load(pth, weights_only=True)["state_dict"]
    model = FocalFormer3D(get_config("Tiny_L")["model"])
    ckpt.restore_checkpoint(str(tmp_path / "conv"), model)  # strict
    for k, v in model.state_dict().items():
        assert torch.equal(v, ref[k]), k
    run = test_cli.main([
        "Tiny_L", "--device", "cpu", "--data-root", str(dataset),
        "--checkpoint", str(tmp_path / "conv"), "--limit", "1",
        "--max-points", str(MAX_POINTS)])
    assert run.samples == 1


@pytest.mark.parametrize("fault", ["dropped", "extra", "reshaped"])
def test_convert_require_full_fails_on_a_fault(tmp_path, fault, capsys):
    from focalformer3d_tpu_torch.tools import convert_checkpoint as conv
    from focalformer3d_tpu_torch.tools import make_fake_checkpoint as fake

    pth = tmp_path / "ref.pth"
    fake.write("Tiny_L", str(pth), seed=1)
    payload = torch.load(pth, weights_only=True)
    sd = payload["state_dict"]
    key = "pts_bbox_head.class_encoding.weight"
    if fault == "dropped":
        del sd[key]
    elif fault == "extra":
        sd["pts_bbox_head.no_such.weight"] = torch.zeros(3)
    else:
        sd[key] = sd[key][:-1]
    torch.save(payload, pth)
    with pytest.raises(SystemExit, match="incomplete"):
        conv.main(["Tiny_L", str(pth), str(tmp_path / "full"),
                   "--require-full"])
    assert not (tmp_path / "full").exists()
    report = conv.main(["Tiny_L", str(pth), str(tmp_path / "partial")])
    assert not report.full
    assert {"dropped": report.missing, "extra": report.unexpected,
            "reshaped": [m[0] for m in report.mismatched]}[fault] == [
        "pts_bbox_head.no_such.weight" if fault == "extra" else key]
    assert (tmp_path / "partial" / "state.pt").exists()


# ---------------------------------------------------------------------------
# DeformFormer3D with dynamic voxelization in the train CLI
# ---------------------------------------------------------------------------

def test_train_cli_on_dynamic_deform(dataset, tmp_path, monkeypatch,
                                     capsys):
    """The nuScenes branch with a ``DynamicSimpleVFE`` DeformFormer3D:
    Tiny_L with the DeformFormer3D deltas (the real configs' full width
    does not fit a CPU test), injected as the config the CLI loads."""
    import dataclasses

    from focalformer3d_tpu_torch import configs

    cfg_all = configs.deform_deltas(get_config("Tiny_L"))
    cfg_all["model"] = dataclasses.replace(cfg_all["model"],
                                           vfe_type="DynamicSimpleVFE")
    monkeypatch.setattr(train_cli, "load_config", lambda name: cfg_all)
    run = train_cli.main([
        "DeformFormer3D_L_dynamic", "--device", "cpu", "--data-root",
        str(dataset), "--epochs", "1", "--iters-per-epoch", "2",
        "--log-interval", "1", "--max-points", str(MAX_POINTS),
        "--work-dir", str(tmp_path / "work"), "--no-tensorboard"])
    assert capsys.readouterr().out.count("loss=") == 2
    assert run.opt_state.count == 2
    assert run.model.cfg.vfe_type == "DynamicSimpleVFE"
    assert not any(".roi_mlp." in k for k in run.model.state_dict())


def test_import_walk_covers_the_dataset_modules():
    from test_torch_imports import _port_files

    files = {str(f.relative_to(REPO)) for f in _port_files()}
    for mod in ("data/transforms.py", "data/nuscenes.py",
                "data/pipelines.py", "data/native/__init__.py",
                "core/eval_nuscenes.py", "core/results.py",
                "tools/test.py", "tools/create_data.py",
                "tools/print_config.py"):
        assert "focalformer3d_tpu_torch/" + mod in files, mod

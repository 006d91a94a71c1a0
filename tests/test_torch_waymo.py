"""The Waymo data layer, evaluator and test CLI, the port against JAX.

- ``data/waymo.py`` and ``core/eval_waymo.py`` are the port's own copies
  of the JAX package's numpy modules: their code equals the originals'
  line for line below the module docstring;
- ``box_camera_to_lidar`` on the calibrations of ``tests/test_waymo.py``
  (the KITTI axis swap, and a rotated and shifted one), bit for bit;
  ``get_sample`` on the fixtures of ``tests/test_waymo.py`` (a DontCare
  row, no difficulty keys) and ``tests/test_waymo_e2e.py`` (identity
  calibration), and on a directory that ``synthetic_dirs.write_waymo`` writes
  (non-identity calibration, LEVEL_2-only boxes), with ``load_interval``
  and under both packages' train and test pipelines, bit for bit;
- the evaluator on every case of ``tests/test_eval_waymo.py``: each case
  runs on the JAX module with its public functions wrapped so that every
  call also runs the port's function on the same inputs and holds the
  results within 1e-12;
- the port's test CLI on ``Tiny_Waymo_L`` over a written directory: each
  frame's eval pass equal to JAX's eval step on the JAX CLI's batch (boxes
  and scores within 1e-4 of scale, labels and masks exactly), the ground
  truth with its ``l2_only`` flags equal to the JAX CLI's, the metrics
  equal to JAX's evaluator on the same predictions, and the ``--tta``
  loop's ground truth the same;
- the train CLI's Waymo branch: its first batches equal, bit for bit, the
  batches that the JAX CLI's Waymo branch hands its loop for one
  ``--seed`` (``Tiny_Waymo_L``, and ``DeformFormer3D_Waymo15_L`` whose
  ``load_interval`` 5 leaves 2 of 6 frames); ``Tiny_Waymo_L`` trains 2
  steps on the CPU and the test CLI loads its checkpoint.
"""
import ast
import dataclasses
import inspect
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_eval_waymo
from focalformer3d_tpu.core import eval_waymo as jew
from focalformer3d_tpu.data import nuscenes as jnusc
from focalformer3d_tpu.data import pipelines as jpl
from focalformer3d_tpu.data import waymo as jwaymo
from focalformer3d_tpu.training import train_step as jts
from focalformer3d_tpu.utils.convert import convert_tree
from focalformer3d_tpu_torch.configs import get_config
from focalformer3d_tpu_torch.core import eval_waymo as tew
from focalformer3d_tpu_torch.data import synthetic_dirs
from focalformer3d_tpu_torch.data import pipelines as tpl
from focalformer3d_tpu_torch.data import waymo as twaymo
from focalformer3d_tpu_torch.models.detector import FocalFormer3D
from focalformer3d_tpu_torch.tools import test as test_cli
from focalformer3d_tpu_torch.training import train_step as tts
from focalformer3d_tpu_torch.utils.ref_keys import make_fake_state_dict
from test_waymo import TestWaymoDataset, _rt
from test_waymo_e2e import _make_fixture

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
EVAL_TOL = 1e-4
METRIC_TOL = 1e-12
MAX_POINTS = 6000


def _same(a, b, msg=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (msg, a.dtype, b.dtype,
                                                       a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=msg)


def _same_sample(t, j):
    assert set(t) == set(j), set(t) ^ set(j)
    for k in j:
        _same(t[k], j[k], k)


# ---------------------------------------------------------------------------
# the copies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("port,orig", [
    ("focalformer3d_tpu_torch/data/waymo.py",
     "focalformer3d_tpu/data/waymo.py"),
    ("focalformer3d_tpu_torch/core/eval_waymo.py",
     "focalformer3d_tpu/core/eval_waymo.py"),
])
def test_copies_equal_their_originals(port, orig):
    """Below the module docstring the port's module is the JAX module's
    code; the docstrings of its functions may speak of the port, so they
    are set aside."""
    def code(path):
        src = (REPO / path).read_text()
        tree = ast.parse(src[src.index("from __future__"):])
        for n in ast.walk(tree):
            if isinstance(n, (ast.FunctionDef, ast.ClassDef)) and \
                    isinstance(n.body[0], ast.Expr) and \
                    isinstance(n.body[0].value, ast.Constant):
                n.body = n.body[1:] or [ast.Pass()]
        return ast.dump(tree)

    assert code(port) == code(orig)


# ---------------------------------------------------------------------------
# box_camera_to_lidar and get_sample
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("calib", ["axis_swap", "rotated"])
def test_box_camera_to_lidar_equals_jax(calib):
    rng = np.random.RandomState(1)
    if calib == "axis_swap":
        trv2c = np.array([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0],
                          [0, 0, 0, 1.0]])
        rect = np.eye(4)
    else:
        trv2c, rect = _rt(0.3, [0.2, -0.1, 0.5]), _rt(-0.05, [0, 0, 0])
    cam = np.concatenate([rng.uniform(-20, 20, (9, 3)),
                          rng.uniform(0.5, 5, (9, 3)),
                          rng.uniform(-np.pi, np.pi, (9, 1))], 1)
    _same(twaymo.box_camera_to_lidar(cam, rect, trv2c),
          jwaymo.box_camera_to_lidar(cam, rect, trv2c))
    _same(twaymo.box_camera_to_lidar(cam[:0], rect, trv2c),
          jwaymo.box_camera_to_lidar(cam[:0], rect, trv2c))


def _datasets(ann, root, **kw):
    return (twaymo.WaymoDataset(str(ann), data_root=str(root), **kw),
            jwaymo.WaymoDataset(str(ann), data_root=str(root), **kw))


def test_get_sample_on_the_reader_fixture(tmp_path):
    """``tests/test_waymo.py``'s fixture: three frames, a DontCare row each,
    no difficulty or point-count keys (every box LEVEL_1)."""
    ann = TestWaymoDataset()._write(tmp_path)
    t, j = _datasets(ann, tmp_path)
    assert len(t) == len(j) == 3
    for i in range(3):
        ts, js = t.get_sample(i), j.get_sample(i)
        _same_sample(ts, js)
        assert ts["gt_boxes"].shape == (2, 9) and not ts["gt_l2_only"].any()


def test_get_sample_on_the_e2e_fixture(tmp_path):
    _make_fixture(tmp_path)
    t, j = _datasets(tmp_path / "waymo_infos_val.pkl", tmp_path)
    for i in range(2):
        _same_sample(t.get_sample(i), j.get_sample(i))


@pytest.fixture(scope="module")
def waymo_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("waymo")
    cfg_all = get_config("Tiny_Waymo_L")
    synthetic_dirs.write_waymo(
        root, seed=2, frames=6, points=3000,
        pc_range=cfg_all["model"].voxel.point_cloud_range,
        classes=cfg_all["class_names"], boxes=6)
    return root


def test_written_directory(waymo_dir):
    """``write_waymo``'s boxes come back through the camera frame: the
    boxes ``make_scene`` drew, in the LiDAR frame, within float32
    rounding; DontCare dropped; some boxes LEVEL_2 only."""
    from focalformer3d_tpu_torch.data import synthetic

    cfg_all = get_config("Tiny_Waymo_L")
    infos = pickle.load(open(waymo_dir / "waymo_infos_val.pkl", "rb"))
    assert len(infos) == 6
    assert not np.allclose(infos[0]["calib"]["R0_rect"], np.eye(4))
    ds = twaymo.WaymoDataset(str(waymo_dir / "waymo_infos_val.pkl"),
                             data_root=str(waymo_dir))
    rng = np.random.RandomState(2)
    l2 = 0
    for i in range(6):
        pts, gt, labels = synthetic.make_scene(
            rng, n_points=3000, n_boxes=6, num_classes=3,
            pc_range=cfg_all["model"].voxel.point_cloud_range, mode="radial")
        rng.uniform(0.0, 1.0, (len(pts), 1))  # the sixth column
        s = ds.get_sample(i)
        _same(s["points"], pts)
        np.testing.assert_allclose(s["gt_boxes"][:, :7], gt[:, :7],
                                   atol=2e-5, rtol=1e-5)
        assert (s["gt_boxes"][:, 7:] == 0).all()
        assert list(s["gt_names"]) == [cfg_all["class_names"][k]
                                       for k in labels]
        l2 += int(s["gt_l2_only"].sum())
        rng = _advance(rng, len(gt))
    assert 0 < l2 < 36


def _advance(rng, n_boxes):
    """The rest of a frame's draws in ``write_waymo`` after the sixth
    column: the calibration's angles and shift, the difficulties."""
    rng.uniform(-0.02, 0.02)
    rng.uniform(-0.05, 0.05)
    rng.uniform(-0.3, 0.3, 3)
    rng.choice([0, 0, 1, 2], n_boxes)
    return rng


@pytest.mark.parametrize("mode", ["train", "test"])
@pytest.mark.parametrize("load_interval", [1, 5])
def test_get_sample_under_the_pipelines_equals_jax(waymo_dir, mode,
                                                   load_interval):
    """Both packages' Waymo datasets under their own train pipeline
    (without GT-paste, as both train CLIs build it for Waymo) or test
    pipeline, one ``RandomState`` each: every sample bit for bit;
    ``load_interval`` 5 keeps frames 0 and 5."""
    cfg_all = get_config("Tiny_Waymo_L")
    pcr, classes = cfg_all["model"].voxel.point_cloud_range, \
        cfg_all["class_names"]
    if mode == "train":
        pipes = (tpl.train_pipeline(pcr, classes, db_sampler=None),
                 jpl.train_pipeline(pcr, classes, db_sampler=None))
    else:
        pipes = (tpl.test_pipeline(pcr), jpl.test_pipeline(pcr))
    ann = waymo_dir / "waymo_infos_train.pkl"
    t = twaymo.WaymoDataset(str(ann), data_root=str(waymo_dir),
                            classes=classes, pipeline=pipes[0],
                            load_interval=load_interval,
                            test_mode=mode == "test")
    j = jwaymo.WaymoDataset(str(ann), data_root=str(waymo_dir),
                            classes=classes, pipeline=pipes[1],
                            load_interval=load_interval,
                            test_mode=mode == "test")
    assert len(t) == len(j) == (6 if load_interval == 1 else 2)
    assert [i["image"]["image_idx"] for i in t.infos] == \
        [i["image"]["image_idx"] for i in j.infos]
    rt, rj = np.random.RandomState(4), np.random.RandomState(4)
    for i in range(len(t)):
        _same_sample(t.get_sample(i, rt), j.get_sample(i, rj))


# ---------------------------------------------------------------------------
# the evaluator on every case of tests/test_eval_waymo.py
# ---------------------------------------------------------------------------

EVAL_CASES = [n for n, f in inspect.getmembers(test_eval_waymo,
                                               inspect.isfunction)
              if n.startswith("test_")]
WRAPPED = ("evaluate_detections", "accumulate_class", "iou3d_matrix",
           "_match_optimal", "_heading_acc")


def _held(a, b, msg):
    if isinstance(a, dict):
        assert set(a) == set(b), msg
        for k in a:
            _held(a[k], b[k], f"{msg}[{k}]")
    elif isinstance(a, tuple):
        assert len(a) == len(b), msg
        for i, (x, y) in enumerate(zip(a, b)):
            _held(x, y, f"{msg}[{i}]")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, msg
        if np.issubdtype(a.dtype, np.floating):
            assert np.all(np.abs(a - b) <= METRIC_TOL), msg
        else:
            _same(a, b, msg)


def test_eval_cases_cover_the_module():
    assert len(EVAL_CASES) == 11


@pytest.mark.parametrize("case", EVAL_CASES)
def test_evaluator_on_the_jax_cases(case, monkeypatch, tmp_path):
    calls = dict.fromkeys(WRAPPED, 0)
    for name in WRAPPED:
        orig, port = getattr(jew, name), getattr(tew, name)

        def wrapped(*a, _orig=orig, _port=port, _name=name, **k):
            ref = _orig(*a, **k)
            _held(_port(*a, **k), ref, _name)
            calls[_name] += 1
            return ref

        monkeypatch.setattr(jew, name, wrapped)
    getattr(test_eval_waymo, case)()
    if case == "test_l1_l2_split_semantics":
        # the data layer's LEVEL_2 definition: no evaluator call; the
        # port's get_sample holds it on the case's values
        assert sum(calls.values()) == 0
        _check_l2_definition(tmp_path)
    else:
        assert sum(calls.values()) > 0, calls


def _check_l2_definition(root):
    diff = np.asarray([0, 2, 0, 0, 1], np.int32)
    npts = np.asarray([100, 100, 5, 6, 4], np.int32)
    (root / "p").mkdir()
    np.zeros((4, 6), np.float32).tofile(root / "p" / "0.bin")
    info = {"image": {"image_idx": 0},
            "point_cloud": {"velodyne_path": "p/0.bin"},
            "calib": {"R0_rect": np.eye(4), "Tr_velo_to_cam": np.eye(4)},
            "annos": {"name": np.asarray(["Car"] * 5, object),
                      "location": np.zeros((5, 3)),
                      "dimensions": np.ones((5, 3)),
                      "rotation_y": np.zeros(5),
                      "difficulty": diff, "num_points_in_gt": npts}}
    with open(root / "i.pkl", "wb") as f:
        pickle.dump([info], f)
    t, j = _datasets(root / "i.pkl", root)
    ts = t.get_sample(0)
    _same_sample(ts, j.get_sample(0))
    np.testing.assert_array_equal(ts["gt_l2_only"],
                                  [False, True, True, False, True])


# ---------------------------------------------------------------------------
# the test CLI against JAX's eval step and evaluator
# ---------------------------------------------------------------------------

def _jax_config(tm):
    from focalformer3d_tpu.models import detector as jdet
    from focalformer3d_tpu.models import focal_decoder as jfd
    from focalformer3d_tpu.models import lss as jlss
    from focalformer3d_tpu.ops import voxelize as jvox

    d = dataclasses.asdict(tm)
    return jdet.DetectorConfig(**{
        **d, "voxel": jvox.VoxelConfig(**d["voxel"]),
        "lss": jlss.LSSConfig(**d["lss"]),
        "decoder": jfd.FocalDecoderConfig(**d["decoder"])})


def _jax_cli_samples(root, cfg_all, n):
    """The JAX test CLI's Waymo samples (``tools/test.py``: the dataset
    under the test pipeline, ``RandomState(0)``), its batches (``collate``)
    and its ground truth per token."""
    cfg, classes = cfg_all["model"], list(cfg_all["class_names"])
    ds = jwaymo.WaymoDataset(
        str(root / "waymo_infos_val.pkl"), data_root=str(root),
        classes=classes,
        pipeline=jpl.test_pipeline(cfg.voxel.point_cloud_range),
        test_mode=True)
    rng = np.random.RandomState(0)
    batches, gt = [], {}
    for i in range(n):
        s = ds.get_sample(i, rng)
        b = jnusc.collate([s], classes, max_points=MAX_POINTS,
                          max_gts=cfg.decoder.max_gts // 4)
        b.pop("tokens")
        batches.append(b)
        names = s["gt_names"]
        keep = [j for j, nm in enumerate(names) if nm in classes]
        gt[s["token"]] = {
            "boxes": s["gt_boxes"][keep],
            "labels": np.asarray([classes.index(names[j]) for j in keep],
                                 np.int32),
            "l2_only": np.asarray(s["gt_l2_only"])[keep]}
    return batches, gt


def _recording_cli(argv):
    passes = []
    real = tts.make_eval_step

    def recording(cfg, max_out=200):
        step = real(cfg, max_out)

        def run(model, batch):
            dec = step(model, batch)
            passes.append(({k: v.numpy().copy() for k, v in batch.items()},
                           {k: v.clone() for k, v in dec.items()}))
            return dec

        return run

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tts, "make_eval_step", recording)
        run = test_cli.main(argv)
    return run, passes


@pytest.fixture(scope="module")
def cli_run(waymo_dir):
    return _recording_cli([
        "Tiny_Waymo_L", "--device", "cpu", "--data-root", str(waymo_dir),
        "--limit", "3", "--seed", "3", "--max-points", str(MAX_POINTS),
        "--max-out", "16", "--out", str(waymo_dir / "ignored.json")])


def test_test_cli_equals_jax_eval_step_and_evaluator(waymo_dir, cli_run):
    run, passes = cli_run
    cfg_all = get_config("Tiny_Waymo_L")
    classes = list(cfg_all["class_names"])
    tm = cfg_all["model"]
    assert run.samples == len(passes) == 3 and run.submission is None
    assert not (waymo_dir / "ignored.json").exists()  # no Waymo submission
    jbatches, jgt = _jax_cli_samples(waymo_dir, cfg_all, 3)
    for (tb, _), jb in zip(passes, jbatches):
        assert set(tb) == set(jb)
        for k in jb:
            _same(tb[k], jb[k], k)
    # the ground truth, with its LEVEL_2-only flags
    assert list(run.ground_truth) == list(jgt)
    for token, g in jgt.items():
        _same_sample(run.ground_truth[token], g)
    assert sum(int(g["l2_only"].sum()) for g in jgt.values()) > 0

    # each pass against JAX's eval step, from the same weights
    sd = {k: v.numpy() for k, v in
          make_fake_state_dict(FocalFormer3D(tm), seed=3).items()}
    jm = _jax_config(tm)
    from focalformer3d_tpu.models.detector import FocalFormer3D as JaxFF3D
    from focalformer3d_tpu.models.detector import preprocess_points

    jb0 = {k: jnp.asarray(v) for k, v in jbatches[0].items()}
    model = JaxFF3D(jm)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, preprocess_points(
            jm, jb0["points"], jb0["points_mask"]), None, False))
    variables, report = convert_tree(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes), sd)
    assert report.full and not report.unloaded, report.summary()
    eval_step = jax.jit(jts.make_eval_step(jm, 16))
    jpred = {}
    for i, ((_, dec), jb) in enumerate(zip(passes, jbatches)):
        ref = jax.device_get(eval_step(
            variables["params"], variables["batch_stats"],
            {k: jnp.asarray(v) for k, v in jb.items()}))
        for k in ("mask", "labels"):
            _same(dec[k].numpy(), ref[k], f"frame {i} {k}")
        for k in ("scores", "bboxes"):
            got, want = dec[k].numpy(), np.asarray(ref[k], np.float32)
            err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-3)
            assert err <= EVAL_TOL, f"frame {i} {k}: rel err {err:.3g}"
        m = np.asarray(ref["mask"])[0]
        jpred[list(jgt)[i]] = {"boxes": np.asarray(ref["bboxes"])[0][m],
                               "scores": np.asarray(ref["scores"])[0][m],
                               "labels": np.asarray(ref["labels"])[0][m]}
    assert dec["bboxes"].shape[-1] == 7
    # the metrics: JAX's evaluator on the port's predictions and ground
    # truth, and the keys and range on JAX's own predictions
    want = jew.evaluate_detections(run.predictions, run.ground_truth,
                                   classes)
    _held(run.metrics, want, "metrics")
    keys = {f"L{lv}/{m}" for lv in (1, 2) for m in ("mAP", "mAPH")}
    keys |= {f"L{lv}/{c}_{m}" for lv in (1, 2) for c in classes
             for m in ("AP", "APH")}
    assert set(run.metrics) == keys
    jmet = jew.evaluate_detections(jpred, jgt, classes)
    assert set(jmet) == keys
    assert all(0.0 <= v <= 1.0 for v in run.metrics.values())
    assert run.seconds_eval > 0


def test_test_cli_tta_carries_the_l2_flags(waymo_dir, cli_run):
    """``--tta`` (the double flip, 4 passes a frame): the same ground
    truth, ``l2_only`` included, as the plain loop."""
    run, passes = _recording_cli([
        "Tiny_Waymo_L", "--device", "cpu", "--data-root", str(waymo_dir),
        "--limit", "2", "--seed", "3", "--max-points", str(MAX_POINTS),
        "--max-out", "16", "--tta"])
    assert run.passes == 4 and len(passes) == 8
    plain = cli_run[0].ground_truth
    assert list(run.ground_truth) == list(plain)[:2]
    for token, g in run.ground_truth.items():
        assert set(g) == {"boxes", "labels", "l2_only"}
        _same_sample(g, plain[token])
    assert all(np.isfinite(v) for v in run.metrics.values())


# ---------------------------------------------------------------------------
# the train CLI's Waymo branch
# ---------------------------------------------------------------------------

def _jax_train_cli():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jax_train_cli", REPO / "tools" / "train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _first_batches(batch_iter, n=2):
    return [{k: np.asarray(v) for k, v in b.items()}
            for b, _ in zip(batch_iter(0), range(n))]


@pytest.mark.parametrize("name", ["Tiny_Waymo_L", "DeformFormer3D_Waymo15_L"])
def test_train_cli_batches_equal_jax(waymo_dir, tmp_path, monkeypatch, name):
    """The first two batches that each CLI's Waymo branch hands its loop,
    bit for bit, for one ``--seed`` (the JAX CLI with its state
    initialisation and its loop replaced); DeformFormer3D_Waymo15_L's
    ``load_interval`` 5 leaves frames 0 and 5, one batch of 2 an epoch."""
    import sys

    from focalformer3d_tpu.training import loop as jloop
    from focalformer3d_tpu.training import train_step as jstep
    from focalformer3d_tpu.training.train_step import TrainState
    from focalformer3d_tpu_torch.tools import train as train_cli
    from focalformer3d_tpu_torch.training import loop as tloop

    args = [name, "--data-root", str(waymo_dir), "--epochs", "2",
            "--batch-size", "2", "--seed", "5", "--max-points",
            str(MAX_POINTS), "--no-tensorboard"]
    got = {}

    def jax_loop(step, state, batch_iter, **kw):
        got["jax"] = _first_batches(batch_iter)

    def port_loop(step, model, opt_state, batch_iter, **kw):
        got["port"] = _first_batches(batch_iter)

    monkeypatch.setattr(jstep, "create_train_state", lambda *a: (None, (
        TrainState({}, {}, (), jnp.zeros((), jnp.int32)))))
    monkeypatch.setattr(jloop, "run_training", jax_loop)
    monkeypatch.setattr(sys, "argv", [
        "train.py", *args, "--work-dir", str(tmp_path / "jax")])
    _jax_train_cli().main()
    monkeypatch.setattr(tloop, "run_training", port_loop)
    train_cli.main([*args, "--device", "cpu", "--work-dir",
                    str(tmp_path / "port")])
    n = 2 if name == "Tiny_Waymo_L" else 1
    assert len(got["jax"]) == len(got["port"]) == n
    for b_port, b_jax in zip(got["port"], got["jax"]):
        assert set(b_port) == set(b_jax)
        for k in b_jax:
            _same(b_port[k], b_jax[k], k)
        assert b_port["gt_valid"].any() and b_port["gt_boxes"].shape[-1] == 9


def test_train_cli_trains_on_a_waymo_directory(waymo_dir, tmp_path):
    """Tiny_Waymo_L, 2 epochs of 1 step at batch 2 on the CPU: finite
    losses, ``epoch_2`` saved; the test CLI loads it."""
    import json

    from focalformer3d_tpu_torch.tools import train as train_cli
    from focalformer3d_tpu_torch.training import checkpoint as ckpt

    work = tmp_path / "work"
    train_cli.main(["Tiny_Waymo_L", "--device", "cpu", "--data-root",
                    str(waymo_dir), "--epochs", "2", "--iters-per-epoch",
                    "1", "--max-points", str(MAX_POINTS), "--log-interval",
                    "1", "--work-dir", str(work), "--no-tensorboard"])
    recs = [json.loads(x) for x in open(work / "train_log.jsonl")]
    losses = [r["loss"] for r in recs if r["mode"] == "train"]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert 2 in ckpt.list_epochs(str(work))
    run = test_cli.main(["Tiny_Waymo_L", "--device", "cpu", "--data-root",
                         str(waymo_dir), "--checkpoint",
                         str(work / "epoch_2"), "--limit", "2",
                         "--max-points", str(MAX_POINTS)])
    assert run.samples == 2 and all(np.isfinite(v)
                                    for v in run.metrics.values())

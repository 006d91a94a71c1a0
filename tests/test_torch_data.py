"""The port's data layer against the JAX package's, bit for bit.

``focalformer3d_tpu_torch/data/`` keeps its own copies of the numpy data
modules (transforms, the nuScenes reader, GT-paste, collation, the native
point loader) and of ``tools/create_data.create_gt_database``. Each case
feeds a port function and its JAX original the same inputs and the same
``numpy.random.RandomState`` seed and asserts equal arrays, on the fixture
layout of ``tests/test_data.py`` (``_write_fake_nuscenes`` and the dbinfo
fixture of ``TestDBSampler``). Also: the native loader against the port's
numpy path (1e-5, as ``tests/test_data.py`` holds the JAX pair: the
numpy path's matmul sums in another order) and against the JAX native
loader (bit for bit, one source, one compiler command); a native build
that fails raises with the compiler's message instead of falling back;
``Fading`` drops ``ObjectSample`` from a ``Compose`` from its epoch on.
The camera stages of the pipelines have JAX's names and order, and the
fake directory with six cameras a sample (the port's JPEG writer) reads
into JAX's arrays (``tests/test_torch_camera_data.py`` holds the camera
layer in full).
"""
import importlib.util
import pickle
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from focalformer3d_tpu.data import nuscenes as jnusc
from focalformer3d_tpu.data import pipelines as jpl
from focalformer3d_tpu.data import transforms as JT
from focalformer3d_tpu.data import native as jnative
from focalformer3d_tpu.training.loop import Fading as JFading
from focalformer3d_tpu_torch.data import native as tnative
from focalformer3d_tpu_torch.data import nuscenes as tnusc
from focalformer3d_tpu_torch.data import pipelines as tpl
from focalformer3d_tpu_torch.data import transforms as TT
from focalformer3d_tpu_torch.tools import create_data as tcreate
from focalformer3d_tpu_torch.training.loop import Fading as TFading

from test_data import _sample, _write_fake_nuscenes

REPO = Path(__file__).resolve().parent.parent
PCR = (-54, -54, -5, 54, 54, 3)


def _jax_create_data():
    spec = importlib.util.spec_from_file_location(
        "jax_create_data", REPO / "tools" / "create_data.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _assert_same(got, ref, path="sample"):
    """Equal structure, equal arrays (dtype and bits)."""
    if isinstance(ref, dict):
        assert set(got) == set(ref), (path, set(got) ^ set(ref))
        for k in ref:
            _assert_same(got[k], ref[k], f"{path}[{k!r}]")
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            _assert_same(g, r, f"{path}[{i}]")
    elif isinstance(ref, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == ref.dtype and got.shape == ref.shape, path
        np.testing.assert_array_equal(got, ref, err_msg=path)
    else:
        assert got == ref, path


def _two(fn_t, fn_j, seed):
    """Run a port transform and its original on equal copies of one
    sample with equal generators; return both outputs and generators."""
    s = _sample(seed=seed)
    rt, rj = np.random.RandomState(seed), np.random.RandomState(seed)
    st = {k: v.copy() for k, v in s.items()}
    sj = {k: v.copy() for k, v in s.items()}
    return fn_t(st, rt), fn_j(sj, rj), rt, rj


TRANSFORMS = {
    "rot_scale_trans": lambda M: M.GlobalRotScaleTrans(),
    "rot_scale_trans_wide": lambda M: M.GlobalRotScaleTrans(
        (-3.0, 3.0), (0.5, 1.5), (1.0, 2.0, 3.0)),
    "flip_both": lambda M: M.RandomFlip3D(1.0, 1.0),
    "flip_random": lambda M: M.RandomFlip3D(0.5, 0.5),
    "flip_none": lambda M: M.RandomFlip3D(0.0, 0.0),
    "points_range": lambda M: M.PointsRangeFilter((-10, -10, -5, 10, 10, 3)),
    "object_range": lambda M: M.ObjectRangeFilter((-10, -10, -5, 10, 10, 3)),
    "object_name": lambda M: M.ObjectNameFilter(["car", "bus"]),
    "shuffle": lambda M: M.PointShuffle(),
    "compose": lambda M: M.Compose([
        M.GlobalRotScaleTrans(), M.RandomFlip3D(), M.PointsRangeFilter(PCR),
        M.ObjectRangeFilter((-12, -12, -5, 12, 12, 3)),
        M.ObjectNameFilter(["car", "truck", "pedestrian"]),
        M.PointShuffle()]),
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_transform_equals_jax(name, seed):
    got, ref, rt, rj = _two(TRANSFORMS[name](TT), TRANSFORMS[name](JT), seed)
    _assert_same(got, ref)
    # the same draws, so the next draw agrees too
    assert rt.randint(1 << 30) == rj.randint(1 << 30)


def test_helpers_equal_jax():
    for a in (-2.0, 0.0, 0.3, np.pi):
        _assert_same(TT._rot_z(a), JT._rot_z(a))
    st, sj = {"points": np.ones((3, 5), np.float32)}, {
        "points": np.ones((3, 5), np.float32)}
    TT._ensure_aug(st)
    JT._ensure_aug(sj)
    R, t = TT._rot_z(0.7) * 1.1, np.array([1.0, -2.0, 0.5], np.float32)
    TT._apply_pts(st, R, t)
    JT._apply_pts(sj, R, t)
    _assert_same(st, sj)


def _dbinfo_fixture(tmp_path):
    """``tests/test_data.py``'s dbinfo fixture (TestDBSampler)."""
    rng = np.random.RandomState(0)
    dbinfos = {"car": [], "pedestrian": []}
    for i in range(5):
        pts = rng.uniform(-1, 1, (20, 5)).astype(np.float32)
        p = tmp_path / f"db_car_{i}.bin"
        pts.tofile(p)
        dbinfos["car"].append({
            "name": "car", "path": f"db_car_{i}.bin",
            "box3d_lidar": np.array(
                [5.0 + 4 * i, 0, -1.5, 4, 2, 1.5, 0.3], np.float32
            ),
            "num_points_in_gt": 20, "difficulty": 0,
        })
    dbp = tmp_path / "dbinfos.pkl"
    with open(dbp, "wb") as f:
        pickle.dump(dbinfos, f)
    return dbp


def _samplers(dbp, root, **kw):
    args = (str(dbp), str(root), ["car", "pedestrian"])
    kw = {"sample_groups": {"car": 3}, "min_points": {"car": 5}, **kw}
    return tnusc.DBSampler(*args, **kw), jnusc.DBSampler(*args, **kw)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_db_sampler_and_object_sample_equal_jax(tmp_path, seed):
    ts, js = _samplers(_dbinfo_fixture(tmp_path), tmp_path)
    _assert_same(ts.infos, js.infos)

    def prep(s):
        s["gt_names"] = np.array(["truck"] * 4, object)
        s["gt_boxes"][:, :2] = 40.0  # away from the database boxes
        return s

    got, ref, rt, rj = _two(lambda s, r: tnusc.ObjectSample(ts)(prep(s), r),
                            lambda s, r: jnusc.ObjectSample(js)(prep(s), r),
                            seed)
    _assert_same(got, ref)
    assert len(got["gt_boxes"]) > 4  # something was pasted
    r1, r2 = np.random.RandomState(seed), np.random.RandomState(seed)
    avoid = np.array([[9.0, 0, -1.5, 4, 2, 1.5, 0.3, 0, 0]], np.float32)
    _assert_same(ts.sample(avoid, np.array(["car"], object), r1),
                 js.sample(avoid, np.array(["car"], object), r2))


def test_db_sampler_filters_equal_jax(tmp_path):
    dbp = _dbinfo_fixture(tmp_path)
    ts, js = _samplers(dbp, tmp_path, min_points={"car": 21},
                       filter_difficulty=(0,))
    _assert_same(ts.infos, js.infos)
    empty = np.zeros((0, 9), np.float32), np.array([], object)
    _assert_same(ts.sample(*empty, np.random.RandomState(0)),
                 js.sample(*empty, np.random.RandomState(0)))


def test_geometry_equals_jax():
    rng = np.random.RandomState(4)
    pts = rng.uniform(-6, 6, (500, 3)).astype(np.float32)
    boxes = np.zeros((7, 9), np.float32)
    boxes[:, :3] = rng.uniform(-4, 4, (7, 3))
    boxes[:, 3:6] = rng.uniform(0.5, 4, (7, 3))
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, 7)
    _assert_same(tnusc.points_in_rbbox(pts, boxes),
                 jnusc.points_in_rbbox(pts, boxes))
    assert tnusc.points_in_rbbox(pts, boxes).any()
    _assert_same(tnusc.points_in_rbbox(pts, boxes[:0]),
                 jnusc.points_in_rbbox(pts, boxes[:0]))
    ct, cj = tnusc._rect_corners_bev(boxes), jnusc._rect_corners_bev(boxes)
    _assert_same(ct, cj)
    _assert_same(tnusc._rects_collide(ct[:3], ct[3:]),
                 jnusc._rects_collide(cj[:3], cj[3:]))
    _assert_same(tnusc._rects_collide(ct, ct[:0]),
                 jnusc._rects_collide(cj, cj[:0]))


def test_remove_close_equals_jax():
    p = np.random.RandomState(5).uniform(-2, 2, (200, 5)).astype(np.float32)
    _assert_same(tnusc._remove_close(p), jnusc._remove_close(p))
    _assert_same(tnusc._remove_close(p, 0.5), jnusc._remove_close(p, 0.5))


def _datasets(pkl, root, pipeline=None, **kw):
    """The port's and JAX's ``NuScenesDataset`` over one infos pkl, each
    with its own package's pipeline (``pipeline(module)``)."""
    return (tnusc.NuScenesDataset(str(pkl), str(root), pipeline=(
                pipeline(tpl, tnusc, root) if pipeline else None), **kw),
            jnusc.NuScenesDataset(str(pkl), str(root), pipeline=(
                pipeline(jpl, jnusc, root) if pipeline else None), **kw))


def _train_pipe(pl, nusc, root):
    sampler = nusc.DBSampler(
        str(root / "nuscenes_dbinfos_train.pkl"), str(root),
        nusc.CLASS_NAMES, sample_groups={"car": 3, "bus": 2,
                                         "pedestrian": 2},
        min_points={"car": 1})
    return pl.train_pipeline(PCR, nusc.CLASS_NAMES, db_sampler=sampler)


def _test_pipe(pl, nusc, root):
    return pl.test_pipeline(PCR)


@pytest.fixture
def fake(tmp_path):
    pkl = _write_fake_nuscenes(tmp_path)
    tcreate.create_gt_database(str(pkl), str(tmp_path), str(tmp_path),
                               sweeps_num=0)
    return pkl, tmp_path


@pytest.mark.parametrize("pipe,kw", [
    (None, {}), (_train_pipe, {}), (_test_pipe, {"test_mode": True}),
    (_train_pipe, {"sweeps_num": 1}), (None, {"use_valid_flag": False}),
    (_test_pipe, {"load_interval": 2})])
def test_get_sample_equals_jax(fake, pipe, kw):
    pkl, root = fake
    tds, jds = _datasets(pkl, root, pipe, **kw)
    assert len(tds) == len(jds) > 0
    _assert_same(tds.infos, jds.infos)
    rt, rj = np.random.RandomState(7), np.random.RandomState(7)
    for i in range(len(tds)):
        _assert_same(tds.get_sample(i, rt), jds.get_sample(i, rj))
    assert rt.randint(1 << 30) == rj.randint(1 << 30)


def test_cbgs_and_labels_equal_jax(fake):
    pkl, root = fake
    tds, jds = _datasets(pkl, root)
    _assert_same(tds.cat_sample_indices(), jds.cat_sample_indices())
    for seed in range(3):
        _assert_same(tds.cbgs_indices(np.random.RandomState(seed)),
                     jds.cbgs_indices(np.random.RandomState(seed)))
    names = np.array(["bus", "car", "traffic_cone"], object)
    _assert_same(tds.labels_from_names(names), jds.labels_from_names(names))


@pytest.mark.parametrize("max_points,max_gts", [(2000, 16), (300, 2)])
def test_collate_equals_jax(fake, max_points, max_gts):
    pkl, root = fake
    tds, jds = _datasets(pkl, root, _train_pipe)
    rt, rj = np.random.RandomState(3), np.random.RandomState(3)
    ts = [tds.get_sample(i, rt) for i in range(3)]
    js = [jds.get_sample(i, rj) for i in range(3)]
    for classes in (tnusc.CLASS_NAMES, ("car", "pedestrian")):
        _assert_same(
            tnusc.collate(ts, classes, max_points=max_points,
                          max_gts=max_gts),
            jnusc.collate(js, classes, max_points=max_points,
                          max_gts=max_gts))


def test_create_gt_database_equals_jax(tmp_path):
    pkl = _write_fake_nuscenes(tmp_path)
    out_t, out_j = tmp_path / "port", tmp_path / "jax"
    tcreate.create_gt_database(str(pkl), str(tmp_path), str(out_t))
    _jax_create_data().create_gt_database(str(pkl), str(tmp_path),
                                          str(out_j))
    db = []
    for out in (out_t, out_j):
        with open(out / "nuscenes_dbinfos_train.pkl", "rb") as f:
            db.append(pickle.load(f))
    _assert_same(db[0], db[1])
    files = sorted(p.name for p in (out_j / "nuscenes_gt_database").iterdir())
    assert files == sorted(
        p.name for p in (out_t / "nuscenes_gt_database").iterdir())
    assert files
    for name in files:
        assert ((out_t / "nuscenes_gt_database" / name).read_bytes()
                == (out_j / "nuscenes_gt_database" / name).read_bytes())


def test_pipelines_equal_jax_and_camera_raises():
    """(Named for what it checked before the camera data layer: that the
    camera stages raised.) Every stage list, the camera ones included,
    has JAX's stages in JAX's order; ``collate`` stacks the images."""
    t = tpl.train_pipeline(PCR, tnusc.CLASS_NAMES)
    j = jpl.train_pipeline(PCR, jnusc.CLASS_NAMES)
    assert [type(x).__name__ for x in t] == [type(x).__name__ for x in j]
    assert ([type(x).__name__ for x in tpl.test_pipeline(PCR)]
            == [type(x).__name__ for x in jpl.test_pipeline(PCR)])
    names = lambda ts: [type(x).__name__ for x in ts]  # noqa: E731
    for kw in ({}, {"image_aug": False}, {"img_scale": (64, 96)}):
        t = tpl.train_pipeline(PCR, tnusc.CLASS_NAMES, with_images=True, **kw)
        j = jpl.train_pipeline(PCR, jnusc.CLASS_NAMES, with_images=True, **kw)
        assert names(t) == names(j)
        assert names(t)[-3:-2] == (["ScaleImageMultiViewImage"]
                                   if kw.get("image_aug") is False
                                   else ["ImageAug3D"])
        assert vars(t[-3]) == vars(j[-3])
    t = tpl.test_pipeline(PCR, with_images=True, img_scale=(64, 96))
    j = jpl.test_pipeline(PCR, with_images=True, img_scale=(64, 96))
    assert names(t) == names(j) == [
        "PointsRangeFilter", "ScaleImageMultiViewImage",
        "NormalizeMultiviewImage", "PadMultiViewImage"]
    assert t[1].scales == j[1].scales == (96, 64)
    assert tpl.IMG_NORM_MEAN == jpl.IMG_NORM_MEAN
    assert tpl.IMG_NORM_STD == jpl.IMG_NORM_STD
    sample = {"imgs": [np.ones((4, 6, 3), np.float32)] * 6,
              "lidar2img": np.eye(4, dtype=np.float32)[None].repeat(6, 0),
              "img_aug": np.eye(4, dtype=np.float32)[None].repeat(6, 0),
              "bev_aug": np.eye(4), "points": np.zeros((1, 5))}
    tb = tnusc.collate([sample])
    jb = jnusc.collate([sample])
    for k in ("imgs", "lidar2img", "img_aug"):
        np.testing.assert_array_equal(tb[k], jb[k])
    assert tb["imgs"].shape == (1, 6, 4, 6, 3)
    assert tnusc.CLASS_NAMES == jnusc.CLASS_NAMES
    assert tnusc.DEFAULT_ATTRIBUTES == jnusc.DEFAULT_ATTRIBUTES


def _add_cameras(pkl, root, hw=(30, 48)):
    """Six cameras a sample for the fake directory: the synthetic ring
    rig and textured frames, written by the port's JPEG writer."""
    from focalformer3d_tpu_torch.data import image_io, synthetic

    rng = np.random.RandomState(9)
    with open(pkl, "rb") as f:
        data = pickle.load(f)
    for i, info in enumerate(data["infos"]):
        cams = dict(zip(tnusc.CAM_ORDER,
                        synthetic.ring_camera_infos(rng, 6, hw)))
        info["cams"] = cams
        pts = np.fromfile(info["lidar_path"], np.float32).reshape(-1, 5)
        frames = synthetic.camera_frames(
            rng, pts, tnusc.lidar2img_matrices(info), hw)
        for (name, cam), frame in zip(cams.items(), frames):
            cam["data_path"] = str(root / f"{name}_{i}.jpg")
            image_io.imwrite(cam["data_path"], frame)
    with open(pkl, "wb") as f:
        pickle.dump(data, f)


def test_dataset_with_images_raises(fake):
    """(Named for what it checked before the camera data layer: that
    ``with_images=True`` raised.) The dataset reads the fake directory's
    cameras: every sample equals JAX's (Pillow's decode there), with BGR
    images, ``lidar2img`` and identity ``img_aug``."""
    pkl, root = fake
    _add_cameras(pkl, root)
    ts = tnusc.NuScenesDataset(str(pkl), str(root), with_images=True)
    js = jnusc.NuScenesDataset(str(pkl), str(root), with_images=True)
    assert len(ts) == len(js) == 4
    for i in range(len(ts)):
        t = ts.get_sample(i, np.random.RandomState(i))
        j = js.get_sample(i, np.random.RandomState(i))
        _assert_same(t, j)
        assert len(t["imgs"]) == 6 and t["imgs"][0].shape == (30, 48, 3)
        rgb = np.asarray(Image.open(
            ts.infos[i]["cams"]["CAM_FRONT"]["data_path"]), np.float32)
        np.testing.assert_array_equal(t["imgs"][0], rgb[..., ::-1])
        np.testing.assert_array_equal(t["img_aug"], np.broadcast_to(
            np.eye(4, dtype=np.float32), (6, 4, 4)))


@pytest.mark.parametrize("test_mode", [True, False])
def test_native_loader_against_numpy_and_jax(fake, test_mode):
    pkl, root = fake
    infos = tnusc.NuScenesDataset(str(pkl), str(root)).infos
    assert jnative.get_lib() is not None  # the JAX loader's own build
    for info in infos:
        kw = dict(rng=np.random.RandomState(1), test_mode=test_mode)
        a = tnusc.load_points_multisweep(info, use_native=True, **kw)
        kw["rng"] = np.random.RandomState(1)
        b = tnusc.load_points_multisweep(info, use_native=False, **kw)
        kw["rng"] = np.random.RandomState(1)
        c = jnusc.load_points_multisweep(info, use_native=True, **kw)
        kw["rng"] = np.random.RandomState(1)
        d = jnusc.load_points_multisweep(info, use_native=False, **kw)
        assert a.shape == b.shape and a.shape[0] > 500
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        _assert_same(a, c)
        _assert_same(b, d)


def test_native_loader_counts_and_remove_close(tmp_path):
    pts = np.zeros((10, 5), np.float32)
    pts[:5, 0] = 0.5  # close in x and y=0 -> filtered
    pts[5:, 0] = 20.0
    p = tmp_path / "sweep.bin"
    pts.tofile(p)
    args = ([str(p)], np.eye(3, dtype=np.float32)[None],
            np.zeros((1, 3), np.float32), np.asarray([0.25], np.float32),
            np.asarray([1], np.uint8), np.asarray([1], np.uint8),
            np.asarray([1], np.uint8))
    tnative.reset_call_count()
    out = tnative.load_sweeps_native(*args)
    assert tnative.call_count() == 1
    _assert_same(out, jnative.load_sweeps_native(*args))
    assert out.shape == (5, 5) and (out[:, 0] == 20.0).all()
    assert (out[:, 4] == 0.25).all()
    with pytest.raises(ValueError, match="shape"):
        tnative.load_sweeps_native(args[0] * 2, *args[1:])


def test_failed_native_build_raises(tmp_path, monkeypatch, fake):
    """No fallback: a compiler that cannot run, or a source that does not
    compile, raises with the compiler's message, and so does a sample load
    that asks for the native loader."""
    pkl, root = fake
    info = tnusc.NuScenesDataset(str(pkl), str(root)).infos[0]
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "CXX", str(tmp_path / "no" / "g++"))
    with pytest.raises(RuntimeError, match="cannot run"):
        tnative.get_lib()
    with pytest.raises(RuntimeError, match="cannot run"):
        tnusc.load_points_multisweep(info)
    monkeypatch.setattr(tnative, "CXX", "g++")
    bad = tmp_path / "pointloader.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(tnative, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="error") as e:
        tnative.get_lib()
    assert "pointloader.cpp" in str(e.value)
    assert not list((tmp_path / "build").glob("*.so"))
    # the numpy path needs no build
    assert len(tnusc.load_points_multisweep(info, use_native=False)) > 500


def test_fading_drops_object_sample(tmp_path):
    ts, js = _samplers(_dbinfo_fixture(tmp_path), tmp_path)
    pipes = {
        "port": TT.Compose([tnusc.ObjectSample(ts), TT.PointShuffle()]),
        "jax": JT.Compose([jnusc.ObjectSample(js), JT.PointShuffle()])}
    hooks = {"port": TFading(2), "jax": JFading(2)}
    for epoch in range(4):
        kinds = {}
        for k in pipes:
            hooks[k].before_train_epoch(epoch, pipes[k])
            kinds[k] = [type(t).__name__ for t in pipes[k].transforms]
        assert kinds["port"] == kinds["jax"]
        assert ("ObjectSample" in kinds["port"]) == (epoch < 2), epoch
    TFading(0).before_train_epoch(5, None)  # no pipeline: nothing to do

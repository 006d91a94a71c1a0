"""The camera data layer, the port against the JAX package (Pillow there).

The JAX data layer decodes and resamples the cameras with Pillow; the port
with ``data/image_io`` (its own JPEG decoder and Pillow's geometry,
``tests/test_torch_image_io.py``). From one ``RandomState`` both give:

- ``ImageAug3D`` (train and test mode), ``ScaleImageMultiViewImage``,
  ``NormalizeMultiviewImage`` and ``PadMultiViewImage``: the images and
  ``img_aug`` bit for bit, the same draws, at a small size and on two
  1600 x 900 cameras;
- ``NuScenesDataset(with_images=True).get_sample`` through the train and
  the test pipeline, and ``collate``, on a 2-sample directory with six
  90 x 160 cameras (``synthetic_dirs.write_nuscenes(cameras=True)``): images,
  ``lidar2img``, ``img_aug``, ``bev_aug``, points and boxes bit for bit;
- the test CLI with ``--tta`` on a tiny LC config with
  ``FocalFormer3D_LC_TTA``'s ``tta`` (3 scales x the double flip, 12
  passes): each pass's batch equals the one the JAX CLI's code path
  builds, and the port's eval step on it answers as JAX's jitted
  ``make_eval_step`` does (labels and mask exactly, scores and boxes within
  ``EVAL_TOL`` of their scale, as ``tests/test_torch_camera_model.py``);
- the TTA passes flip and scale only the points (the JAX CLI's loop), so
  the camera BEV of a flipped pass is the unflipped pass's, bit for bit in
  both packages, while the LiDAR BEV moves (ROADMAP.md Queue 3).
"""
import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focalformer3d_tpu.core.merge_augs import tta_augs as jax_tta_augs
from focalformer3d_tpu.data import nuscenes as jnusc
from focalformer3d_tpu.data import pipelines as jpl
from focalformer3d_tpu.data import transforms as JT
from focalformer3d_tpu.models import detector as jdet
from focalformer3d_tpu.models import focal_decoder as jfd
from focalformer3d_tpu.models import lss as jlss
from focalformer3d_tpu.ops import voxelize as jvox
from focalformer3d_tpu.training import train_step as jts
from focalformer3d_tpu_torch import configs as tconfigs
from focalformer3d_tpu_torch.data import image_io, synthetic_dirs
from focalformer3d_tpu_torch.data import nuscenes as tnusc
from focalformer3d_tpu_torch.data import pipelines as tpl
from focalformer3d_tpu_torch.data import transforms as TT
from focalformer3d_tpu_torch.models.detector import FocalFormer3D
from focalformer3d_tpu_torch.tools import test as test_cli
from focalformer3d_tpu_torch.training import train_step as tts
from focalformer3d_tpu_torch.utils.ref_keys import make_fake_state_dict
from test_torch_camera_cli import _tiny_lc
from test_torch_camera_model import EVAL_TOL, IMG_KEYS, _jax_variables

torch.set_num_threads(2)
CAM_HW = (90, 160)
FINAL = (40, 72)
MAX_POINTS = 6000
LC_TTA = tconfigs.get_config("FocalFormer3D_LC_TTA")["tta"]


def _cams(seed, n=6, hw=CAM_HW):
    """Decoded cameras as the dataset hands them on: uint8 values in
    float32, BGR."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:hw[0], 0:hw[1]]
    base = np.stack([x * 255 // hw[1], y * 255 // hw[0], (x + y) % 256], -1)
    return [np.clip(base + rng.randint(-30, 31, base.shape), 0, 255)
            .astype(np.float32)[..., ::-1] for _ in range(n)]


def _same(a, b, msg=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (msg, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=msg)


def _same_sample(t, j):
    assert set(t) == set(j)
    for k in j:
        if k == "imgs":
            assert len(t[k]) == len(j[k])
            for i, (a, b) in enumerate(zip(t[k], j[k])):
                _same(a, b, f"imgs[{i}]")
        elif isinstance(j[k], (np.ndarray, list)):
            _same(t[k], j[k], k)
        else:
            assert t[k] == j[k], k


# ---------------------------------------------------------------------------
# the image transforms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("is_train", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_image_aug3d_equals_jax(seed, is_train):
    kw = dict(final_dim=FINAL, resize_lim=(0.4, 0.6), bot_pct_lim=(0.0, 0.0),
              rot_lim=(-5.4, 5.4), rand_flip=True, is_train=is_train)
    rt, rj = np.random.RandomState(seed), np.random.RandomState(seed)
    t = TT.ImageAug3D(**kw)({"imgs": _cams(seed)}, rt)
    j = JT.ImageAug3D(**kw)({"imgs": _cams(seed)}, rj)
    _same_sample(t, j)
    assert rt.randint(1 << 30) == rj.randint(1 << 30)  # the same draws


def test_image_aug3d_on_cameras_equals_jax():
    """Two nuScenes-size cameras at the recipe's 448 x 800."""
    cams = _cams(5, n=2, hw=(900, 1600))
    kw = dict(final_dim=(448, 800), is_train=True)
    t = TT.ImageAug3D(**kw)({"imgs": list(cams)}, np.random.RandomState(7))
    j = JT.ImageAug3D(**kw)({"imgs": list(cams)}, np.random.RandomState(7))
    _same_sample(t, j)
    s = {"imgs": list(cams)}
    _same_sample(TT.ScaleImageMultiViewImage((800, 448))(dict(s)),
                 JT.ScaleImageMultiViewImage((800, 448))(dict(s)))


@pytest.mark.parametrize("scales", [(72, 40), (160, 90), (200, 100)])
def test_scale_normalize_pad_equal_jax(scales):
    steps = [("ScaleImageMultiViewImage", (scales,)),
             ("NormalizeMultiviewImage", (tpl.IMG_NORM_MEAN,
                                          tpl.IMG_NORM_STD)),
             ("PadMultiViewImage", (32,))]
    t = j = {"imgs": _cams(11)}
    for name, args in steps:
        t = getattr(TT, name)(*args)(dict(t))
        j = getattr(JT, name)(*args)(dict(j))
        _same_sample(t, j)
    assert t["imgs"][0].shape[:2] == tuple(-(-v // 32) * 32
                                           for v in scales[::-1])


# ---------------------------------------------------------------------------
# the dataset
# ---------------------------------------------------------------------------

def _write(root, samples=2):
    cfg_all = tconfigs.get_config("Tiny_L")
    synthetic_dirs.write_nuscenes(
        root, seed=4, samples=samples, points=1500, sweeps=2,
        pc_range=cfg_all["model"].voxel.point_cloud_range,
        classes=cfg_all["class_names"], boxes=4, cameras=True,
        img_hw=CAM_HW)
    return root


@pytest.fixture(scope="module")
def camdir(tmp_path_factory):
    return _write(tmp_path_factory.mktemp("nusc_cam"))


def test_written_cameras(camdir):
    with open(camdir / "nuscenes_infos_train.pkl", "rb") as f:
        infos = pickle.load(f)["infos"]
    for info in infos:
        assert list(info["cams"]) == list(tnusc.CAM_ORDER)
        for cam in info["cams"].values():
            assert set(cam) == {"data_path", "sensor2lidar_rotation",
                                "sensor2lidar_translation", "cam_intrinsic"}
            assert image_io.imread(cam["data_path"]).shape == CAM_HW + (3,)
        # the rig sees the scene: a good share of the key-frame points
        # (the ground near the sensor lies below the cameras' view)
        # projects into some camera
        pts = np.fromfile(info["lidar_path"], np.float32).reshape(-1, 5)
        l2i = tnusc.lidar2img_matrices(info)
        _same(l2i, jnusc.lidar2img_matrices(info))
        ph = np.concatenate([pts[:, :3], np.ones((len(pts), 1))], 1)
        proj = np.einsum("cij,nj->cni", l2i, ph)
        z = proj[..., 2]
        u = proj[..., 0] / np.maximum(z, 1e-6)
        v = proj[..., 1] / np.maximum(z, 1e-6)
        seen = ((z > 0.5) & (u >= 0) & (u < CAM_HW[1]) & (v >= 0)
                & (v < CAM_HW[0])).any(0)
        assert seen.mean() > 0.25
    assert tnusc.CAM_ORDER == jnusc.CAM_ORDER


@pytest.mark.parametrize("mode", ["train", "test"])
def test_get_sample_and_collate_equal_jax(camdir, mode):
    cfg_all = tconfigs.get_config("Tiny_L")
    pcr, classes = cfg_all["model"].voxel.point_cloud_range, \
        cfg_all["class_names"]
    ann = str(camdir / "nuscenes_infos_train.pkl")
    out = []
    for nusc, pl in ((tnusc, tpl), (jnusc, jpl)):
        pipe = (pl.train_pipeline(pcr, classes, with_images=True,
                                  img_scale=FINAL) if mode == "train"
                else pl.test_pipeline(pcr, with_images=True,
                                      img_scale=FINAL))
        ds = nusc.NuScenesDataset(ann, classes=classes, pipeline=pipe,
                                  with_images=True,
                                  test_mode=mode == "test")
        rng = np.random.RandomState(5)
        samples = [ds.get_sample(i, rng) for i in (0, 1)]
        out.append((samples, nusc.collate(samples, classes,
                                          max_points=MAX_POINTS, max_gts=8),
                    rng.randint(1 << 30)))
    (ts, tb, tr), (js, jb, jr) = out
    for t, j in zip(ts, js):
        _same_sample(t, j)
        assert t["imgs"][0].shape == (64, 96, 3)  # FINAL padded to 32
    assert set(tb) == set(jb) >= {"imgs", "lidar2img", "img_aug", "bev_aug"}
    for k in jb:
        if k == "tokens":
            assert tb[k] == jb[k]
        else:
            _same(tb[k], jb[k], k)
    assert tb["imgs"].shape == (2, 6, 64, 96, 3)
    assert tr == jr
    if mode == "test":  # identity bev_aug, the test-time scale in img_aug
        assert (tb["bev_aug"] == np.eye(4)).all()
        assert tb["img_aug"][0, 0, 0, 0] == np.float32(FINAL[1] / CAM_HW[1])


def test_dataset_counts_its_decodes(camdir):
    ds = tnusc.NuScenesDataset(str(camdir / "nuscenes_infos_val.pkl"),
                               with_images=True, test_mode=True)
    image_io.reset_call_count()
    s = ds.get_sample(1, np.random.RandomState(0))
    assert image_io.call_count() == 6 and len(s["imgs"]) == 6
    assert s["imgs"][0].dtype == np.float32
    assert s["imgs"][0].shape == CAM_HW + (3,)


# ---------------------------------------------------------------------------
# the test CLI's TTA on a camera config, against JAX's eval step
# ---------------------------------------------------------------------------

def _tiny_lc_tta():
    cfg = _tiny_lc()
    cfg["tta"] = dict(LC_TTA)
    return cfg


def _jax_config(tm):
    d = dataclasses.asdict(tm)
    return jdet.DetectorConfig(**{
        **d, "voxel": jvox.VoxelConfig(**d["voxel"]),
        "lss": jlss.LSSConfig(**d["lss"]),
        "decoder": jfd.FocalDecoderConfig(**d["decoder"])})


def _jax_pass_batches(root, cfg_all, n_samples):
    """The JAX CLI's TTA batches (``tools/test.py``: the test pipeline,
    ``RandomState(0)``, per pass the points scaled and flipped, then
    ``collate``), sample by sample."""
    cfg = cfg_all["model"]
    ds = jnusc.NuScenesDataset(
        str(root / "nuscenes_infos_val.pkl"), classes=cfg_all["class_names"],
        pipeline=jpl.test_pipeline(cfg.voxel.point_cloud_range,
                                   with_images=True,
                                   img_scale=cfg.lss.img_scale),
        with_images=True, test_mode=True)
    rng = np.random.RandomState(0)
    out = []
    for i in range(n_samples):
        s = ds.get_sample(i, rng)
        for scale, fh, fv in jax_tta_augs(cfg_all["tta"]):
            sa = dict(s)
            pts = s["points"].copy()
            if scale != 1.0:
                pts[:, :3] = pts[:, :3] * scale
            if fh:
                pts[:, 1] = -pts[:, 1]
            if fv:
                pts[:, 0] = -pts[:, 0]
            sa["points"] = pts
            b = jnusc.collate([sa], cfg_all["class_names"],
                              max_points=MAX_POINTS,
                              max_gts=cfg.decoder.max_gts // 4)
            b.pop("tokens")
            out.append(b)
    return out


@pytest.fixture(scope="module")
def tta_run(camdir):
    """The port's test CLI with ``--tta`` over one sample, each pass's
    batch, answer and camera BEV (the LSS output) recorded."""
    mp = pytest.MonkeyPatch()
    mp.setitem(tconfigs._REGISTRY, "Tiny_LC_TTA", _tiny_lc_tta)
    passes = []
    real = tts.make_eval_step

    def recording(cfg, max_out=200):
        step = real(cfg, max_out)

        def run(model, batch):
            lss = []
            hook = model.imgpts_neck.cam_lss.register_forward_hook(
                lambda m, a, out: lss.append(out[0].clone()))
            try:
                dec = step(model, batch)
            finally:
                hook.remove()
            passes.append(({k: v.numpy().copy() for k, v in batch.items()},
                           {k: v.clone() for k, v in dec.items()}, lss[0]))
            return dec

        return run

    mp.setattr(tts, "make_eval_step", recording)
    try:
        run = test_cli.main([
            "Tiny_LC_TTA", "--device", "cpu", "--data-root", str(camdir),
            "--limit", "1", "--tta", "--seed", "3", "--max-out", "16",
            "--max-points", str(MAX_POINTS)])
    finally:
        mp.undo()
    return run, passes


def test_tta_cli_passes_equal_jax_eval_step(camdir, tta_run):
    run, passes = tta_run
    cfg_all = _tiny_lc_tta()
    tm = cfg_all["model"]
    assert run.passes == len(passes) == 12
    jbatches = _jax_pass_batches(camdir, cfg_all, 1)
    assert len(jbatches) == 12
    for (tb, _, _), jb in zip(passes, jbatches):
        assert set(tb) == set(jb)
        for k in jb:
            _same(tb[k], jb[k], k)
    model = FocalFormer3D(tm)
    sd = {k: v.numpy() for k, v in
          make_fake_state_dict(model, seed=3).items()}
    jm = _jax_config(tm)
    _, variables, _, _ = _jax_variables(jm, jbatches[0], sd)
    eval_step = jax.jit(jts.make_eval_step(jm, 16))
    for i, ((_, dec, _), jb) in enumerate(zip(passes, jbatches)):
        ref = jax.device_get(eval_step(
            variables["params"], variables["batch_stats"],
            {k: jnp.asarray(v) for k, v in jb.items()}))
        for k in ("mask", "labels"):
            _same(dec[k].numpy(), ref[k], f"pass {i} {k}")
        for k in ("scores", "bboxes"):
            got, want = dec[k].numpy(), np.asarray(ref[k], np.float32)
            err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-3)
            assert err <= EVAL_TOL, f"pass {i} {k}: rel err {err:.3g}"
    assert run.predictions["sample_0000"]["scores"].size > 0


def test_tta_passes_leave_the_camera_bev_unflipped(camdir, tta_run):
    """The JAX CLI's TTA flips and scales the points, never ``bev_aug``,
    and the LSS maps its frustum through ``bev_aug``: the camera BEV of a
    flipped pass is the plain pass's, in the port (its hooked LSS output)
    and in JAX (its captured ``cam_lss``), while the point cloud, and so the
    LiDAR BEV, is flipped."""
    _, passes = tta_run
    cfg_all = _tiny_lc_tta()
    augs = jax_tta_augs(cfg_all["tta"])
    plain = augs.index((1.0, False, False))
    flip_h = augs.index((1.0, True, False))
    (b0, _, cam0), (b1, _, cam1) = passes[plain], passes[flip_h]
    for k in IMG_KEYS:
        _same(b0[k], b1[k], k)
    assert torch.equal(cam0, cam1) and cam0.abs().max() > 0
    pts0, pts1 = b0["points"][0], b1["points"][0]
    assert (pts1[:, 1] == -pts0[:, 1]).all() and (pts0[:, 1] != 0).any()

    tm = cfg_all["model"]
    jm = _jax_config(tm)
    sd = {k: v.numpy() for k, v in
          make_fake_state_dict(FocalFormer3D(tm), seed=3).items()}
    model, variables, _, _ = _jax_variables(jm, b0, sd)

    @jax.jit
    def bevs(batch):
        vox = jdet.preprocess_points(jm, batch["points"],
                                     batch["points_mask"])
        _, inter = model.apply(
            variables, vox, {k: batch[k] for k in IMG_KEYS}, False,
            capture_intermediates=lambda mdl, _: mdl.name in (
                "cam_lss", "shared_conv_pts"))
        neck = inter["intermediates"]["imgpts_neck"]
        return (neck["cam_lss"]["__call__"][0][0],
                neck["shared_conv_pts"]["__call__"][0])

    (jcam0, jpts0), (jcam1, jpts1) = (
        jax.device_get(bevs({k: jnp.asarray(v) for k, v in b.items()}))
        for b in (b0, b1))
    _same(jcam0, jcam1, "JAX camera BEV")
    assert np.abs(jpts0 - jpts1).max() > 0  # the LiDAR BEV moves
    err = np.abs(cam0.numpy() - jcam0).max() / np.abs(jcam0).max()
    assert err <= EVAL_TOL

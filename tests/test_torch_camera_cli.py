"""The camera configs through the port's entry points, on the CPU.

A tiny LiDAR + camera config (``Tiny_L``'s point branch and head, a
ResNet-50 + FPN image branch on six 64 x 96 cameras, the LSS onto Tiny_L's
8 x 8 BEV, two ``bevfusion`` fusion layers; the freeze flags and grid mask
of ``FocalFormer3D_LC``) and its camera-only counterpart (no point branch,
no fusion layer, as ``DeformFormer3D_C_R50``) are registered for the test
under the names ``Tiny_LC`` and ``Tiny_C``, and ``Tiny_LC_Proj``, LC with
I2P in place of the LSS (as ``FocalFormer3D_LC_Proj``):

- ``make_eval_step`` answers with finite boxes; ``make_train_step`` trains
  the camera-only model end to end (the image branch moves);
- the benchmark CLI (``--device cpu``) prints its JSON line with the
  camera count, then the stage split with the image and LSS (or I2P)
  stages, per engine for LC and LC_Proj and once (engine "none") for the
  camera-only config, and ``--train`` times the frozen LC step beside the
  unfrozen one on each engine asked for;
- the train CLI on ``--synthetic`` trains LC and LC_Proj on the camera
  stream, and
  ``--load-img-from`` a checkpoint of another run takes that run's image
  branch (``img_backbone``, ``img_neck``, ``imgpts_neck.cam_lss``) bit for
  bit and nothing else;
- a camera config on a nuScenes directory with cameras (six 90 x 160
  JPEGs a sample, ``synthetic_dirs.write_nuscenes(cameras=True)``) trains: LC
  and LC_Proj, one step each, with finite losses, reading every camera
  through the port's decoder.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from focalformer3d_tpu_torch import configs as tconfigs
from focalformer3d_tpu_torch.data import synthetic
from focalformer3d_tpu_torch.models.detector import FocalFormer3D
from focalformer3d_tpu_torch.tools import benchmark
from focalformer3d_tpu_torch.tools import train as train_cli
from focalformer3d_tpu_torch.training import checkpoint as ckpt
from focalformer3d_tpu_torch.training import optim
from focalformer3d_tpu_torch.training.train_step import (make_eval_step,
                                                         make_train_step)
from focalformer3d_tpu_torch.utils.ref_keys import make_fake_state_dict

torch.set_num_threads(2)
IMG_BRANCH = ("img_backbone.", "img_neck.", "imgpts_neck.cam_lss.")


def _tiny_lc():
    cfg = tconfigs.get_config("Tiny_L")
    m = cfg["model"]
    lss = tconfigs.LSSConfig(
        img_scale=(64, 96), camera_depth_range=(1.0, 9.0, 1.0),
        pc_range=m.voxel.point_cloud_range, downsample=4, grid=2.0,
        input_channels=256, cam_channels=8, out_channels=m.hidden)
    cfg["model"] = dataclasses.replace(
        m, neck_layers=2, iterbev="bevfusion", input_img=True,
        use_grid_mask=True, cam_proj="lss", lss=lss, bev_shape=(8, 8),
        freeze_img=True, freeze_camlss=True, freeze_pts=True,
        decoder=dataclasses.replace(m.decoder, multistage_heatmap=2,
                                    reuse_first_heatmap=False))
    cfg["img_scale"] = lss.img_scale
    return cfg


def _tiny_c():
    cfg = _tiny_lc()
    m = cfg["model"]
    cfg["model"] = dataclasses.replace(
        m, input_pts=False, neck_layers=0, extra_feat=False,
        freeze_img=False, freeze_camlss=False, freeze_pts=False,
        decoder=dataclasses.replace(
            m.decoder, multistage_heatmap=1, extra_feat=False, roi_feats=0,
            roi_based_reg=False, add_gt_groups=0, num_decoder_layers=1))
    return cfg


def _tiny_lc_proj():
    cfg = _tiny_lc()
    cfg["model"] = dataclasses.replace(cfg["model"], cam_proj="i2p",
                                       max_points_height=3,
                                       freeze_camlss=False)
    return cfg


@pytest.fixture
def registered(monkeypatch):
    monkeypatch.setitem(tconfigs._REGISTRY, "Tiny_LC", _tiny_lc)
    monkeypatch.setitem(tconfigs._REGISTRY, "Tiny_C", _tiny_c)
    monkeypatch.setitem(tconfigs._REGISTRY, "Tiny_LC_Proj", _tiny_lc_proj)


def _batch(cfg, seed=0, batch_size=2):
    b = synthetic.make_batch(
        np.random.RandomState(seed), batch_size=batch_size, n_points=1500,
        n_boxes=3, max_gts=6, num_classes=cfg.decoder.num_classes,
        pc_range=cfg.voxel.point_cloud_range, mode="radial",
        with_images=True, img_hw=cfg.lss.img_scale)
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("make", [_tiny_lc, _tiny_c, _tiny_lc_proj],
                         ids=["LC", "C", "LC_Proj"])
def test_eval_step_answers_with_images(make):
    cfg = make()["model"]
    model = FocalFormer3D(cfg)
    model.load_state_dict(make_fake_state_dict(model, 1), strict=True)
    out = make_eval_step(cfg, max_out=8)(model, _batch(cfg, batch_size=1))
    assert out["bboxes"].shape[0] == 1 and out["bboxes"].shape[-1] == 9
    assert 0 < int(out["mask"].sum()) <= 8
    assert torch.isfinite(out["bboxes"]).all()
    assert torch.isfinite(out["scores"]).all()


def test_camera_only_train_step_moves_the_image_branch():
    c = _tiny_c()
    cfg = dataclasses.replace(c["model"], decoder=dataclasses.replace(
        c["model"].decoder, roi_dropout=0.0))
    model = FocalFormer3D(cfg)
    model.load_state_dict(make_fake_state_dict(model, 2), strict=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tx = optim.make_optimizer(total_steps=10)
    opt_state = tx.init(model.named_parameters())
    gen = torch.Generator()
    gen.manual_seed(0)
    metrics = make_train_step(cfg, c["loss"], tx)(model, opt_state,
                                                  _batch(cfg), gen)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    after = model.state_dict()
    for prefix in ("img_backbone.conv1.", "img_neck.fpn_convs.0.",
                   "imgpts_neck.cam_lss.camencode.",
                   "imgpts_neck.cam_lss.bevencode.0."):
        assert any(not torch.equal(after[k], before[k]) for k in after
                   if k.startswith(prefix)), prefix
    # norm_eval: the backbone's batch norms keep their statistics
    assert torch.equal(after["img_backbone.bn1.running_mean"],
                       before["img_backbone.bn1.running_mean"])
    assert not torch.equal(
        after["imgpts_neck.cam_lss.bevencode.1.running_mean"],
        before["imgpts_neck.cam_lss.bevencode.1.running_mean"])


def _json(out):
    lines = out.splitlines()
    found = [(i, json.loads(x)) for i, x in enumerate(lines)
             if x.startswith("{")]
    assert len(found) == 1
    return lines, found[0]


@pytest.mark.parametrize("name,engines", [("Tiny_LC", "plain,cuda"),
                                          ("Tiny_C", "plain"),
                                          ("Tiny_LC_Proj", "cuda_mxu")])
def test_benchmark_inference_on_a_camera_config(registered, capsys, name,
                                                engines):
    benchmark.main([name, "--device", "cpu", "--samples", "1",
                    "--warmup", "1", "--n-points", "400", "--big-batch", "0",
                    "--engines", engines])
    lines, (i, rec) = _json(capsys.readouterr().out)
    assert rec["cameras"] == 6 and rec["peak_memory_gib"] is None
    names = engines.split(",") if name != "Tiny_C" else ["none"]
    assert sorted(rec["engines"]) == sorted(names)
    camera = ("image proj", "I2P") if name == "Tiny_LC_Proj" else (
        "LSS lift", "LSS splat", "BevEncode")
    for e in names:
        split = [x for x in lines[i + 1:]
                 if x.startswith(f"stage split {e} ")]
        assert len(split) == 1
        for stage in ("image backbone + FPN", "FocalEncoder",
                      "decoder") + camera:
            assert stage in split[0], stage
        assert ("LSS" in split[0]) == (name != "Tiny_LC_Proj")
        assert float(split[0].split(f"{camera[-1]} ")[1].split(",")[0]) > 0
        occ = [x for x in lines if x.startswith(f"occupancy {e} ")]
        assert len(occ) == (name != "Tiny_C")


def test_benchmark_train_on_lc(registered, capsys):
    benchmark.main(["Tiny_LC", "--device", "cpu", "--samples", "2",
                    "--n-points", "400", "--train", "--batch-size", "2",
                    "--engines", "cuda_zrun"])
    _, (_, rec) = _json(capsys.readouterr().out)
    assert rec["benchmark"] == "train"
    assert np.isfinite(rec["engines"]["cuda_zrun"]["loss"])
    assert rec["freeze_disabled"]["cuda_zrun"]["ms_per_step"]["n"] == 3


def test_train_cli_trains_lc_and_loads_an_image_branch(registered, tmp_path,
                                                       capsys):
    common = ["--synthetic", "--device", "cpu", "--epochs", "1",
              "--iters-per-epoch", "1", "--batch-size", "1",
              "--log-interval", "1", "--no-tensorboard"]
    src = train_cli.main(["Tiny_C"] + common
                         + ["--work-dir", str(tmp_path / "c")])
    run = train_cli.main(["Tiny_LC"] + common
                         + ["--seed", "5", "--work-dir", str(tmp_path / "lc"),
                            "--load-img-from", str(tmp_path / "c/epoch_1")])
    out = capsys.readouterr().out
    assert "loaded image branch from" in out and "loss=" in out
    saved = ckpt.load_payload(str(tmp_path / "c/epoch_1"))["state_dict"]
    got = run.model.state_dict()
    fresh = FocalFormer3D(_tiny_lc()["model"])
    fresh.load_state_dict(make_fake_state_dict(fresh, seed=5), strict=True)
    own = fresh.state_dict()
    params = {n for n, _ in run.model.named_parameters()}
    img = [k for k in params if k.startswith(IMG_BRANCH)]
    assert len(img) > 100
    for k in img:  # frozen in LC, so as loaded
        assert torch.equal(got[k].cpu(), saved[k]), k
        assert not torch.equal(own[k], saved[k]), k
    assert src.model is not run.model


def test_train_cli_trains_lc_proj(registered, tmp_path, capsys):
    """LC_Proj on the synthetic camera stream: the frozen image and point
    branches keep the seed's weights, I2P and ``shared_conv_img`` move."""
    run = train_cli.main(["Tiny_LC_Proj", "--synthetic", "--device", "cpu",
                          "--epochs", "1", "--iters-per-epoch", "2",
                          "--batch-size", "1", "--log-interval", "1",
                          "--no-tensorboard", "--seed", "3",
                          "--work-dir", str(tmp_path)])
    assert "loss=" in capsys.readouterr().out
    fresh = FocalFormer3D(_tiny_lc_proj()["model"])
    fresh.load_state_dict(make_fake_state_dict(fresh, seed=3), strict=True)
    own, got = fresh.state_dict(), run.model.state_dict()
    for prefix, moves in (("img_backbone.", False), ("pts_backbone.", False),
                          ("imgpts_neck.shared_conv_img.", True),
                          ("imgpts_neck.fusion_blocks.0.I2P_block.", True)):
        keys = [k for k in own if k.startswith(prefix)]
        assert keys and all(torch.equal(got[k].cpu(), own[k]) != moves
                            for k in keys), prefix


@pytest.mark.parametrize("name", ["Tiny_LC", "Tiny_LC_Proj"])
def test_camera_config_on_a_dataset_raises(registered, tmp_path, name):
    """(Named for what it checked before the camera data layer: that the
    run raised.) The train CLI on a written directory with cameras: one
    step at batch 1, a finite loss, the six cameras of each drawn sample
    decoded (the first batch, drawn as JAX draws it to initialise, and the
    step's)."""
    from focalformer3d_tpu_torch.data import image_io, synthetic_dirs

    cfg_all = tconfigs.get_config("Tiny_L")
    synthetic_dirs.write_nuscenes(
        tmp_path, seed=6, samples=2, points=1500, sweeps=1,
        pc_range=cfg_all["model"].voxel.point_cloud_range,
        classes=cfg_all["class_names"], boxes=4, cameras=True,
        img_hw=(90, 160))
    image_io.reset_call_count()
    run = train_cli.main([name, "--device", "cpu", "--data-root",
                          str(tmp_path), "--epochs", "1",
                          "--iters-per-epoch", "1", "--batch-size", "1",
                          "--max-points", "6000", "--no-cbgs",
                          "--no-tensorboard", "--log-interval", "1",
                          "--work-dir", str(tmp_path / "w")])
    assert image_io.call_count() == 2 * 6
    assert [type(t).__name__ for t in run.pipeline.transforms][-3:] == [
        "ImageAug3D", "NormalizeMultiviewImage", "PadMultiViewImage"]
    with open(tmp_path / "w" / "train_log.jsonl") as fh:
        losses = [json.loads(x)["loss"] for x in fh
                  if json.loads(x)["mode"] == "train"]
    assert len(losses) == 1 and np.isfinite(losses[0])
    assert run.opt_state.count == 1

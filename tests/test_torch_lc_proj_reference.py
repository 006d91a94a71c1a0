"""The port against the benchmark's plain reference on the LC_Proj path.

``perfbench/reference/ff3d`` (plain torch, float32, importing nothing of
the port) is what decides a benchmark cell's ``correct``. Here both
detectors are built at Tiny_L's small grid and widths, with six 64 x 96
cameras, but with FocalFormer3D_LC_Proj's structure (``cam_proj="i2p"``
with ``iter_bev_cam``: ``shared_conv_img`` and the first fusion layer's
``I2P_block`` on a 3 x 8 x 8 grid, two ``bevfusion`` fusion layers, two
heatmap stages), loaded with one seeded state dict
(``perfbench/data/weights.py``), and run in float32 on one radial scan
and its cameras, under a BEV and image augmentation that is not the
identity:

- the voxelization's integer outputs are equal;
- ``I2P_block``'s output, the camera BEV it hands the first fusion layer;
- the heatmap logits: the LiDAR map's dense one and each of the two
  stages';
- ``get_bboxes``' boxes and scores (labels and masks equal).

Also held here: ``project_points_to_cams`` of the port (``inv_ex``) gives
the reference's (``inv``) ``xy`` and ``valid`` bit for bit on random rigs;
the operations that ``perfbench/i2p_work.py`` counts for the camera
projection are what ``FlopCounterMode`` counts over the reference's
``shared_conv_img`` and ``I2P_block``; and
``perfbench/configs/FocalFormer3D_LC_Proj.json`` states the sizes of
both registries, and its precision map names modules of the model that
compute in the precision it states.
"""
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from focalformer3d_tpu_torch import configs as port_configs
from focalformer3d_tpu_torch.models import detector as port_det
from focalformer3d_tpu_torch.models import i2p as port_i2p
from perfbench import i2p_work, spec
from perfbench.data import synthetic
from perfbench.data.weights import make_state_dict
from perfbench.reference.ff3d import configs as ref_configs
from perfbench.reference.ff3d.models import detector as ref_det
from perfbench.reference.ff3d.models import i2p as ref_i2p
from perfbench.reference.ff3d.models.layers import conv2d_nhwc

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parent.parent
CELL_CONFIG = REPO / "perfbench" / "configs" / "FocalFormer3D_LC_Proj.json"
I2P = "imgpts_neck.fusion_blocks.0.I2P_block"

# Both sides compute the same float32 operations on the plain engine (the
# reference is a frozen copy of the port's plain paths), and on the CPU
# they agree bit for bit. The tolerances leave room for what may part
# them elsewhere, the order of float32 sums that a torch op picks for
# itself, and for nothing more. I2P is one grid_sample a camera, a mean
# and a one-head attention of four products behind ResNet-50 + FPN and a
# 3x3 conv: 1e-5 relative, ~100 float32 ulps.
I2P_TOL = 1e-5
# ~30 layers deep (encoder, SECOND + FPN, two fusion layers, the heads):
# 1e-4 relative, as the port is held to JAX at this depth
# (tests/test_torch_i2p.py EVAL_TOL).
EVAL_TOL = 1e-4


def _lc_proj(configs):
    """Tiny_L with six 64 x 96 cameras, ResNet-50 + FPN, and
    FocalFormer3D_LC_Proj's neck and head."""
    m = configs.get_config("Tiny_L")["model"]
    lss = configs.LSSConfig(
        img_scale=(64, 96), camera_depth_range=(1.0, 9.0, 1.0),
        pc_range=m.voxel.point_cloud_range, downsample=4, grid=2.0,
        input_channels=256, cam_channels=8, out_channels=m.hidden)
    return dataclasses.replace(
        m, neck_layers=2, iterbev="bevfusion", input_img=True,
        cam_proj="i2p", iter_bev_cam=True, lss=lss, bev_shape=(8, 8),
        max_points_height=3, sparse_engine="plain",
        decoder=dataclasses.replace(m.decoder, multistage_heatmap=2,
                                    reuse_first_heatmap=False))


def _rel(got, ref):
    got, ref = got.double(), ref.double()
    return float((got - ref).norm() / ref.norm().clamp_min(1e-30))


def _augs(rng, n_cams):
    """Image augmentations (rotation, scale, shift a camera) and a BEV
    augmentation (rotation, scale, shift) that are not the identity."""
    ia = np.tile(np.eye(4, dtype=np.float32), (n_cams, 1, 1))
    for n in range(n_cams):
        a, s = rng.uniform(-0.1, 0.1), rng.uniform(0.9, 1.1)
        ia[n, :2, :2] = s * np.array([[np.cos(a), -np.sin(a)],
                                      [np.sin(a), np.cos(a)]])
        ia[n, :2, 3] = rng.uniform(-5, 5, 2)
    ba = np.eye(4, dtype=np.float32)
    a = rng.uniform(-0.5, 0.5)
    ba[:2, :2] = rng.uniform(0.95, 1.05) * np.array(
        [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
    ba[:3, 3] = rng.uniform(-0.5, 0.5, 3)
    return ia, ba


def _scan(cfg, seed=5):
    rng = np.random.RandomState(seed)
    b = synthetic.make_batch(rng, spec.load_rig("radial"), 1, 2000, 6, 8,
                             cfg.decoder.num_classes,
                             cfg.voxel.point_cloud_range, with_images=True,
                             n_cams=6, img_hw=cfg.lss.img_scale)
    b["img_aug"][0], b["bev_aug"][0] = _augs(rng, 6)
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _capture(module):
    got = {}

    def hook(_m, args, out):
        got["args"], got["out"] = args, out

    module.register_forward_hook(hook)
    return got


@pytest.fixture(scope="module")
def run():
    pcfg, rcfg = _lc_proj(port_configs), _lc_proj(ref_configs)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(rcfg)
    assert pcfg.cam_proj == "i2p" and pcfg.iter_bev_cam
    assert pcfg.neck_layers == 2 and pcfg.iterbev == "bevfusion"
    assert pcfg.decoder.total_stages == 2
    port = port_det.FocalFormer3D(pcfg).eval()
    ref = ref_det.FocalFormer3D(rcfg).eval()
    # I2P in the first fusion layer alone, as the published config has it
    assert [b.I2P_block is not None for b in port.imgpts_neck.fusion_blocks
            ] == [True, False]
    state = make_state_dict({k: v.shape for k, v in
                             port.state_dict().items()}, 29,
                            torch.device("cpu"))
    port.load_state_dict(state, strict=True)
    ref.load_state_dict(state, strict=True)
    pi2p = _capture(port.imgpts_neck.fusion_blocks[0].I2P_block)
    ri2p = _capture(ref.imgpts_neck.fusion_blocks[0].I2P_block)
    scan = _scan(pcfg)
    img = {k: scan[k] for k in ("imgs", "lidar2img", "img_aug", "bev_aug")}
    with torch.no_grad():
        pvox = port_det.preprocess_points(pcfg, scan["points"],
                                          scan["points_mask"])
        rvox = ref_det.preprocess_points(rcfg, scan["points"],
                                         scan["points_mask"])
        pout = port(pvox, img_data=img)
        rout = ref(rvox, img_data=img)
        return dict(pvox=pvox, rvox=rvox, pout=pout, rout=rout, pi2p=pi2p,
                    ri2p=ri2p, pdec=port.get_bboxes(pout, 200),
                    rdec=ref.get_bboxes(rout, 200))


def test_voxelization_is_equal(run):
    for k in ("features", "coords", "voxel_mask"):
        assert torch.equal(run["pvox"][k], run["rvox"][k]), k


def test_i2p_output_matches(run):
    got, ref = run["pi2p"]["out"], run["ri2p"]["out"]
    assert got.dtype == ref.dtype == torch.float32
    assert got.shape == (1, 8, 8, 32)
    # the cameras see part of the grid and miss the rest
    seen = ref.abs().sum(-1) > 0
    assert 0 < int(seen.sum()) < seen.numel()
    assert _rel(got, ref) < I2P_TOL


def test_two_stages_heatmaps_match(run):
    """The dense heatmap of the LiDAR map (``reuse_first_heatmap`` off:
    kept, not picked from), then each stage's."""
    hm, rhm = run["pout"]["dense_heatmap"], run["rout"]["dense_heatmap"]
    assert hm.shape[1] == rhm.shape[1] == 3
    for s in range(3):
        assert _rel(hm[:, s], rhm[:, s]) < EVAL_TOL, s
    assert torch.equal(run["pout"]["query_labels"],
                       run["rout"]["query_labels"])


def test_boxes_and_scores_match(run):
    pdec, rdec = run["pdec"], run["rdec"]
    for k in ("labels", "mask"):
        assert torch.equal(pdec[k], rdec[k]), k
    assert int(pdec["mask"].sum()) > 0
    for k in ("bboxes", "scores"):
        assert _rel(pdec[k], rdec[k]) < EVAL_TOL, k


@pytest.mark.parametrize("seed", range(4))
def test_projection_is_the_references_bit_for_bit(seed):
    """The port inverts ``bev_aug`` with ``inv_ex`` (no read-back of the
    error code), the reference with ``inv``: the same float32 ``xy`` and
    the same ``valid`` on random rigs, augmentations and grids."""
    rng = np.random.RandomState(seed)
    l2i = torch.from_numpy(synthetic.make_cameras(rng, 6, (448, 800))
                           .astype(np.float32))
    ia, ba = (torch.from_numpy(a) for a in _augs(rng, 6))
    rng_range = (-54.0, -54.0, -5.0, 54.0, 54.0, 3.0)
    grid = port_i2p.bev_grid((4, 45, 45), rng_range)
    assert torch.equal(grid, ref_i2p.bev_grid((4, 45, 45), rng_range))
    for img_aug, bev_aug in ((ia, ba), (None, ba), (ia, torch.eye(4))):
        xy, valid = port_i2p.project_points_to_cams(grid, l2i, img_aug,
                                                    bev_aug, (448, 800))
        rxy, rvalid = ref_i2p.project_points_to_cams(grid, l2i, img_aug,
                                                     bev_aug, (448, 800))
        assert torch.equal(xy, rxy) and torch.equal(valid, rvalid)
        assert 0 < int(valid.sum()) < valid.numel()


def test_i2p_work_counts_the_references_products():
    """``i2p_work.count`` at the tiny shapes: the operations of the
    reference's ``shared_conv_img`` and ``I2P_block`` as
    ``FlopCounterMode`` counts them."""
    cfg = _lc_proj(ref_configs)
    model = ref_det.FocalFormer3D(cfg).eval()
    model.load_state_dict(make_state_dict(
        {k: v.shape for k, v in model.state_dict().items()}, 3,
        torch.device("cpu")), strict=True)
    neck = model.imgpts_neck
    scan = _scan(cfg)
    cams, (fh, fw) = 6, (s // cfg.lss.downsample for s in cfg.lss.img_scale)
    (h, w), c = cfg.bev_shape, cfg.hidden
    gen = torch.Generator().manual_seed(0)
    feats = torch.randn(1, cams, fh, fw, 256, generator=gen)
    lidar = torch.randn(1, h, w, c, generator=gen)
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        img = conv2d_nhwc(feats.flatten(0, 1), neck.shared_conv_img.weight,
                          neck.shared_conv_img.bias, 1, 1).unflatten(
                              0, (1, cams))
        out = neck.fusion_blocks[0].I2P_block(
            lidar, img, scan["lidar2img"], scan["img_aug"], scan["bev_aug"])
    assert out.abs().sum() > 0
    n = i2p_work.count(cams=cams, fh=fh, fw=fw, c_img=256, c=c,
                       z=cfg.max_points_height, h=h, w=w)
    assert counter.get_total_flops() == n["flops"]


def test_i2p_work_at_the_published_shapes():
    """The cell's shapes: the model's own, and the least time bound by the
    float32 peak, not by HBM."""
    cfg = port_configs.get_config("FocalFormer3D_LC_Proj")["model"]
    fh, fw = (s // cfg.lss.downsample for s in cfg.lss.img_scale)
    assert i2p_work.PUBLISHED == dict(
        cams=6, fh=fh, fw=fw, c_img=cfg.lss.input_channels, c=cfg.hidden,
        z=cfg.max_points_height, h=cfg.bev_shape[0], w=cfg.bev_shape[1])
    n = i2p_work.count(**i2p_work.PUBLISHED)
    for card, pk in i2p_work.PEAKS.items():
        assert i2p_work.seconds_at_peak(card) == n["flops"] / pk["float32"]
        assert n["bytes"] / pk["hbm_bytes_per_s"] < 0.1 * n["flops"] / \
            pk["float32"]


def test_cell_configuration_states_the_published_sizes():
    stated = json.loads(CELL_CONFIG.read_text())
    assert stated["model"] == "FocalFormer3D_LC_Proj"
    assert stated["reduced"] == []
    assert stated["cameras"] == 6
    for configs in (port_configs, ref_configs):
        cfg = configs.get_config("FocalFormer3D_LC_Proj")["model"]
        run_cfg = spec.as_run(cfg, stated)  # raises on a size it misstates
        assert set(spec.CHECKED) - {"reuse_first_heatmap", "code_size",
                                    "vfe_type", "vfe_channels"} \
            <= set(stated)
        assert (cfg.cam_proj, cfg.max_points_height) == (
            stated["cam_proj"], stated["max_points_height"])
        assert list(cfg.lss.img_scale) == stated["img_scale"]
        lc = configs.get_config("FocalFormer3D_LC")["model"]
        assert dataclasses.replace(cfg, cam_proj="lss",
                                   freeze_camlss=True) == lc
        assert run_cfg.voxel.max_voxels_test == stated["max_voxels_test"]
    lc_stated = json.loads((CELL_CONFIG.parent / "FocalFormer3D_LC.json")
                           .read_text())
    for k in ("scan", "points", "capacities", "out_capacity", "max_voxels",
              "max_voxels_test"):
        assert stated[k] == lc_stated[k], k


def test_precision_map_names_what_the_port_computes():
    """Every module the map and the control's lists name exists, and
    under the bf16 inference dtype the parts stated in float32 compute in
    float32 (the image branch, ``shared_conv_img``'s output, I2P) while
    the rest runs in bfloat16."""
    stated = json.loads(CELL_CONFIG.read_text())["precision"]
    cfg = port_configs.with_compute_dtype(_lc_proj(port_configs),
                                          stated["infer_dtype"])
    model = port_det.FocalFormer3D(cfg).eval()
    names = {n for n, _ in model.named_modules()}
    listed = (set(stated["infer"]) - {"*"}) | set(
        stated["control_infer_fp8"]) | set(stated["control_infer_exempt"])
    assert listed <= names
    assert {k for k, v in stated["infer"].items() if v == "float32"} == \
        set(stated["control_infer_exempt"])
    model.load_state_dict(make_state_dict(
        {k: v.shape for k, v in model.state_dict().items()}, 3,
        torch.device("cpu")), strict=True)
    seen = {name: _capture(model.get_submodule(name))
            for name in ("img_neck", I2P, "imgpts_neck.fusion_blocks.1",
                         "pts_backbone")}
    scan = _scan(cfg)
    img = {k: scan[k] for k in ("imgs", "lidar2img", "img_aug", "bev_aug")}
    with torch.no_grad():
        vox = port_det.preprocess_points(cfg, scan["points"],
                                         scan["points_mask"])
        out = model(vox, img_data=img)
    assert all(t.dtype == torch.float32 for t in seen["img_neck"]["out"])
    lidar, img_feat = seen[I2P]["args"][:2]
    assert lidar.dtype == torch.bfloat16  # the LiDAR map it decorates
    assert img_feat.dtype == torch.float32  # shared_conv_img's output
    assert seen[I2P]["out"].dtype == torch.float32
    assert seen["imgpts_neck.fusion_blocks.1"]["out"][1].dtype == \
        torch.bfloat16
    assert seen["pts_backbone"]["out"][0].dtype == torch.bfloat16
    assert torch.isfinite(out["dense_heatmap"]).all()

"""The port against the benchmark's plain reference on the Waymo path.

``perfbench/reference/ff3d`` (plain torch, float32, importing nothing of
the port) is what decides a benchmark cell's ``correct``. Here both
detectors are built at Tiny_Waymo_L's small grid and widths but with
FocalFormer3D_Waymo_L's structure (``HIP3``: the HardVFE, two
``bevfusionmb2`` fusion layers, two heatmap stages plus the reused first,
so three Hard Instance Probing stages, code size 8, 3 classes), loaded
with one seeded state dict (``perfbench/data/weights.py``), and run in
float32 on one frame of the Waymo rig scaled to the tiny range:

- the voxelization's integer outputs are equal;
- the HardVFE's features on every non-empty voxel, each count of filled
  slots from 1 to 5 present;
- each of the three stages' heatmap logits, and the masks each stage
  probes under (equal);
- ``get_bboxes``' boxes and scores (labels and masks equal).

``FocalFormer3D_Waymo_L``'s benchmark configuration
(``perfbench/configs/FocalFormer3D_Waymo_L.json``) is also held here: its
stated sizes are the port's and the reference's, and its sparse
capacities hold every active voxel of L1 (the one sparse level past L0 at
eval) on 180 000-point Waymo frames of four seeds.
"""
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from focalformer3d_tpu_torch import configs as port_configs
from focalformer3d_tpu_torch.models import detector as port_det
from perfbench import judge, loops, spec
from perfbench.data import synthetic
from perfbench.data.weights import make_state_dict
from perfbench.reference.ff3d import configs as ref_configs
from perfbench.reference.ff3d.models import detector as ref_det

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parent.parent
TINY_RIG = REPO / "perfbench" / "tests" / "waymo_tiny.json"
CELL_CONFIG = REPO / "perfbench" / "configs" / "FocalFormer3D_Waymo_L.json"

# Both sides compute the same float32 operations on the plain engine (the
# reference is a frozen copy of the port's plain paths), and on the CPU
# they agree bit for bit. The tolerances leave room for what may part
# them elsewhere, the order of float32 sums that a torch op picks for
# itself (matmul blocking, the sparse conv's gather and scatter), and for
# nothing more. The HardVFE is one Linear, a batch norm and a max: 1e-5
# relative, ~100 float32 ulps.
VFE_TOL = 1e-5
# ~30 layers deep (encoder, SECOND + FPN, two fusion layers, the heads):
# 1e-4 relative, as the port is held to JAX at this depth
# (tests/test_torch_waymo_model.py EVAL_TOL).
EVAL_TOL = 1e-4


def _hip3(configs):
    cfg = configs.get_config("Tiny_Waymo_L")["model"]
    return dataclasses.replace(
        cfg, neck_layers=2, decoder=dataclasses.replace(
            cfg.decoder, multistage_heatmap=2))


def _rel(got, ref):
    got, ref = got.double(), ref.double()
    return float((got - ref).norm() / ref.norm().clamp_min(1e-30))


def _frame(cfg, seed=5, n=2000):
    """One frame of the Waymo rig at the tiny range, and its first 100
    points five more times (jittered within 1e-4 m), so that voxels with
    every count of filled slots from 1 to 5 occur."""
    b = synthetic.make_batch(np.random.RandomState(seed),
                             json.loads(TINY_RIG.read_text()), 1, n, 6, 8,
                             cfg.decoder.num_classes,
                             cfg.voxel.point_cloud_range)
    rng = np.random.RandomState(seed + 1)
    pts = np.concatenate([b["points"]] + [
        b["points"][:, :100] + rng.uniform(-1e-4, 1e-4, (1, 100, 5)).astype(
            np.float32) for _ in range(5)], axis=1)
    mask = np.ones(pts.shape[:2], bool)
    return torch.from_numpy(pts), torch.from_numpy(mask)


@pytest.fixture(scope="module")
def run():
    pcfg, rcfg = _hip3(port_configs), _hip3(ref_configs)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(rcfg)
    assert pcfg.decoder.total_stages == 3 and pcfg.vfe_type == "HardVFE"
    assert pcfg.decoder.code_size == 8 and pcfg.decoder.num_classes == 3
    port = port_det.FocalFormer3D(pcfg).eval()
    ref = ref_det.FocalFormer3D(rcfg).eval()
    state = make_state_dict({k: v.shape for k, v in
                             port.state_dict().items()}, 23,
                            torch.device("cpu"))
    port.load_state_dict(state, strict=True)
    ref.load_state_dict(state, strict=True)
    pts, mask = _frame(pcfg)
    with torch.no_grad():
        pvox = port_det.preprocess_points(pcfg, pts, mask)
        rvox = ref_det.preprocess_points(rcfg, pts, mask)
        pout = port(pvox)
        rout = ref(rvox)
        return dict(
            pvox=pvox, rvox=rvox, pout=pout, rout=rout,
            pfeat=port.pts_voxel_encoder(pvox["voxels"], pvox["num_points"],
                                         pvox["coords"]),
            rfeat=ref.pts_voxel_encoder(rvox["voxels"], rvox["num_points"],
                                        rvox["coords"]),
            pdec=port.get_bboxes(pout, 200), rdec=ref.get_bboxes(rout, 200))


def test_voxelization_is_equal(run):
    for k in ("voxels", "num_points", "coords", "voxel_mask"):
        assert torch.equal(run["pvox"][k], run["rvox"][k]), k


def test_hard_vfe_features_match_on_every_slot_count(run):
    m = run["pvox"]["voxel_mask"]
    counts = run["pvox"]["num_points"][m]
    assert set(counts.tolist()) == {1, 2, 3, 4, 5}
    got, ref = run["pfeat"], run["rfeat"]
    for c in range(1, 6):
        sel = m & (run["pvox"]["num_points"] == c)
        assert _rel(got[sel], ref[sel]) < VFE_TOL, c
    assert not got[~m].any() and not ref[~m].any()


def test_three_stages_heatmaps_and_masks_match(run):
    pout, rout = run["pout"], run["rout"]
    hm, rhm = pout["dense_heatmap"], rout["dense_heatmap"]
    assert hm.shape[1] == rhm.shape[1] == 3
    for s in range(3):
        assert _rel(hm[:, s], rhm[:, s]) < EVAL_TOL, s
    masks, rmasks = pout["multistage_masks"], rout["multistage_masks"]
    assert masks.shape[1] == 3 and torch.equal(masks, rmasks)
    # each stage probes under a mask that the stages before it narrowed
    live = [int(masks[:, s].sum()) for s in range(3)]
    assert live[0] > live[1] > live[2]
    assert torch.equal(pout["query_labels"], rout["query_labels"])


def test_boxes_and_scores_match(run):
    pdec, rdec = run["pdec"], run["rdec"]
    assert pdec["bboxes"].shape[-1] == 7  # code size 8: no velocity
    for k in ("labels", "mask"):
        assert torch.equal(pdec[k], rdec[k]), k
    assert int(pdec["mask"].sum()) > 0
    for k in ("bboxes", "scores"):
        assert _rel(pdec[k], rdec[k]) < EVAL_TOL, k


def test_cell_configuration_states_the_published_sizes():
    stated = json.loads(CELL_CONFIG.read_text())
    assert stated["model"] == "FocalFormer3D_Waymo_L"
    assert stated["reduced"] == []
    for configs in (port_configs, ref_configs):
        cfg = configs.get_config("FocalFormer3D_Waymo_L")["model"]
        run_cfg = spec.as_run(cfg, stated)  # raises on a size it misstates
        assert set(spec.CHECKED) - {"img_backbone_depth", "img_scale"} \
            <= set(stated)
        assert run_cfg.voxel.max_voxels == 150000
        assert run_cfg.voxel.max_voxels_test == 150000
        assert run_cfg.capacities[0] == cfg.capacities[0] == 150000
        assert run_cfg.capacities[1] > cfg.capacities[1]
        assert all(c % 1024 == 0 for c in run_cfg.capacities[1:])


@pytest.fixture(scope="module")
def cell_reference():
    """The reference detector of the cell's configuration (built, never
    run: the capacity test runs the index build alone)."""
    stated = json.loads(CELL_CONFIG.read_text())
    return stated, judge.Reference(stated, torch.device("cpu"))


@pytest.mark.parametrize("seed", [11, 2147483659, 3000000017, 4294967311])
def test_cell_capacities_hold_every_voxel_of_a_waymo_frame(cell_reference,
                                                           seed):
    """The first frame of the cell's pool for four seeds (the whole pool,
    16 frames, would take ~30 s a seed here; the count over 256 frames is
    in the configuration's ``assumed.capacities``)."""
    stated, ref = cell_reference
    traffic = json.loads((REPO / "perfbench" / "traffic"
                          / "stream_Waymo_L.json").read_text())
    pool = loops.make_pool(
        dict(traffic, pool=1), stated, ref.cfg, loops.seeds(seed).data,
        torch.device("cpu"))
    assert pool["points"].shape == (1, stated["points"], 5)
    occ = judge.occupancy(ref, pool)[0]
    assert [row[0] for row in occ] == ["L0", "L1"]
    (_, l0, cap0, drop0), (_, l1, cap1, drop1) = occ
    assert cap0 == 150000 and (drop0 == 0 or l0 == cap0)
    assert cap1 == stated["capacities"][1] and drop1 == 0
    assert l1 > port_configs.get_config(
        "FocalFormer3D_Waymo_L")["model"].capacities[1]

"""The scans' sensor rigs (``scans/<name>.json``): every pool that the
cells make is the one that the generator made before its rigs became data,
byte for byte, and a configuration picks its rig by ``"scan"`` alone."""
from __future__ import annotations

import hashlib
import json

import numpy as np
import pytest
import torch

from perfbench import loops, spec
from perfbench.data import synthetic
from perfbench.reference.ff3d import configs as ref_configs
from perfbench.tests import tiny

PINNED = json.loads((tiny.HERE / "pool_digests.json").read_text())
TINY = {"FocalFormer3D_L": "Tiny_L.json", "FocalFormer3D_LC": "Tiny_LC.json"}


def _bench():
    return json.loads((tiny.REPO / "BENCHMARK.json").read_text())


def _cases():
    """(cell, size, configuration file, scan or None) of every pinned
    pool: each cell with its own configuration and with its tiny one, and
    Tiny_L on the uniform scan."""
    bench = _bench()
    files = {c["name"]: tiny.REPO / c["file"] for c in bench["configs"]}
    out = []
    for w in bench["workloads"]:
        out.append((w["name"], "full", files[w["config"]], None))
        out.append((w["name"], "tiny", tiny.HERE / TINY[w["config"]], None))
    out.append(("L.stream", "tiny-uniform", tiny.HERE / "Tiny_L.json",
                "uniform"))
    return out


def digests(pool):
    out = {}
    for k in sorted(pool):
        a = pool[k].contiguous().numpy()
        h = hashlib.sha256(f"{k} {a.dtype} {a.shape}".encode())
        h.update(a.tobytes())
        out[k] = h.hexdigest()
    return out


@pytest.fixture(scope="module")
def made():
    """Pools made so far, by what makes them (the three FocalFormer3D_L
    cells share one pool a seed)."""
    return {}


@pytest.mark.parametrize("seed", PINNED["seeds"])
@pytest.mark.parametrize("cell,size,path,scan", _cases(),
                         ids=lambda v: getattr(v, "name", str(v)))
def test_pools_are_the_pinned_ones(monkeypatch, made, cell, size, path,
                                   scan, seed):
    """The full configurations' pools take ~6 s each here: 200k-point
    scans, and LC's six 448 x 800 images a scan."""
    monkeypatch.chdir(tiny.REPO)
    traffic = spec.load_cell(cell).traffic
    config = json.loads(path.read_text())
    if scan:
        config["scan"] = scan
    key = (str(path), config["scan"], traffic["pool"], traffic["gt_boxes"],
           traffic["max_gts"], seed)
    if key not in made:
        full = (tiny.tiny_lc(ref_configs) if config["model"] == "Tiny_LC"
                else ref_configs.get_config(config["model"]))
        made[key] = digests(loops.make_pool(
            traffic, config, spec.as_run(full["model"], config),
            loops.seeds(seed).data, torch.device("cpu")))
    assert made[key] == PINNED["digests"][f"{cell} {size} {seed}"]


def test_the_cells_configurations_keep_their_rig():
    for c in _bench()["configs"]:
        assert json.loads((tiny.REPO / c["file"]).read_text())["scan"] \
            == "radial"


def test_an_unknown_rig_raises(monkeypatch):
    monkeypatch.chdir(tiny.REPO)
    with pytest.raises(ValueError, match="no scan rig 'nuscenes'"):
        spec.load_rig("nuscenes")
    assert {"radial", "uniform", "waymo"} <= {
        p.stem for p in (tiny.REPO / "perfbench" / "scans").glob("*.json")}


def test_a_rig_is_what_the_scan_is_made_of(monkeypatch):
    """The rig's numbers, not the generator's: another ground band moves
    the ground, and ``keep`` leaves what ``clip`` puts on the border."""
    monkeypatch.chdir(tiny.REPO)
    pcr = (-8.0, -8.0, -3.0, 8.0, 8.0, 3.0)

    def scene(rig):
        return synthetic.make_scene(np.random.RandomState(0), 4000, 6, 4,
                                    pcr, 5, rig)[0]

    rig = spec.load_rig("radial")
    clipped = scene(rig)
    kept = scene({**rig, "beyond_range": "keep"})
    moved = (clipped != kept).any(-1)
    assert moved.mean() > 0.05
    xy = kept[moved, :2]
    assert ((xy < -8.0) | (xy > 8.0 - 1e-3)).any(-1).all()
    assert np.isin(clipped[moved, :2], np.float32([-8.0, 8.0 - 1e-3])).any(
        -1).all()
    low = scene({**rig, "ground_z_m": [-2.6, -2.5]})
    moved = (low != clipped).any(-1)
    assert moved.mean() > 0.3
    assert ((low[moved, 2] >= -2.6) & (low[moved, 2] <= -2.5)).all()
    assert ((clipped[moved, 2] >= -2.1) & (clipped[moved, 2] <= -1.9)).all()
    with pytest.raises(ValueError, match="beyond_range"):
        scene({**rig, "beyond_range": "wrap"})


def test_the_waymo_rig_lands_inside_the_waymo_range(monkeypatch):
    """FocalFormer3D_Waymo_L's range (+-76.8 m, z -2 to 4) holds 99% or
    more of a 180k-point frame of ``waymo.json``, with ground near z 0."""
    monkeypatch.chdir(tiny.REPO)
    pcr = ref_configs.get_config(
        "FocalFormer3D_Waymo_L")["model"].voxel.point_cloud_range
    pts = synthetic.make_scene(np.random.RandomState(5), 180000, 24, 3, pcr,
                               5, spec.load_rig("waymo"))[0]
    lo, hi = np.asarray(pcr[:3]), np.asarray(pcr[3:])
    inside = ((pts[:, :3] >= lo) & (pts[:, :3] < hi)).all(-1)
    assert inside.mean() >= 0.99
    assert 0.3 < (np.abs(pts[:, 2]) <= 0.1).mean() < 0.7


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_a_waymo_frame_fits_under_the_published_voxel_cap(monkeypatch,
                                                          seed):
    """The one published number the Waymo rig is held to: a 180k-point
    frame fills fewer non-empty voxels of FocalFormer3D_Waymo_L's grid than
    the configuration's cap (``max_voxels`` 150 000)."""
    monkeypatch.chdir(tiny.REPO)
    voxel = ref_configs.get_config("FocalFormer3D_Waymo_L")["model"].voxel
    pts = synthetic.make_scene(loops.seeds(seed).data, 180000, 24, 3,
                               voxel.point_cloud_range, 5,
                               spec.load_rig("waymo"))[0]
    lo = np.asarray(voxel.point_cloud_range[:3])
    hi = np.asarray(voxel.point_cloud_range[3:])
    xyz = pts[((pts[:, :3] >= lo) & (pts[:, :3] < hi)).all(-1), :3]
    cells = np.floor((xyz - lo) / np.asarray(voxel.voxel_size))
    assert len(np.unique(cells, axis=0)) < voxel.max_voxels == 150000


def test_a_beam_that_would_meet_the_ground_under_the_vehicle_returns_nothing(
        monkeypatch):
    """A short-range LiDAR's steep beams (rings nearer than MIN_RING_M) are
    dropped, not stacked on the nearest ring."""
    monkeypatch.chdir(tiny.REPO)
    rig = spec.load_rig("waymo")
    front = {**rig["sensors"][1], "position_m": [0.0, 0.0], "share": 1.0}
    pcr = (-30.0, -30.0, -2.0, 30.0, 30.0, 4.0)
    bg = synthetic._sensor_background(np.random.RandomState(0), 20000, pcr,
                                      {**rig, "sensors": [front]})
    ground = bg[np.abs(bg[:, 2]) <= 0.1]
    r = np.hypot(ground[:, 0], ground[:, 1])
    near = synthetic.MIN_RING_M * np.asarray(synthetic.RING_JITTER)
    assert r.min() >= near[0]
    assert ((r >= near[0]) & (r <= near[1])).mean() < 0.05

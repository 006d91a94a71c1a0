"""Parity: DeformFormer3D and dynamic voxelization, the port against JAX.

- ``dynamic_voxelize``: the same numpy points through both packages. Voxel
  coords, mask and CSR order exactly; features (each voxel's mean of all
  its points) within 2 * 2**-23 * sum|x| over the voxel's points, per
  channel (both sum a voxel's points in float32, in orders that may
  differ), and against a float64 numpy mean; with a voxel cap that drops
  voxels, the dropped points reach no kept voxel.
- The slice as a whole: ``Tiny_L`` with the DeformFormer3D deltas (the
  single-stage head: no extra value map, 200 proposals, one decoder round,
  one heatmap stage without reuse, no RoI features or RoI-based
  regression), on hard and on dynamic voxelization, one reference-format
  state dict in both packages, through ``preprocess_points`` -> forward ->
  ``get_bboxes`` on engine ``plain`` against the JAX engine ``voxel``, at
  the tolerances of ``tests/test_torch_model.py::test_whole_slice_vs_jax``
  (heads, boxes and scores 5e-3 of the reference's scale; labels and masks
  exactly), the queries held as a set where two picks are near-ties
  (``test_deform_slice_vs_jax``).
- One training step of that model on hard voxelization against the JAX
  step, held as ``tests/test_torch_train_step.py`` holds Tiny_L's: losses
  within 1e-5, gradients within 2e-4.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from focalformer3d_tpu.configs import get_config as jax_get_config
from focalformer3d_tpu.configs.variants import _deform_deltas
from focalformer3d_tpu.data import synthetic
from focalformer3d_tpu.models import focal_decoder as jfd
from focalformer3d_tpu.models.detector import FocalFormer3D as JaxFF3D
from focalformer3d_tpu.models.detector import preprocess_points as jax_prep
from focalformer3d_tpu.ops import voxelize as jvox
from focalformer3d_tpu.utils.convert import convert_tree
from focalformer3d_tpu.utils.ref_keys import make_fake_state_dict
from focalformer3d_tpu_torch import configs as tconfigs
from focalformer3d_tpu_torch.models import detector as tdet
from focalformer3d_tpu_torch.models import focal_decoder as tfd
from focalformer3d_tpu_torch.ops import voxelize as tvox
from focalformer3d_tpu_torch.training import losses as tlosses
from focalformer3d_tpu_torch.utils.convert import from_jax_variables
from test_torch_train_step import (_batch, check_gradients, check_losses,
                                   run_both)

torch.set_num_threads(2)
VFE = {"hard": "HardSimpleVFE", "dynamic": "DynamicSimpleVFE"}


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, ref, tol, msg):
    got = got.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (msg, got.shape, ref.shape)
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-3)
    assert err <= tol, f"{msg}: rel err {err:.3g} > {tol}"


def _eq(got, ref, msg):
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref), err_msg=msg)


def deform_tiny(vfe="hard"):
    """Tiny_L with the DeformFormer3D deltas, (JAX config, port config):
    each package's own delta function on its own Tiny_L."""
    jall = _deform_deltas(jax_get_config("Tiny_L"))
    tall = tconfigs.deform_deltas(tconfigs.get_config("Tiny_L"))
    jm = dataclasses.replace(jall["model"], vfe_type=VFE[vfe])
    tm = dataclasses.replace(tall["model"], vfe_type=VFE[vfe])
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    return jm, tm, jall["loss"]


# ---------------------------------------------------------------------------
# dynamic_voxelize
# ---------------------------------------------------------------------------

def _points(seed, n=4000):
    cfg = jax_get_config("Tiny_L")["model"]
    rng = np.random.RandomState(seed)
    pts = synthetic.make_batch(
        rng, batch_size=1, n_points=n, n_boxes=4, max_gts=8,
        num_classes=cfg.decoder.num_classes,
        pc_range=cfg.voxel.point_cloud_range, mode="radial")["points"][0]
    pts[: n // 20, :3] += 9.0  # some out of range
    mask = np.ones(n, bool)
    mask[-n // 10:] = False  # padded tail
    return pts, mask


def _numpy_dynamic(vcfg, pts, mask):
    """float64 reference: (coords, means, per-voxel sum|x|) of the first
    ``max_voxels`` voxels in CSR order."""
    pcr = np.asarray(vcfg.point_cloud_range, np.float32)
    vs = np.asarray(vcfg.voxel_size, np.float32)
    nx, ny, nz = vcfg.grid_size
    c = np.floor((pts[:, :3] - pcr[:3]) / vs).astype(np.int64)
    ok = mask & (c >= 0).all(1) & (c < [nx, ny, nz]).all(1)
    key = (c[:, 1] * nx + c[:, 0]) * nz + c[:, 2]
    keys = np.unique(key[ok])[: vcfg.max_voxels]
    coords, means, sums = [], [], []
    for k in keys:
        sel = ok & (key == k)
        coords.append(c[sel][0][::-1])
        means.append(pts[sel].astype(np.float64).mean(0))
        sums.append(np.abs(pts[sel]).sum(0))
    return np.asarray(coords), np.asarray(means), np.asarray(sums)


@pytest.mark.parametrize("max_voxels", [4096, 150])
def test_dynamic_voxelize_matches_jax(max_voxels):
    """4096: every voxel of the scan kept; 150: a cap that drops voxels."""
    vj = dataclasses.replace(jax_get_config("Tiny_L")["model"].voxel,
                             max_voxels=max_voxels)
    vt = dataclasses.replace(tconfigs.get_config("Tiny_L")["model"].voxel,
                             max_voxels=max_voxels)
    pts, mask = _points(0)
    ref = jax.device_get(jax.jit(
        lambda p, m: jvox.dynamic_voxelize(vj, p, m))(pts, mask))
    got = tvox.dynamic_voxelize(vt, _t(pts), _t(mask))
    _eq(got["coords"], ref["coords"], "coords")
    _eq(got["voxel_mask"], ref["voxel_mask"], "voxel_mask")
    coords, means, sums = _numpy_dynamic(vt, pts, mask)
    n = len(coords)
    assert int(got["voxel_mask"].sum()) == n
    assert (n == max_voxels) == (max_voxels == 150)  # 150 overflows
    np.testing.assert_array_equal(got["coords"][:n].numpy(), coords)
    feats = got["features"].numpy()
    atol = 2 * 2.0 ** -23 * sums
    assert np.all(np.abs(feats[:n] - ref["features"][:n]) <= atol)
    # the dropped points reach no kept voxel, slot V-1 included
    assert np.all(np.abs(feats[:n] - means) <= atol)
    assert not feats[n:].any()


def test_preprocess_points_dynamic_matches_jax():
    """The batched entry point on the dynamic VFE, eval and train caps."""
    jm, tm, _ = deform_tiny("dynamic")
    jm = dataclasses.replace(jm, voxel=dataclasses.replace(
        jm.voxel, max_voxels=200, max_voxels_test=512))
    tm = dataclasses.replace(tm, voxel=dataclasses.replace(
        tm.voxel, max_voxels=200, max_voxels_test=512))
    pts = np.stack([_points(1)[0], _points(2)[0]])
    mask = np.stack([_points(1)[1], _points(2)[1]])
    for train in (False, True):
        ref = jax.device_get(jax_prep(jm, pts, mask, train=train))
        got = tdet.preprocess_points(tm, _t(pts), _t(mask), train=train)
        assert set(got) == set(ref) == {"features", "coords", "voxel_mask"}
        assert got["features"].shape[1] == (200 if train else 512)
        for k in ("coords", "voxel_mask"):
            _eq(got[k], ref[k], k)
        vcfg = dataclasses.replace(tm.voxel, max_voxels=200 if train
                                   else 512)
        for b in range(2):
            one = tvox.dynamic_voxelize(vcfg, _t(pts[b]), _t(mask[b]))
            assert torch.equal(got["features"][b], one["features"])


# ---------------------------------------------------------------------------
# the slice: forward and get_bboxes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["hard", "dynamic"])
def slice_run(request):
    """JAX forward + ``get_bboxes`` of deform Tiny_L on one radial scan, and
    the port model loaded from the same state dict."""
    jm, tm, _ = deform_tiny(request.param)
    sd = make_fake_state_dict(jm, seed=3)
    batch = synthetic.make_batch(
        np.random.RandomState(11), batch_size=1, n_points=3000, n_boxes=6,
        max_gts=8, num_classes=jm.decoder.num_classes,
        pc_range=jm.voxel.point_cloud_range, mode="radial")
    pts, mask = batch["points"], batch["points_mask"]
    model = JaxFF3D(jm)
    vox = jax.jit(lambda p, m: jax_prep(jm, p, m))(pts, mask)
    variables = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, vox, None, False))
    variables = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), variables)
    variables, report = convert_tree(variables, sd)
    assert report.full and not report.unloaded, report.summary()

    @jax.jit
    def run(v, p, m):
        x = jax_prep(jm, p, m)
        out = model.apply(v, x, None, False)
        return x, out, jfd.get_bboxes(jm.decoder, out, 200)

    jvox, jout, jdec = jax.device_get(run(variables, pts, mask))
    tmodel = tdet.FocalFormer3D(tm).eval()
    tmodel.load_state_dict(
        from_jax_variables(jax.tree_util.tree_map(np.asarray, variables),
                           tm), strict=True)
    return dict(tm=tm, pts=pts, mask=mask, jvox=jvox, jout=jout, jdec=jdec,
                tmodel=tmodel)


def test_deform_state_dict_has_no_roi_or_extra_keys(slice_run):
    keys = set(slice_run["tmodel"].state_dict())
    assert not [k for k in keys if ".roi_mlp." in k or "extra_output" in k]
    assert "pts_bbox_head.heatmap_head_img.0.1.weight" in keys
    assert not [k for k in keys if ".decoder.1." in k]


def _picks(out, cfg):
    """The (class * H*W + cell) picks of the one heatmap stage, in query
    order, with their peak values: the port's ``_peak_suppress`` and
    stable top-k on the stage's heatmap logits of ``out``."""
    dh = torch.as_tensor(np.array(out["dense_heatmap"]))[:, 1]
    heat = torch.sigmoid(dh.permute(0, 3, 1, 2))
    peaks = tfd._peak_suppress(heat, cfg.nms_kernel_size,
                               cfg.kernel1_classes).reshape(-1)
    idx = tfd._stable_top_k(peaks, cfg.num_proposals)
    return idx.numpy(), peaks.numpy()


def test_deform_slice_vs_jax(slice_run):
    """preprocess_points -> FocalFormer3D -> get_bboxes, end to end.

    With 200 proposals of Tiny_L's 256 (class, cell) candidates the picks
    reach empty cells whose heats agree to a few float32 ulps, and two such
    near-ties may come in the other order in the port (its heat differs
    from JAX's in the last bits). So the queries are held as a set: the
    port picks the same (class, cell) pairs, in JAX's order except where
    two picks' JAX peak values lie within 1e-6 of each other, and every
    per-query output is compared after that reordering. The decoder is
    permutation-equivariant over its queries, so the reordering moves
    outputs without changing them."""
    r = slice_run
    m, cfg = r["tmodel"], r["tm"].decoder
    with torch.no_grad():
        vox = tdet.preprocess_points(r["tm"], _t(r["pts"]), _t(r["mask"]))
        for k in ("coords", "voxel_mask"):
            _eq(vox[k], r["jvox"][k], k)
        out = m(vox)
        dec = m.get_bboxes(out, 200)
    jout, jdec = r["jout"], r["jdec"]
    assert out["query_labels"].shape == (1, 200)
    assert out["dense_heatmap"].shape[1] == 2  # the dense map + stage 0
    _eq(out["multistage_masks"], jout["multistage_masks"], "HIP masks")
    _close(out["dense_heatmap"], jout["dense_heatmap"], 5e-3, "heatmaps")

    jidx, jpeaks = _picks(jout, cfg)
    tidx, _ = _picks(out, cfg)
    hw = np.prod(out["dense_heatmap"].shape[2:4])
    np.testing.assert_array_equal(jidx // hw, jout["query_labels"][0])
    np.testing.assert_array_equal(tidx // hw, out["query_labels"][0])
    assert sorted(tidx) == sorted(jidx), "the port picks other cells"
    where = {int(i): q for q, i in enumerate(tidx)}
    perm = np.asarray([where[int(i)] for i in jidx])
    moved = np.flatnonzero(perm != np.arange(len(perm)))
    assert np.all(np.abs(jpeaks[jidx[moved]] - jpeaks[tidx[moved]])
                  <= 1e-6), "the port reorders picks that are not ties"

    def q(x):  # the port's per-query tensor in JAX's query order
        return x[..., perm, :] if x.dim() >= 3 else x[..., perm]

    _eq(q(out["query_labels"]), jout["query_labels"], "query labels")
    _close(q(out["query_heatmap_score"]), jout["query_heatmap_score"], 5e-3,
           "query heatmap score")
    for k in ("center", "height", "dim", "rot", "vel", "heatmap"):
        assert out[k].shape[1] == 1  # one decoder round
        _close(q(out[k]), jout[k], 5e-3, f"head {k}")
    _close(q(dec["bboxes"]), jdec["bboxes"], 5e-3, "decoded boxes")
    _close(q(dec["scores"]), jdec["scores"], 5e-3, "decoded scores")
    _eq(q(dec["labels"]), jdec["labels"], "decoded labels")
    _eq(q(dec["mask"]), jdec["mask"], "keep mask")
    assert int(dec["mask"].sum()) > 0


# ---------------------------------------------------------------------------
# one training step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def deform_step(request):
    jm, tm, jlcfg = deform_tiny("hard")
    lcfg = tlosses.LossConfig(code_weights=tuple(jlcfg.code_weights))
    mp = pytest.MonkeyPatch()
    request.addfinalizer(mp.undo)
    return run_both(jm, jlcfg, tm, lcfg, _batch(), mp)


def test_deform_train_step_losses_match_jax(deform_step):
    check_losses(deform_step)


def test_deform_train_step_gradients_match_jax(deform_step):
    check_gradients(deform_step)

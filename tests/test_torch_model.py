"""Parity: the PyTorch port's model against the JAX package, Tiny_L size.

One reference-format state dict (``make_fake_state_dict``) reaches both
packages: ``convert_tree`` builds the flax variables, and the port loads
``from_jax_variables`` of those variables with ``strict=True``. The same
numpy scan goes through both. Stage tests feed each port module the JAX
inputs of that stage (captured from one jitted JAX forward); the slice test
runs ``preprocess_points`` -> forward -> ``get_bboxes`` end to end.

Tolerances (float32, relative to the reference's max magnitude): the sparse
encoder's BEV 2e-4 (as ``tests/test_e2e_torch.py``), the dense stages 1e-4,
heads, decoded boxes and scores 5e-3; query labels, top-k picks, decoded
labels and the keep mask exactly.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focalformer3d_tpu.configs import get_config as jax_get_config
from focalformer3d_tpu.core import box_coder as jbc
from focalformer3d_tpu.core import nms as jnms
from focalformer3d_tpu.data import synthetic
from focalformer3d_tpu.models import focal_decoder as jfd
from focalformer3d_tpu.models import layers as jlayers
from focalformer3d_tpu.models.detector import FocalFormer3D as JaxFF3D
from focalformer3d_tpu.models.detector import preprocess_points as jax_prep
from focalformer3d_tpu.models.sparse_encoder import SparseEncoder as JaxEnc
from focalformer3d_tpu.ops import bilinear as jbil
from focalformer3d_tpu.ops import msda as jmsda
from focalformer3d_tpu.utils.convert import convert_tree
from focalformer3d_tpu.utils.ref_keys import (make_fake_state_dict,
                                              reference_state_shapes)
from focalformer3d_tpu_torch import configs as tconfigs
from focalformer3d_tpu_torch.core import box_coder as tbc
from focalformer3d_tpu_torch.core import nms as tnms
from focalformer3d_tpu_torch.models import detector as tdet
from focalformer3d_tpu_torch.models import layers as tlayers
from focalformer3d_tpu_torch.models.sparse_encoder import (ENGINES,
                                                           SparseEncoder)
from focalformer3d_tpu_torch.ops import bilinear as tbil
from focalformer3d_tpu_torch.ops import msda as tmsda
from focalformer3d_tpu_torch.utils import ref_keys as tref_keys
from focalformer3d_tpu_torch.utils.convert import from_jax_variables

torch.set_num_threads(2)
torch.set_grad_enabled(False)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAPTURED = ("pts_middle_encoder", "pts_neck", "imgpts_neck")


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, ref, tol, msg):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (msg, got.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1e-3)
    err = np.abs(got - ref).max() / scale
    assert err <= tol, f"{msg}: rel err {err:.3g} > {tol}"


def _eq(got, ref, msg):
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref), err_msg=msg)


def _enc_kwargs(cfg):
    return dict(sparse_shape=cfg.sparse_shape,
                output_channels=cfg.sparse_out_channels,
                encoder_channels=cfg.encoder_channels,
                down_paddings=cfg.down_paddings, capacities=cfg.capacities,
                out_capacity=cfg.out_capacity)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_config("Tiny_L")["model"]
    tcfg = tconfigs.get_config("Tiny_L")["model"]
    sd = make_fake_state_dict(jcfg, seed=3)
    model = JaxFF3D(jcfg)
    rng = np.random.RandomState(11)
    batch = synthetic.make_batch(
        rng, batch_size=1, n_points=3000, n_boxes=6, max_gts=8,
        num_classes=jcfg.decoder.num_classes,
        pc_range=jcfg.voxel.point_cloud_range, mode="radial",
    )
    pts, mask = batch["points"], batch["points_mask"]
    vox = jax.jit(lambda p, m: jax_prep(jcfg, p, m))(pts, mask)
    variables = jax.eval_shape(
        lambda: model.init({"params": jax.random.PRNGKey(0)}, vox, None,
                           False))
    variables = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), variables)
    variables, report = convert_tree(variables, sd)
    assert report.full, report.summary()

    @jax.jit
    def run(v, p, m):
        x = jax_prep(jcfg, p, m)
        out, state = model.apply(
            v, x, None, False, mutable=["intermediates"],
            capture_intermediates=lambda mdl, _: mdl.name in CAPTURED)
        inter = {k: state["intermediates"][k]["__call__"][0]
                 for k in CAPTURED}
        return x, out, jfd.get_bboxes(jcfg.decoder, out, 200), inter

    jvox, jout, jdec, inter = jax.device_get(run(variables, pts, mask))
    variables_np = jax.tree_util.tree_map(np.asarray, variables)
    tmodel = tdet.FocalFormer3D(tcfg).eval()
    tmodel.load_state_dict(from_jax_variables(variables_np, tcfg),
                           strict=True)
    return dict(jcfg=jcfg, tcfg=tcfg, sd=sd, variables=variables_np,
                pts=pts, mask=mask, jvox=jvox, jout=jout, jdec=jdec,
                inter=inter, tmodel=tmodel)


# ---------------------------------------------------------------------------
# configs, weights, import hygiene
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["FocalFormer3D_L", "Tiny_L",
                                  "DeformFormer3D_L",
                                  "DeformFormer3D_L_dynamic"])
def test_config_fields_equal(name):
    jcfg = jax_get_config(name)["model"]
    tcfg = tconfigs.get_config(name)["model"]
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.voxel.grid_size == jcfg.voxel.grid_size
    assert tcfg.decoder.coder == tconfigs.BBoxCoderConfig(
        **dataclasses.asdict(jcfg.decoder.coder))
    assert reference_state_shapes(tcfg) == reference_state_shapes(jcfg)
    for dt in ("float32", "bfloat16"):
        c = tconfigs.with_compute_dtype(tcfg, dt)
        assert c.compute_dtype == c.decoder.dtype == dt


def test_full_width_state_dict_loads_strict():
    """FocalFormer3D_L at full width, on the meta device (no memory)."""
    cfg = tconfigs.get_config("FocalFormer3D_L")["model"]
    shapes = reference_state_shapes(cfg)
    with torch.device("meta"):
        model = tdet.FocalFormer3D(cfg)
    own = model.state_dict()
    assert set(own) == set(shapes)
    for k, shape in shapes.items():
        assert tuple(own[k].shape) == tuple(shape), k
    sd = {k: torch.empty(s, device="meta",
                         dtype=torch.int64 if k.endswith("tracked")
                         else torch.float32) for k, s in shapes.items()}
    model.load_state_dict(sd, strict=True)


def test_make_fake_state_dict_matches_reference():
    """The port's random weights equal ``ref_keys.make_fake_state_dict``:
    values for Tiny_L, key order for FocalFormer3D_L (on the meta device)."""
    cfg = tconfigs.get_config("Tiny_L")["model"]
    ref = make_fake_state_dict(cfg, seed=5)
    got = tref_keys.make_fake_state_dict(tdet.FocalFormer3D(cfg), seed=5)
    assert list(got) == list(ref)
    for k, v in ref.items():
        assert got[k].numpy().dtype == v.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    cfg = tconfigs.get_config("FocalFormer3D_L")["model"]
    with torch.device("meta"):
        model = tdet.FocalFormer3D(cfg)
    assert (tref_keys.reference_key_order(model)
            == list(reference_state_shapes(cfg)))


def test_from_jax_variables_round_trip(setup):
    sd2 = from_jax_variables(setup["variables"], setup["tcfg"])
    for k, v in setup["sd"].items():
        if k.endswith("num_batches_tracked") or k.endswith("bev_pos"):
            continue
        np.testing.assert_array_equal(sd2[k].numpy(), v, err_msg=k)


def test_port_imports_no_jax():
    """A tiny forward through the port, with its own scan generator and
    weights, loads neither JAX nor the JAX package."""
    code = (
        "import sys, numpy as np, torch\n"
        "from focalformer3d_tpu_torch.configs import get_config\n"
        "from focalformer3d_tpu_torch.data import synthetic\n"
        "from focalformer3d_tpu_torch.models.detector import (\n"
        "    FocalFormer3D, preprocess_points)\n"
        "from focalformer3d_tpu_torch.utils.ref_keys import "
        "make_fake_state_dict\n"
        "torch.set_num_threads(1)\n"
        "cfg = get_config('Tiny_L')['model']\n"
        "m = FocalFormer3D(cfg).eval()\n"
        "m.load_state_dict(make_fake_state_dict(m, 0), strict=True)\n"
        "b = synthetic.make_batch(np.random.RandomState(0), 1, 2000, 4, 8,\n"
        "                         4, cfg.voxel.point_cloud_range)\n"
        "with torch.no_grad():\n"
        "    v = preprocess_points(cfg, torch.from_numpy(b['points']),\n"
        "                          torch.from_numpy(b['points_mask']))\n"
        "    d = m.get_bboxes(m(v))\n"
        "assert torch.isfinite(d['bboxes']).all()\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'focalformer3d_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


# ---------------------------------------------------------------------------
# module parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dense_from", [2, 4])
def test_sparse_encoder_vs_jax_voxel_engine(setup, dense_from):
    """Engine ``voxel`` in JAX vs ``plain`` here; dense_from 2 is the eval
    path, 4 runs every level and conv_out sparse."""
    jcfg, v = setup["jcfg"], setup["variables"]
    vox = setup["jvox"]
    enc = JaxEnc(engine="voxel", assume_csr=True, dense_from=dense_from,
                 **_enc_kwargs(jcfg))
    ev = {"params": v["params"]["pts_middle_encoder"],
          "batch_stats": v["batch_stats"]["pts_middle_encoder"]}
    ref = jax.jit(lambda e, f, c, m: enc.apply(e, f, c, m, False))(
        ev, vox["features"], vox["coords"], vox["voxel_mask"])
    tenc = SparseEncoder(in_channels=5, engine="plain", dense_from=dense_from,
                         **_enc_kwargs(setup["tcfg"])).eval()
    tenc.load_state_dict(
        setup["tmodel"].pts_middle_encoder.state_dict(), strict=True)
    got = tenc(_t(vox["features"]), _t(vox["coords"]),
               _t(vox["voxel_mask"]))
    _close(got, ref, 2e-4, f"sparse encoder BEV (dense_from={dense_from})")
    if dense_from == 2:
        _close(got, setup["inter"]["pts_middle_encoder"], 2e-4,
               "sparse encoder BEV in the full model")


@pytest.mark.parametrize("engine,dense_from", [("cuda_mxu", 4),
                                               ("cuda_zrun", 2)])
def test_kernel_engines_vs_jax_voxel_engine(setup, engine, dense_from):
    """The meta-chain (K2 + K1) and z-run (K3) engines on the CPU, through
    their kernels' plain versions (bf16 operands), against JAX ``voxel`` at
    the dense boundary each computes (``cuda_mxu`` is all-sparse, the eval
    path of ``cuda_zrun`` dense from L2): 1e-2 of the BEV scale, the bf16
    tolerance of the ``cuda`` engine. Against ``cuda``, which runs the same
    plain versions over the torch-op rulebooks, the BEV is equal. The
    capacities hold every level of this scan: past a capacity the meta
    chain keeps the dropped voxels in its metas, as JAX ``pallas_mxu``
    does, and its active sets part from the coordinate engines'."""
    kw = dict(_enc_kwargs(setup["jcfg"]), capacities=(512, 1024, 512, 256),
              out_capacity=256)
    enc = JaxEnc(engine="voxel", assume_csr=True, dense_from=dense_from,
                 **kw)
    v, vox = setup["variables"], setup["jvox"]
    ev = {"params": v["params"]["pts_middle_encoder"],
          "batch_stats": v["batch_stats"]["pts_middle_encoder"]}
    ref = jax.jit(lambda e, f, c, m: enc.apply(e, f, c, m, False))(
        ev, vox["features"], vox["coords"], vox["voxel_mask"])
    args = (_t(vox["features"]), _t(vox["coords"]), _t(vox["voxel_mask"]))
    bev = {}
    for e in (engine, "cuda"):
        tenc = SparseEncoder(in_channels=5, engine=e, dense_from=dense_from,
                             **kw).eval()
        tenc.load_state_dict(
            setup["tmodel"].pts_middle_encoder.state_dict(), strict=True)
        bev[e] = tenc(*args)
    _close(bev[engine], ref, 1e-2, f"{engine} BEV (bf16)")
    assert torch.equal(bev[engine], bev["cuda"])


@pytest.mark.parametrize("engine", ["cuda_mxu", "cuda_zrun"])
def test_kernel_engine_slice_on_cpu(setup, engine):
    """The whole Tiny_L slice on each new engine (bf16 compute, plain
    kernel paths) gives finite boxes of the reference's shape."""
    tcfg = tconfigs.with_compute_dtype(
        dataclasses.replace(setup["tcfg"], sparse_engine=engine), "bfloat16")
    m = tdet.FocalFormer3D(tcfg).eval()
    m.load_state_dict(setup["tmodel"].state_dict(), strict=True)
    vox = tdet.preprocess_points(tcfg, _t(setup["pts"]), _t(setup["mask"]))
    dec = m.get_bboxes(m(vox), 200)
    assert dec["bboxes"].shape == setup["jdec"]["bboxes"].shape
    assert torch.isfinite(dec["bboxes"]).all()
    assert torch.isfinite(dec["scores"]).all()


@pytest.mark.parametrize("engine", ["plain", "cuda", "cuda_mxu",
                                    "cuda_zrun"])
@pytest.mark.parametrize("train", [False, True])
def test_one_index_block_per_index_build_span(setup, engine, train):
    """The encoder's forward takes one block of ``_index_build`` in each
    "index build" span, as many as ``_index_specs`` counts: the number of
    graphs a card captures (``IndexGraphs``)."""
    tcfg = setup["tcfg"]
    enc = SparseEncoder(in_channels=5, engine=engine,
                        dense_from=tcfg.sparse_dense_from_eval,
                        train_dense_from=tcfg.sparse_dense_from,
                        **_enc_kwargs(tcfg)).train(train)
    vox = tdet.preprocess_points(tcfg, _t(setup["pts"]), _t(setup["mask"]),
                                 train=train)
    build, taken, marks = enc._index_build, [], []

    def counted(*args):
        for block in build(*args):
            taken.append(block)
            yield block

    enc._index_build = counted
    enc(vox["features"], vox["coords"], vox["voxel_mask"], mark=marks.append)
    n = len(enc._index_specs(engine == "cuda_mxu"))
    assert len(taken) == marks.count("index build") == n
    assert n == {(False, False): 4, (False, True): 6,
                 (True, False): 8, (True, True): 8}[
        (engine == "cuda_mxu", train)]


def test_one_state_dict_loads_into_every_engine(setup):
    """The engines add no parameters: the state dict converted from the JAX
    variables loads strictly into the model on each of them."""
    sd = from_jax_variables(setup["variables"], setup["tcfg"])
    for engine in ENGINES:
        m = tdet.FocalFormer3D(
            dataclasses.replace(setup["tcfg"], sparse_engine=engine))
        m.load_state_dict(sd, strict=True)
        assert m.pts_middle_encoder.engine == engine
        assert set(m.state_dict()) == set(sd)


def test_second_fpn_vs_jax(setup):
    m = setup["tmodel"]
    got = m.pts_neck(m.pts_backbone(_t(setup["inter"]["pts_middle_encoder"])))
    _close(got, setup["inter"]["pts_neck"], 1e-4, "SECOND + SECONDFPN")


def test_focal_encoder_vs_jax(setup):
    pfc, stages = setup["tmodel"].imgpts_neck(_t(setup["inter"]["pts_neck"]))
    jpfc, jstages = setup["inter"]["imgpts_neck"]
    _close(pfc, jpfc, 1e-4, "pts_feat_conv")
    assert len(stages) == len(jstages)
    for i, (a, b) in enumerate(zip(stages, jstages)):
        _close(a, b, 1e-4, f"stage feat {i}")


def test_decoder_vs_jax(setup):
    jpfc, jstages = setup["inter"]["imgpts_neck"]
    out = setup["tmodel"].pts_bbox_head(_t(jpfc), [_t(s) for s in jstages])
    jout = setup["jout"]
    _eq(out["query_labels"], jout["query_labels"], "query labels")
    _close(out["query_heatmap_score"], jout["query_heatmap_score"], 5e-3,
           "query heatmap score")
    _close(out["dense_heatmap"], jout["dense_heatmap"], 5e-3, "heatmaps")
    _eq(out["multistage_masks"], jout["multistage_masks"], "HIP masks")
    for k in ("center", "height", "dim", "rot", "vel", "heatmap"):
        _close(out[k], jout[k], 5e-3, f"head {k}")


def test_whole_slice_vs_jax(setup):
    """preprocess_points -> FocalFormer3D -> get_bboxes, end to end."""
    tcfg, m = setup["tcfg"], setup["tmodel"]
    vox = tdet.preprocess_points(tcfg, _t(setup["pts"]), _t(setup["mask"]))
    for k in ("coords", "voxel_mask"):
        _eq(vox[k], setup["jvox"][k], k)
    out = m(vox)
    dec = m.get_bboxes(out, 200)
    jdec, jout = setup["jdec"], setup["jout"]
    _eq(out["query_labels"], jout["query_labels"], "query labels")
    for k in ("center", "height", "dim", "rot", "vel", "heatmap"):
        _close(out[k], jout[k], 5e-3, f"head {k}")
    _close(dec["bboxes"], jdec["bboxes"], 5e-3, "decoded boxes")
    _close(dec["scores"], jdec["scores"], 5e-3, "decoded scores")
    _eq(dec["labels"], jdec["labels"], "decoded labels")
    _eq(dec["mask"], jdec["mask"], "keep mask")


def test_kernel_engine_bf16_on_cpu(setup):
    """The card's configuration (bf16 compute, kernel engine) runs on the
    CPU through the kernel wrapper's plain path, near the f32 result."""
    tcfg = tconfigs.with_compute_dtype(
        dataclasses.replace(setup["tcfg"], sparse_engine="cuda"), "bfloat16")
    m = tdet.FocalFormer3D(tcfg).eval()
    m.load_state_dict(setup["tmodel"].state_dict(), strict=True)
    vox = tdet.preprocess_points(tcfg, _t(setup["pts"]), _t(setup["mask"]))
    bev = m.pts_middle_encoder(vox["features"], vox["coords"],
                               vox["voxel_mask"])
    assert bev.dtype == torch.float32
    _close(bev, setup["inter"]["pts_middle_encoder"], 1e-2,
           "kernel-engine BEV (bf16)")
    dec = m.get_bboxes(m(vox), 200)
    assert dec["bboxes"].shape == setup["jdec"]["bboxes"].shape
    assert torch.isfinite(dec["bboxes"]).all()
    assert torch.isfinite(dec["scores"]).all()


# ---------------------------------------------------------------------------
# ops and core
# ---------------------------------------------------------------------------

def test_bilinear_and_grid_sample():
    rng = np.random.RandomState(0)
    feat = rng.randn(6, 7, 4).astype(np.float32)
    grid = rng.uniform(-1.4, 1.4, (5, 9, 2)).astype(np.float32)
    xy = rng.uniform(-2, 8, (11, 2)).astype(np.float32)
    _close(tbil.grid_sample_norm(_t(feat), _t(grid)),
           jbil.grid_sample_norm(jnp.asarray(feat), jnp.asarray(grid)), 1e-6,
           "grid_sample_norm")
    _close(tbil.bilinear_sample(_t(feat), _t(xy)),
           jbil.bilinear_sample(jnp.asarray(feat), jnp.asarray(xy)), 1e-6,
           "bilinear_sample")


def test_msda_sample():
    rng = np.random.RandomState(1)
    B, Q, nH, P, C = 2, 5, 4, 3, 16
    hw = [(8, 6), (4, 3), (2, 2)]
    vals = [rng.randn(B, h, w, C).astype(np.float32) for h, w in hw]
    loc = rng.uniform(-0.2, 1.2, (B, Q, nH, 3, P, 2)).astype(np.float32)
    wts = rng.rand(B, Q, nH, 3, P).astype(np.float32)
    ref = jax.vmap(lambda v, l, a: jmsda.msda_sample(v, l, a, nH))(
        [jnp.asarray(v) for v in vals], jnp.asarray(loc), jnp.asarray(wts))
    got = tmsda.msda_sample([_t(v) for v in vals], _t(loc), _t(wts), nH)
    _close(got, ref, 1e-5, "msda_sample")


def test_sine_embed():
    pos = np.random.RandomState(2).rand(3, 7, 2).astype(np.float32)
    _close(tlayers.sine_embed_2d(_t(pos)),
           jlayers.sine_embed_2d(jnp.asarray(pos)), 1e-5, "sine embed")


def test_box_decode():
    rng = np.random.RandomState(3)
    cfg = tconfigs.get_config("FocalFormer3D_L")["model"].decoder
    jcfg = jax_get_config("FocalFormer3D_L")["model"].decoder
    Q = 50
    heat = rng.rand(2, Q, 10).astype(np.float32)
    heat[0, :5] = 0.0  # all-zero rows: label 0, masked by the threshold
    parts = [rng.randn(2, Q, d).astype(np.float32) for d in (2, 1, 3, 2, 2)]
    parts[0] = parts[0] * 100 + 90  # some centres outside the range
    ref = jbc.decode(jcfg.coder, jnp.asarray(heat),
                     *[jnp.asarray(p) for p in parts], apply_filter=True)
    got = tbc.decode(cfg.coder, _t(heat), *[_t(p) for p in parts],
                     apply_filter=True)
    _close(got["bboxes"], ref["bboxes"], 1e-6, "bboxes")
    _close(got["scores"], ref["scores"], 0, "scores")
    _eq(got["labels"], ref["labels"], "labels")
    _eq(got["mask"], ref["mask"], "mask")
    assert 0 < int(got["mask"].sum()) < 2 * Q


@pytest.mark.parametrize("k", [1, 7, 40])
def test_top_k_mask_ties(k):
    rng = np.random.RandomState(4)
    s = rng.randint(0, 4, (3, 30)).astype(np.float32)  # many ties
    valid = rng.rand(3, 30) > 0.3
    ref = jax.vmap(lambda a, b: jnms.top_k_mask(a, b, k))(
        jnp.asarray(s), jnp.asarray(valid))
    _eq(tnms.top_k_mask(_t(s), _t(valid), k), ref, "top_k_mask")


def test_stable_top_k_matches_lax_top_k():
    from focalformer3d_tpu_torch.models.focal_decoder import _stable_top_k

    x = np.random.RandomState(5).randint(0, 3, (2, 64)).astype(np.float32)
    _, ref = jax.lax.top_k(jnp.asarray(x), 20)
    _eq(_stable_top_k(_t(x), 20), ref, "top-k with ties")

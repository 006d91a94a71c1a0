"""Slice parity: one Tiny_L training step on a batch from the dataset layer.

A written nuScenes-format directory (``synthetic_dirs.write_nuscenes``, with
the GT database of the port's ``create_gt_database``) goes through the
train CLI's data path in each package for one seed: the port's
``tools/train.nuscenes_batches`` and the JAX CLI's nuScenes branch
(``tools/train.py:151-200``, the same calls: ``DBSampler`` with the CLI's
groups, ``train_pipeline`` with GT-paste, ``cbgs_indices``, the
permutation, ``collate``). The two first batches are equal bit for bit.
Then one training step of each package on its own batch, with one
reference-format state dict in both, dropout off and one numpy draw for
the GT-group noise (as ``tests/test_torch_train_step.py``): every loss
term and the gradient norm within 1e-5 relative, ``num_pos`` exactly, and
every gradient within 2e-4 of its tensor's largest (the tolerances and the
analytic-zero exceptions of ``tests/test_torch_train_step.py``). The JAX
side is the step's own loss function (``make_train_step.loss_fn``) under
``jax.value_and_grad``, with ``optax.global_norm`` of its gradients.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from focalformer3d_tpu.configs import get_config as jax_get_config
from focalformer3d_tpu.data import nuscenes as jnusc
from focalformer3d_tpu.data import pipelines as jpl
from focalformer3d_tpu.models import focal_decoder as jfd
from focalformer3d_tpu.models.deformable_decoder import DeformableDecoder
from focalformer3d_tpu.models.detector import FocalFormer3D as JaxFF3D
from focalformer3d_tpu.models.detector import preprocess_points as jax_prep
from focalformer3d_tpu.training.losses import detection_loss
from focalformer3d_tpu.utils.convert import convert_tree
from focalformer3d_tpu.utils.ref_keys import make_fake_state_dict
from focalformer3d_tpu_torch.configs import get_config
from focalformer3d_tpu_torch.models import focal_decoder as tfd
from focalformer3d_tpu_torch.tools import train as train_cli
from focalformer3d_tpu_torch.training import optim as toptim
from focalformer3d_tpu_torch.training import train_step as tstep

from test_torch_dataset_cli import MAX_POINTS, write_tiny
from test_torch_train_step import (GRAD_TOL, LOSS_TOL, _configs, _flatten,
                                   _port_model, _rel)

torch.set_num_threads(2)
SEED = 11
BATCH = 2


def _jax_batch(root, cfg_all):
    """The JAX CLI's nuScenes branch, up to its first batch."""
    cfg, classes = cfg_all["model"], cfg_all["class_names"]
    rng = np.random.RandomState(SEED)
    sampler = jnusc.DBSampler(
        str(root / "nuscenes_dbinfos_train.pkl"), str(root), classes,
        sample_groups=dict(
            car=2, truck=3, construction_vehicle=7, bus=4, trailer=6,
            barrier=2, motorcycle=6, bicycle=6, pedestrian=2,
            traffic_cone=2),
        min_points={c: 5 for c in classes})
    ds = jnusc.NuScenesDataset(
        str(root / "nuscenes_infos_train.pkl"), data_root=str(root),
        classes=classes, pipeline=jpl.train_pipeline(
            cfg.voxel.point_cloud_range, classes, db_sampler=sampler))
    order = rng.permutation(ds.cbgs_indices(rng))
    b = jnusc.collate([ds.get_sample(int(i), rng) for i in order[:BATCH]],
                      classes, max_points=MAX_POINTS,
                      max_gts=cfg.decoder.max_gts // 4)
    b.pop("tokens")
    return b


def _port_batch(root, cfg_all):
    args = train_cli.parse_args(["Tiny_L", "--data-root", str(root),
                                 "--max-points", str(MAX_POINTS)])
    batch_iter, _, ds = train_cli.nuscenes_batches(
        args, cfg_all, BATCH, np.random.RandomState(SEED))
    assert type(ds.pipeline.transforms[0]).__name__ == "ObjectSample"
    return next(iter(batch_iter(0)))


@pytest.fixture(scope="module")
def both(tmp_path_factory, request):
    root = write_tiny(tmp_path_factory.mktemp("nuscenes"), seed=8)
    jm, jlcfg, tm, lcfg = _configs()
    batch = _port_batch(root, {**get_config("Tiny_L"), "model": tm})
    jbatch = _jax_batch(root, jax_get_config("Tiny_L"))
    G = batch["gt_boxes"].shape[1]
    noise = np.random.RandomState(9).uniform(
        -1, 1, (BATCH, jm.decoder.add_gt_groups * G, 2)).astype(np.float32)
    sd = make_fake_state_dict(jm, seed=4)

    # ---- JAX: the step's loss function, value and gradients ----
    mp = pytest.MonkeyPatch()
    request.addfinalizer(mp.undo)
    mp.setattr(jfd, "DeformableDecoder",
               functools.partial(DeformableDecoder, dropout=0.0))
    mp.setattr(jax.random, "uniform",
               lambda key, shape, *a, **k: jnp.asarray(noise))
    model = JaxFF3D(jm)
    jb = {k: jnp.asarray(v) for k, v in jbatch.items()}
    variables = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "gt": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)},
        jax_prep(jm, jb["points"], jb["points_mask"], train=True), None,
        True, jb["gt_boxes"], jb["gt_labels"], jb["gt_valid"]))
    variables = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), variables)
    variables, report = convert_tree(variables, sd)
    assert report.full, report.summary()

    @jax.jit
    def run(params, batch_stats, batch):
        def loss_fn(p):
            v = jax_prep(jm, batch["points"], batch["points_mask"],
                         train=True)
            out, _ = model.apply(
                {"params": p, "batch_stats": batch_stats}, v, None, True,
                batch["gt_boxes"], batch["gt_labels"], batch["gt_valid"],
                rngs={"gt": jax.random.PRNGKey(0),
                      "dropout": jax.random.PRNGKey(0)},
                mutable=["batch_stats"])
            return detection_loss(jm.decoder, jlcfg, out, batch["gt_boxes"],
                                  batch["gt_labels"], batch["gt_valid"])

        (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params)
        metrics["grad_norm"] = optax.global_norm(grads)
        return metrics, grads

    jmetrics, jgrads = jax.device_get(run(variables["params"],
                                          variables["batch_stats"], jb))
    mp.undo()

    # ---- port: one make_train_step step on the port's batch ----
    tmodel = _port_model(tm, sd)
    tx = toptim.make_optimizer(total_steps=10)
    opt_state = tx.init(list(tmodel.parameters()))
    with pytest.MonkeyPatch.context() as tmp:
        tmp.setattr(tfd, "gt_group_noise",
                    lambda gen, shape, device: torch.from_numpy(noise))
        tmetrics = tstep.make_train_step(tm, lcfg, tx)(
            tmodel, opt_state, {k: torch.from_numpy(v)
                                for k, v in batch.items()}, None)
    tgrads = {n: p.grad.numpy() for n, p in tmodel.named_parameters()
              if p.grad is not None}
    return dict(jm=jm, batch=batch, jbatch=jbatch, jmetrics=jmetrics,
                jgrads=jgrads, tmetrics=tmetrics, tgrads=tgrads)


def test_batches_equal(both):
    b, jb = both["batch"], both["jbatch"]
    assert set(b) == set(jb)
    for k in jb:
        assert b[k].dtype == jb[k].dtype, k
        np.testing.assert_array_equal(b[k], jb[k], err_msg=k)
    # a real training batch: points, GT boxes (pasted ones among them)
    assert b["points_mask"].sum() > 2000 and b["gt_valid"].sum() >= 4


def test_losses_match(both):
    jmet, tmet = both["jmetrics"], both["tmetrics"]
    assert set(jmet) <= set(tmet), set(jmet) - set(tmet)
    assert float(tmet["num_pos"]) == float(jmet["num_pos"]) > 0
    for k in sorted(jmet):
        rel = _rel(tmet[k].numpy(), jmet[k])
        assert rel <= LOSS_TOL, f"{k}: {float(tmet[k])} vs {jmet[k]} " \
                                f"rel {rel:.3g}"


def test_gradients_match(both):
    tgrads, jgrads = both["tgrads"], both["jgrads"]
    tmpl = {"params": jax.tree_util.tree_map(np.zeros_like, jgrads)}
    conv, report = convert_tree(tmpl, tgrads)
    assert not report.missed and not report.unmapped, report.summary()
    got, ref = _flatten(conv["params"]), _flatten(jgrads)
    assert set(got) == set(ref) and len(ref) > 100
    # the analytic zeros of tests/test_torch_train_step.py: rounding noise
    # in both packages, below 1e-5 of the largest gradient
    jm = both["jm"]
    last = f"decoder{jm.decoder.num_decoder_layers - 1}/layer" \
        f"{jm.decoder.inner_layers - 1}/norm3/bias"
    gmax = max(np.abs(r).max() for r in ref.values())
    worst = []
    for path, r in ref.items():
        name = "/".join(path)
        if name.endswith("self_attn/k/bias") or name.endswith(last):
            assert max(np.abs(r).max(), np.abs(got[path]).max()) \
                <= 1e-5 * gmax, name
            continue
        worst.append((_rel(got[path], r), name))
    worst.sort()
    assert worst[-1][0] <= GRAD_TOL, worst[-5:]

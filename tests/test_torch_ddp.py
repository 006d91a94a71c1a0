"""Data parallelism in the port, over gloo on the CPU, two processes.

- The mesh counterparts (``parallel/mesh.py``), as
  ``tests/test_multihost.py::test_two_process_cpu_cluster`` holds JAX's:
  the group's start, rank and size, the indices' shard, and
  ``gather_to_host`` of every rank's rows.
- SyncBN: ``models/layers.apply_bn`` at world size 2, plain and masked,
  with unequal row and valid counts on the two ranks: its output, the
  inputs' gradients, the parameters' gradients summed over the ranks and
  the running statistics equal world size 1 on the concatenated rows,
  within 1e-6 of each tensor's scale.
- One Tiny_L training step on engine ``plain`` at world size 2, batch 1 a
  rank (``tools/dryrun_ddp`` workers): equal to the port's world-size-1
  step at batch 2 (``dryrun_ddp.compare``) and to JAX's ``make_train_step``
  jitted over a 2-device mesh (the state replicated, the batch sharded, as
  ``__graft_entry__.dryrun_multichip``), at
  ``tests/test_torch_train_step.py``'s tolerances: losses, gradients,
  updated parameters and batch-norm statistics. The two ranks end with the
  same parameters bit for bit. The same step with one piece of the
  data-parallel step broken (``dryrun_ddp.planted``: SyncBN's backward
  without the other rank's cotangents, the loss normalisers counted on the
  rank's shard, no gradient all-reduce) fails that comparison, and
  fails the gate that ``chip_smoke.py`` phase 18 holds the full-width step
  to (``dryrun_ddp.compare_to_floor``), which the clean step passes.
- The train CLI at world size 2 on a 7-sample written directory at a
  global batch of 4: shards of 4 and 3 samples, and both ranks take the
  shortest shard's one step (the JAX CLI would take 2 and 1, and hang).
- ``python -m focalformer3d_tpu_torch.tools.dryrun_ddp``: its ranks on
  the CPU under ``--device cpu``, and on the card by default, raising
  where there is none.

The children import the port only, rendezvous through a file or a free
port of this run, and each has a time limit.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from focalformer3d_tpu.parallel import mesh as jmesh
from focalformer3d_tpu_torch.parallel import mesh as tmesh
from focalformer3d_tpu_torch.tools import dryrun_ddp as dd
from focalformer3d_tpu_torch.training import checkpoint as ckpt
from test_torch_dataset_cli import write_tiny
from test_torch_train_step import (_batch, _configs, _noise, _port_model,
                                   check_gradients, check_losses,
                                   check_params, run_both)

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 300


def _run_workers(script, tmp_path, n=2, timeout=TIMEOUT):
    """``script`` in ``n`` processes (WORLD_SIZE / RANK set, the port on
    the path, a file rendezvous in ``tmp_path``); returns their stdouts."""
    path = tmp_path / "worker.py"
    path.write_text(script)
    env = {**os.environ, "PYTHONPATH": str(REPO),
           "INIT": f"file://{tmp_path}/rendezvous", "OUT": str(tmp_path),
           "WORLD_SIZE": str(n)}
    procs = [subprocess.Popen([sys.executable, str(path)],
                              env={**env, "RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(n)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return [o for o, _ in outs]


# ---------------------------------------------------------------------------
# the mesh counterparts
# ---------------------------------------------------------------------------

MESH_WORKER = textwrap.dedent("""
    import os
    import numpy as np
    import torch
    from focalformer3d_tpu_torch.parallel import mesh as M

    assert M.init_distributed("gloo", os.environ["INIT"])
    assert M.world_size() == 2
    r = M.rank()
    assert r == int(os.environ["RANK"]) and M.is_main_process() == (r == 0)
    assert list(M.shard(np.arange(7))) == [[0, 2, 4, 6], [1, 3, 5]][r]
    local = torch.full((2, 3), float(r))  # the rank's rows
    got = M.gather_to_host({"x": local, "n": torch.tensor(r + 1)})
    assert got["x"].shape == (4, 3) and float(got["x"].sum()) == 6.0
    assert list(got["n"]) == [1, 2]
    M.shutdown()
    if r == 0:
        print("MULTIHOST_OK")
""")


def test_two_process_cpu_cluster(tmp_path):
    outs = _run_workers(MESH_WORKER, tmp_path)
    assert "MULTIHOST_OK" in outs[0]


def test_init_distributed_without_world_size(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert tmesh.init_distributed("gloo") is False
    assert tmesh.world_size() == 1 and tmesh.rank() == 0
    x = torch.ones(3)
    assert tmesh.all_reduce_sum(x, "bn") is x  # no group: no collective


# ---------------------------------------------------------------------------
# SyncBN
# ---------------------------------------------------------------------------

# the SyncBN case, run by the workers (which import the port only) and by
# this process at world size 1
BN_CASE = textwrap.dedent("""
    import numpy as np
    import torch
    from focalformer3d_tpu_torch.models.layers import apply_bn

    ROWS = (37, 23)  # rows a rank
    C = 8


    def bn_inputs(r):
        \"\"\"Rank r's rows, mask (unequal valid counts), cotangent.\"\"\"
        rng = np.random.RandomState(r)
        x = (rng.randn(ROWS[r], C) * 2 + 0.5).astype(np.float32)
        mask = rng.rand(ROWS[r]) < (0.3 if r else 0.8)
        cot = rng.randn(ROWS[r], C).astype(np.float32)
        return x, mask, cot


    def bn_step(x, mask, cot, masked):
        \"\"\"apply_bn in training from fixed parameters and statistics:
        its output, the gradients of x, weight and bias, and the new
        running statistics.\"\"\"
        bn = torch.nn.BatchNorm1d(C, momentum=0.01)
        g = torch.Generator().manual_seed(1)
        with torch.no_grad():
            bn.weight.copy_(torch.rand(C, generator=g) + 0.5)
            bn.bias.copy_(torch.randn(C, generator=g))
            bn.running_mean.copy_(torch.randn(C, generator=g))
            bn.running_var.copy_(torch.rand(C, generator=g) + 0.5)
        bn.train()
        x = torch.from_numpy(x).requires_grad_(True)
        with torch.enable_grad():  # whatever the importer's grad mode
            y = apply_bn(x, bn, torch.from_numpy(mask) if masked else None)
            (y * torch.from_numpy(cot)).sum().backward()
        return {"y": y.detach(), "dx": x.grad, "dw": bn.weight.grad,
                "db": bn.bias.grad, "mean": bn.running_mean.clone(),
                "var": bn.running_var.clone()}
""")

SYNCBN_WORKER = BN_CASE + textwrap.dedent("""
    import os
    from focalformer3d_tpu_torch.parallel import mesh as M

    assert M.init_distributed("gloo", os.environ["INIT"])
    r = M.rank()
    M.reset_collectives()
    out = {m: bn_step(*bn_inputs(r), masked=m) for m in (False, True)}
    out["collectives"] = M.collectives()
    torch.save(out, os.path.join(os.environ["OUT"], f"bn{r}.pt"))
    M.shutdown()
""")


def test_syncbn_equals_the_concatenated_batch_norm(tmp_path):
    case = {}
    exec(BN_CASE, case)
    _run_workers(SYNCBN_WORKER, tmp_path)
    ranks = [torch.load(tmp_path / f"bn{r}.pt", weights_only=True)
             for r in range(2)]
    # the plain branch one collective, the masked one two
    assert ranks[0]["collectives"] == {"bn": 3}
    ins = [case["bn_inputs"](r) for r in range(2)]
    for masked in (False, True):
        ref = case["bn_step"](*(np.concatenate(p) for p in zip(*ins)),
                              masked=masked)
        got = {"y": torch.cat([o[masked]["y"] for o in ranks]),
               "dx": torch.cat([o[masked]["dx"] for o in ranks]),
               "dw": ranks[0][masked]["dw"] + ranks[1][masked]["dw"],
               "db": ranks[0][masked]["db"] + ranks[1][masked]["db"]}
        for k in ("mean", "var"):
            assert torch.equal(ranks[0][masked][k], ranks[1][masked][k])
            got[k] = ranks[0][masked][k]
        for k, v in ref.items():
            err = float((got[k] - v).abs().max() / v.abs().max())
            assert err <= 1e-6, (masked, k, err)


# ---------------------------------------------------------------------------
# one training step at world size 2
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dp_step(tmp_path_factory):
    """The world-size-2 step (two ``dryrun_ddp`` workers) and the port's
    world-size-1 step, on the same batch, weights (seed 4) and group
    noise."""
    tmp = tmp_path_factory.mktemp("ddp")
    batch = _batch()
    jm = _configs()[0]
    inputs = {**batch, "noise": _noise(jm, batch)}
    np.savez(tmp / "inputs.npz", **inputs)
    dd.spawn(2, ["--init-method", f"file://{tmp}/rendezvous", "--device",
                 "cpu", "--config", "Tiny_L", "--engines", "plain",
                 "--inputs", str(tmp / "inputs.npz"), "--weights-seed", "4",
                 "--out", str(tmp), "--plant", ",".join(dd.FAULTS)],
             TIMEOUT, str(tmp))
    ws1 = dd.one_step("Tiny_L", "plain", inputs, 4, torch.device("cpu"))
    ws1_reversed = dd.one_step("Tiny_L", "plain", {
        k: v[::-1].copy() for k, v in inputs.items()}, 4,
        torch.device("cpu"))
    ranks = [torch.load(dd.result_path(str(tmp), "plain", r),
                        weights_only=True) for r in range(2)]
    planted = {f: torch.load(dd.result_path(str(tmp), "plain", 0, f),
                             weights_only=True) for f in dd.FAULTS}
    return dict(batch=batch, ws1=ws1, ws1_reversed=ws1_reversed,
                ranks=ranks, planted=planted)


@pytest.fixture(scope="module")
def mesh_both(dp_step):
    """JAX's step jitted over a 2-device mesh (``run_both``), its port
    side replaced by the world-size-2 step's rank 0 (global metrics,
    gradients, state)."""
    jm, jlcfg, tm, lcfg = _configs()
    mp = pytest.MonkeyPatch()
    try:
        both = run_both(jm, jlcfg, tm, lcfg, dp_step["batch"], mp,
                        mesh=jmesh.make_mesh(2))
    finally:
        mp.undo()
    r0 = dp_step["ranks"][0]
    both["tmetrics"] = {k: torch.tensor(v) for k, v in r0["metrics"].items()}
    both["tgrads"] = {k: v.numpy() for k, v in r0["grads"].items()}
    model = _port_model(both["tm"], both["sd"])
    model.load_state_dict(r0["state"], strict=True)
    both["tmodel"] = model
    return both


def test_dp_step_equals_the_world_size_1_step(dp_step):
    ranks = dp_step["ranks"]
    assert [r["world"] for r in ranks] == [2, 2]
    report = dd.compare(ranks[0], dp_step["ws1"])
    assert report["ok"], report
    # one all-reduce for the loss normalisers and one for the gradients
    assert ranks[0]["collectives"]["loss"] == 1
    assert ranks[0]["collectives"]["grad"] == 1
    assert ranks[0]["bn_collectives"] > 50


@pytest.mark.parametrize("fault", dd.FAULTS)
def test_dp_step_comparison_fails_a_planted_fault(dp_step, fault):
    got, ref = dp_step["planted"][fault], dp_step["ws1"]
    report = dd.compare(got, ref)
    assert report["grad_worst"][0] > 1.0 and not report["ok"], report
    # SyncBN's backward and the gradients' sum leave the forward alone
    moved = abs(got["metrics"]["loss"] / ref["metrics"]["loss"] - 1)
    assert (moved > dd.LOSS_TOL) == (fault == "local_counts"), moved


@pytest.mark.parametrize("engine", ["plain", "cuda"])
@pytest.mark.parametrize("fault", (None,) + dd.FAULTS)
def test_floor_gate_passes_the_step_and_fails_planted_faults(
        dp_step, fault, engine):
    """``dryrun_ddp.compare_to_floor``, phase 18's gate on the card, on
    the Tiny_L step: the world-size-2 step passes, each planted fault
    fails through the gradients; the loss is held to 1e-5 on ``plain``
    and to bf16's unit roundoff on a kernel engine."""
    def as_engine(r):
        return {**r, "engine": engine}

    got = dp_step["ranks"][0] if fault is None else dp_step["planted"][fault]
    report = dd.compare_to_floor(as_engine(got), as_engine(dp_step["ws1"]),
                                 as_engine(dp_step["ws1_reversed"]))
    assert report["loss_tol"] == (dd.LOSS_TOL if engine == "plain"
                                  else dd.BF16_ROUNDOFF)
    assert report["grad_tol"] >= dd.GRAD_TOL
    assert report["ok"] == (fault is None), report
    if fault is not None:
        assert report["grad"] > 10 * report["grad_tol"], report


def test_dp_ranks_hold_the_same_state(dp_step):
    a, b = dp_step["ranks"]
    assert a["metrics"] == b["metrics"]
    for k in a["grads"]:
        assert torch.equal(a["grads"][k], b["grads"][k]), k
    for k in a["state"]:
        assert torch.equal(a["state"][k], b["state"][k]), k


# JAX's mesh step compiles for ~2 min on the CPU: the quick profile holds
# the world-size-2 step to the world-size-1 step, which
# tests/test_torch_train_step.py holds to JAX
@pytest.mark.slow
def test_dp_step_losses_match_jax_mesh(mesh_both):
    check_losses(mesh_both)


@pytest.mark.slow
def test_dp_step_gradients_match_jax_mesh(mesh_both):
    check_gradients(mesh_both)


@pytest.mark.slow
def test_dp_step_params_and_batch_stats_match_jax_mesh(mesh_both):
    assert jax.device_count() >= 2
    check_params(mesh_both)


# ---------------------------------------------------------------------------
# the train CLI at world size 2: uneven shards
# ---------------------------------------------------------------------------

def test_train_cli_takes_the_shortest_shards_steps(tmp_path):
    data = write_tiny(tmp_path / "nusc", samples=7)
    work = tmp_path / "work"
    env = {**os.environ, "PYTHONPATH": str(REPO), "WORLD_SIZE": "2",
           "MASTER_ADDR": "127.0.0.1", "OMP_NUM_THREADS": "2",
           "MASTER_PORT": str(chip_smoke._free_port())}
    argv = [sys.executable, "-m", "focalformer3d_tpu_torch.tools.train",
            "Tiny_L", "--device", "cpu", "--data-root", str(data),
            "--no-cbgs", "--epochs", "1", "--batch-size", "4",
            "--log-interval", "1", "--max-points", "6000", "--work-dir",
            str(work), "--no-tensorboard"]
    procs = [subprocess.Popen(argv, cwd=str(REPO), env={
        **env, "RANK": str(r), "LOCAL_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    # rank 0 alone prints, logs and saves
    assert "batch 2, world size 2, global batch 4, 1 iters/epoch" in outs[0][0]
    assert outs[1][0] == ""
    recs = [json.loads(x) for x in open(work / "train_log.jsonl")]
    assert [r["iter"] for r in recs if r["mode"] == "train"] == [1]
    assert ckpt.list_epochs(str(work)) == [1]
    assert sorted(os.listdir(work)) == ["epoch_1", "train_log.jsonl"]


# ---------------------------------------------------------------------------
# the dryrun CLI
# ---------------------------------------------------------------------------

def test_dryrun_cli_on_the_cpu(capsys):
    dd.main(["2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("dryrun_ddp(2): loss=") and out.rstrip().endswith(
        " OK"), out


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_dryrun_cli_asks_for_the_card_by_default():
    with pytest.raises(SystemExit, match="no CUDA device"):
        dd.main(["2"])

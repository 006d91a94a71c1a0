"""Shared parts of the H100 probes: timing by CUDA events, the bound, the
check of a kernel against its plain version, one row per case, and the
voxel sets that the TPU probes drew.

A row is a dict: ``probe`` and ``case`` name it; ``kernel`` is the port
kernel it launches (None for a row that times PyTorch ops alone, named by
``op``); ``ms`` the kernel's time, ``plain_ms`` its plain version's,
``library_ms`` the PyTorch call's (``op``), each timed by ``time_ms`` (the
device's time per call, from a CUDA graph of back-to-back calls, so the
host's pace never enters); ``bound_ms`` / ``bound_by`` the least time the
card could take for the case's work (inputs read once, outputs written
once, over 3.35 TB/s, against its operations over the peak of their type);
``rate`` in ``rate_unit``; ``check``, ``max_abs_err``, ``rel_err`` and
``ok`` the comparison with the plain version. On the CPU nothing is timed:
every time and rate is None, the checks still run.
"""
from __future__ import annotations

import subprocess
from typing import Callable, Optional

import numpy as np
import torch

from ..ops import cuda_build
from ..ops import sparse_conv as sc
from ..ops import sparse_conv_cuda as k1

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}  # dense, published
TOL = 1e-3  # of the output's scale, for sums taken in another order
REPS = 10  # timed calls per case
PLAIN_REPS = 2

# tools/micro_mxu_probe.py:probe_kernel: level -> (V, C, Cout, grid)
LEVELS = {0: (153600, 16, 16, (41, 1440, 1440)),
          1: (243712, 32, 32, (21, 720, 720)),
          2: (187392, 64, 64, (11, 360, 360))}
SMALL_LEVELS = {0: (600, 16, 16, (5, 40, 40)),
                1: (500, 32, 32, (5, 20, 20)),
                2: (300, 64, 64, (3, 12, 12))}


def card() -> torch.device:
    """The card a probe's ``main`` measures on; raises without one."""
    if not torch.cuda.is_available():
        raise SystemExit("the probes measure an NVIDIA GPU: "
                         "torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def time_ms(device: torch.device, fn: Callable, reps: int = REPS):
    """(mean ms per call, the last call's result). One eager call loads
    the kernels and warms the allocator; ``reps`` calls are then captured
    in one CUDA graph, replayed once to warm up and once between CUDA
    events: the device's time, without the host's. The kernels' launch
    counts take each replay's launches (a call made while capturing
    launches nothing). On the CPU: (None, one call's result)."""
    if device.type != "cuda":
        return None, fn()
    fn()
    torch.cuda.synchronize()
    cuda_build.take_captured()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            out = fn()
    captured = cuda_build.take_captured()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    graph.replay()
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    cuda_build.add_replays(captured, 2)
    return start.elapsed_time(end) / reps, out


def bound(nbytes: float, flops: float = 0.0, peak: str = "bf16") -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[peak] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def compare(got: torch.Tensor, ref: torch.Tensor, check: str) -> dict:
    """``exact``: equal bit for bit (as values); ``scale``: max |diff| <=
    ``TOL`` * max |ref|. Both also need the shape and finite values."""
    if got.shape != ref.shape:
        return {"max_abs_err": None, "rel_err": None, "ok": False}
    g, r = got.double(), ref.double()
    err = float((g - r).abs().max()) if g.numel() else 0.0
    scale = float(r.abs().max()) if r.numel() else 0.0
    rel = err / scale if scale else err
    ok = bool(torch.isfinite(g).all())
    ok &= torch.equal(got, ref) if check == "exact" else rel <= TOL
    return {"max_abs_err": err, "rel_err": rel, "ok": ok}


def _rate(ms, rate):
    if ms is None or rate is None:
        return None
    amount, scale, _unit = rate
    return amount / (ms * 1e-3) / scale


def case(device, probe: str, name: str, *, kernel: str, run: Callable,
         plain: Callable, check: str, nbytes: float, flops: float = 0.0,
         peak: str = "bf16", library: Optional[Callable] = None,
         op: Optional[str] = None, rate=None, headline: bool = False,
         keep: Optional[list] = None, **extra) -> dict:
    """One kernel case: ``run`` launched and timed, its last result held
    against ``plain`` (also timed; no launch is made for the comparison
    alone), ``library`` timed where one PyTorch call computes the same
    function. ``rate`` is (amount, scale, unit); ``keep`` receives the
    kernel's last result. A ``run`` that returns a list of results (one per
    launch) is compared as their concatenation."""
    ms, got = time_ms(device, run)
    if isinstance(got, list):
        got = torch.cat(got)
    if keep is not None:
        keep.append(got)
    plain_ms, ref = time_ms(device, plain, PLAIN_REPS)
    lib_ms = None
    if library is not None and device.type == "cuda":
        lib_ms = time_ms(device, library)[0]
    return {"probe": probe, "case": name, "kernel": kernel,
            "headline": headline, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "op": op,
            **bound(nbytes, flops, peak), "rate": _rate(ms, rate),
            "rate_unit": rate and rate[2],
            "check": check, **compare(got, ref, check), **extra}


def op_case(device, probe: str, name: str, *, op: str, fn: Callable,
            nbytes: float, flops: float = 0.0, rate=None,
            ref: Optional[Callable] = None) -> dict:
    """PyTorch ops timed alone (the XLA parts of a TPU probe), held
    exactly against ``ref`` where one is given, else checked finite."""
    lib_ms, got = time_ms(device, fn)
    cmp = ({"max_abs_err": None, "rel_err": None,
            "ok": bool(torch.isfinite(got.float()).all())} if ref is None
           else compare(got, ref(), "exact"))
    return {"probe": probe, "case": name, "kernel": None, "headline": False,
            "ms": None, "plain_ms": None, "library_ms": lib_ms, "op": op,
            **bound(nbytes, flops), "rate": _rate(lib_ms, rate),
            "rate_unit": rate and rate[2],
            "check": "exact" if ref is not None else "finite", **cmp}


def conv_bytes_flops(feats, rules, w, out_valid):
    """A sparse conv's (bytes, FLOPs, hits): bf16 features and weights,
    int32 rules and the out_valid bytes read once, the f32 output written
    once; 2 FLOPs per (rule that hits at a valid site, C, Cout)."""
    B, v_in, c = feats.shape
    K, _, cout = w.shape
    v_out = out_valid.shape[1]
    hits = int(((rules < v_in) & out_valid[:, None]).sum())
    nbytes = (B * v_in * c * 2 + rules.numel() * 4 + K * c * cout * 2
              + B * v_out + B * v_out * cout * 4)
    return nbytes, 2 * hits * c * cout, hits


PHASE_NAMES = {k1.PHASE_FULL: "full", k1.PHASE_GATHER: "gather only",
               k1.PHASE_MMA: "product only", 0: "rule loads only"}


def conv_case(device, probe: str, name: str, feats, rules, w, out_valid,
              phases: int = k1.PHASE_FULL, headline: bool = False,
              keep: Optional[list] = None) -> dict:
    """K1's probe in one mode on bf16 features (B, V, C) and weights
    (K, C, Cout). Full mode: within ``TOL`` of the plain conv and, on a
    card, equal bit for bit to production K1 (``sparse_conv``, timed as
    ``k1_ms``). The other modes compute zeros here (no bias), held exactly;
    their bound is the full conv's."""
    nbytes, flops, hits = conv_bytes_flops(feats, rules, w, out_valid)
    full = phases == k1.PHASE_FULL
    kept = [] if keep is None else keep
    row = case(device, probe, name, kernel="sparse_conv_probe",
               run=lambda: k1.sparse_conv_probe(feats, rules, w, out_valid,
                                                phases=phases),
               plain=lambda: k1.sparse_conv_probe_plain(
                   feats.float(), rules, w.float(), out_valid,
                   phases=phases),
               check="scale" if full else "exact", nbytes=nbytes,
               flops=flops, rate=(flops, 1e12, "TFLOP/s") if full else None,
               headline=headline, keep=kept, mode=PHASE_NAMES[phases],
               hits=hits, c=feats.shape[2], cout=w.shape[2])
    if full:
        def production():
            return k1.sparse_conv(feats, rules, w, out_valid)

        row["k1_ms"], prod = time_ms(device, production)
        row["equal_k1"] = torch.equal(kept[-1], prod)
        row["ok"] = row["ok"] and row["equal_k1"]
    return row


def phase_split(rows: list) -> None:
    """Annotate the rows of one voxel set's four modes (full, gather only,
    product only, neither): each mode's share of full, the gather's rate in
    bytes of hit rows staged per second, and the product's in useful
    FLOP/s (2 x hits x C x Cout)."""
    full, gather, product, neither = rows
    if full["ms"] is None:
        return
    for r in rows:
        r["share_of_full"] = r["ms"] / full["ms"]
    gather["gather_GBps"] = (full["hits"] * full["c"] * 2
                             / (gather["ms"] * 1e-3) / 1e9)
    product["product_TFLOPs"] = (2 * full["hits"] * full["c"] * full["cout"]
                                 / (product["ms"] * 1e-3) / 1e12)


def fmt(row: dict) -> str:
    """One line for a row."""
    def t(x):
        return "-" if x is None else f"{x:.4f}"

    parts = [f"{row['probe']} {row['case']}:"]
    if row["kernel"] is not None:
        parts.append(f"{row['kernel']} {t(row['ms'])} ms, plain "
                     f"{t(row['plain_ms'])} ms")
    if row.get("op"):
        parts.append(f"{row['op']} {t(row['library_ms'])} ms")
    if "equal_k1" in row:
        parts.append(f"production K1 {t(row['k1_ms'])} ms (equal bit for "
                     f"bit: {row['equal_k1']})")
    if "equal_batch2" in row:
        parts.append(f"equal to batch 2 bit for bit: {row['equal_batch2']}")
    if "share_of_full" in row:
        parts.append(f"{row['share_of_full']:.3f} of full")
    if "gather_GBps" in row:
        parts.append(f"hit rows staged at {row['gather_GBps']:.1f} GB/s")
    if "product_TFLOPs" in row:
        parts.append(f"useful products at {row['product_TFLOPs']:.2f} "
                     "TFLOP/s")
    if "vs_batch2" in row:
        parts.append(f"{row['vs_batch2']:.3f} x the batch-2 launch")
    if row.get("one_matmul_ms") is not None:
        parts.append(f"torch.matmul of one product {t(row['one_matmul_ms'])}"
                     f" ms ({row['one_matmul_tflops']:.3f} TFLOP/s)")
    if row["rate"] is not None:
        parts.append(f"{row['rate']:.3f} {row['rate_unit']}")
    parts.append(f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    if row["max_abs_err"] is not None:
        parts.append(f"{row['check']} max|diff| {row['max_abs_err']:.3g} "
                     f"rel {row['rel_err']:.3g}")
    parts.append("ok" if row["ok"] else "FAILED")
    return " ".join(parts[:1]) + " " + "; ".join(parts[1:])


def main(run: Callable) -> None:
    """A probe's ``main``: the card's name and power limit as
    ``nvidia-smi`` gives them, then the probe at its full size on the card,
    one line per case."""
    device = card()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    rows = run(device, "full")
    for row in rows:
        print(fmt(row), flush=True)
    bad = [r["case"] for r in rows if not r["ok"]]
    if bad:
        raise SystemExit(f"checks failed: {bad}")


def make_level(rng: np.random.RandomState, v: int, c: int, cout: int,
               shape, device):
    """A random CSR voxel set at a level's scale and its submanifold
    rulebook: ``tools/micro_mxu_probe.py:make_level`` with the same numpy
    draws, an absolute rulebook in place of the tile plan. Returns features
    f32 (v, c), rules int32 (27, v), weights f32 (27, c, cout), valid (v,),
    on ``device``."""
    D, H, W = shape
    cols = np.sort(rng.choice(H * W, size=v, replace=True))
    zs = rng.randint(0, D, size=v)
    key = np.unique(cols.astype(np.int64) * D + zs)
    rng.shuffle(key)
    key = np.sort(key[: min(len(key), v)])
    coords = np.stack([key % D, (key // D) // W, (key // D) % W],
                      1).astype(np.int32)
    coords = np.pad(coords, ((0, v - len(key)), (0, 0)))
    valid = np.arange(v) < len(key)
    feats = rng.randn(v, c).astype(np.float32)
    w = (rng.randn(27, c, cout) * 0.1).astype(np.float32)
    coords_t = torch.from_numpy(coords).to(device)
    valid_t = torch.from_numpy(valid).to(device)
    rules = sc.build_subm_rules(sc.build_table_csr(coords_t, valid_t, shape),
                                shape, 3)
    return (torch.from_numpy(feats).to(device), rules,
            torch.from_numpy(w).to(device), valid_t)


def clustered_set(rng: np.random.RandomState, v: int, c: int, shape,
                  device):
    """The clustered voxel set of ``tools/micro_pallas_attr.py:main`` (v/2
    columns, two z draws each), in CSR order as its ``csr_reorder`` leaves
    it, with the same numpy draws. Returns features f32 (v, c), submanifold
    rules int32 (27, v), weights f32 (27, c, c), valid (v,)."""
    D, H, W = shape
    ncol = v // 2
    cols = rng.choice(H * W, size=ncol, replace=False)
    z = rng.randint(0, D, size=(ncol, 2))
    keys = np.unique((np.repeat(cols, 2) * D + z.reshape(-1))
                     .astype(np.int64))
    rng.shuffle(keys)
    keys = keys[:v]
    n = len(keys)
    feats = rng.randn(v, c).astype(np.float32)
    w = (rng.randn(27, c, c) * 0.05).astype(np.float32)
    order = np.argsort(keys)  # CSR: by BEV column, then z
    keys = keys[order]
    f_csr = np.zeros_like(feats)
    f_csr[:n] = feats[order]
    coords = np.stack([keys % D, keys // D // W, (keys // D) % W],
                      -1).astype(np.int32)
    coords = np.pad(coords, ((0, v - n), (0, 0)))
    coords_t = torch.from_numpy(coords).to(device)
    valid_t = torch.from_numpy(np.arange(v) < n).to(device)
    rules = sc.build_subm_rules(sc.build_table_csr(coords_t, valid_t, shape),
                                shape, 3)
    return (torch.from_numpy(f_csr).to(device), rules,
            torch.from_numpy(w).to(device), valid_t)

"""K3's and dW's times on one card, for one checkout of the repo.

    python -m focalformer3d_tpu_torch.tools.kernel_times --root DIR [--tag T]

Imports ``chip_smoke`` and ``focalformer3d_tpu_torch`` from the checkout at
``DIR`` (the repo itself, or an older commit unpacked beside it), so two
versions of the kernels are timed by the same clock, at the same shapes and
on the same inputs as ``chip_smoke.py`` gives them: K3 at the five conv
geometries of engine ``cuda_zrun`` on the radial 200k-point scan (seed 0),
through ``zrun_conv`` with bias; dW at every conv of the training batch
(two radial scans, seed 10, engine ``cuda``) through ``conv_wgrad``. Every
time is ``tools/_common.time_ms`` of this checkout (10 calls replayed from a
CUDA graph: the device's time per call). Prints one line per geometry and
one JSON object with the per-scan and per-step sums.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import sys
from pathlib import Path

import torch


def _import(root: Path):
    sys.path.insert(0, str(root))
    for name in [m for m in sys.modules
                 if m == "chip_smoke" or m.startswith("focalformer3d_tpu_torch")]:
        del sys.modules[name]
    smoke = importlib.import_module("chip_smoke")
    if not Path(smoke.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"chip_smoke came from {smoke.__file__}, not {root}")
    return smoke


def k3_times(smoke, device):
    from focalformer3d_tpu_torch.configs import get_config, with_compute_dtype
    from focalformer3d_tpu_torch.models.detector import preprocess_points
    from focalformer3d_tpu_torch.models.sparse_encoder import conv_index
    from focalformer3d_tpu_torch.ops import sparse_conv_zrun_cuda as k3
    from focalformer3d_tpu_torch.tools import _common

    cfg = get_config("FocalFormer3D_L")["model"]
    cfg = with_compute_dtype(dataclasses.replace(cfg, sparse_engine="cuda"),
                             "bfloat16")
    vox = preprocess_points(cfg, *smoke._scan(cfg, 0, device))
    geoms = smoke._walk(cfg, vox, False, 2)
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    rows, total = {}, 0.0
    for name, g, c, cout, n in smoke._convs(cfg, geoms):
        _, src, dst, ks, st, pad = geoms[g]
        codes = conv_index(src, dst, ks, st, pad, "cuda_zrun")
        feats, w, bias = smoke._rand_conv(gen, device, src.capacity, c,
                                          3 * codes.shape[1], cout)
        ms = _common.time_ms(device, lambda: k3.zrun_conv(
            feats, codes, w, dst.valid, bias))[0]
        rows[name] = ms
        total += n * ms
        print(f"K3 {name}: C {c} -> {cout}, x{n}: {ms:.4f} ms", flush=True)
    return rows, total


def wgrad_times(smoke, device):
    from focalformer3d_tpu_torch.configs import get_config
    from focalformer3d_tpu_torch.models.detector import preprocess_points
    from focalformer3d_tpu_torch.models.sparse_encoder import conv_index
    from focalformer3d_tpu_torch.ops import sparse_conv_cuda as k1
    from focalformer3d_tpu_torch.tools import _common

    cfg = dataclasses.replace(get_config("FocalFormer3D_L")["model"],
                              sparse_engine="cuda")
    batch = smoke._train_batch(cfg, device)
    vox = preprocess_points(cfg, batch["points"], batch["points_mask"],
                            train=True)
    B = vox["coords"].shape[0]
    geoms = smoke._walk(cfg, vox, False, cfg.sparse_dense_from, batch=B)
    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    rows, total = {}, 0.0
    for name, g, c, cout, n in smoke._convs(cfg, geoms):
        _, src, dst, ks, st, pad = geoms[g]
        rules = conv_index(src, dst, ks, st, pad, "cuda")
        x = torch.where(src.valid[..., None], torch.randn(
            B, src.capacity, c, device=device, generator=gen), 0.0)
        cot = torch.where(dst.valid[..., None], torch.randn(
            B, dst.capacity, cout, device=device, generator=gen), 0.0)
        xb = x.to(torch.bfloat16)
        ms = _common.time_ms(device, lambda: k1.conv_wgrad(xb, cot, rules))[0]
        rows[name] = ms
        total += n * ms
        print(f"dW {name}: C {c} -> {cout}, K {rules.shape[1]}, x{n}: "
              f"{ms:.4f} ms", flush=True)
    return rows, total


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, type=Path)
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    root = args.root.resolve()
    smoke = _import(root)
    device = smoke.phase_device()
    torch.set_grad_enabled(False)
    k3_rows, k3_total = k3_times(smoke, device)
    dw_rows, dw_total = wgrad_times(smoke, device)
    print(json.dumps({"tag": args.tag, "root": str(root),
                      "k3_ms_per_scan": k3_total, "k3": k3_rows,
                      "wgrad_ms_per_step": dw_total, "wgrad": dw_rows}),
          flush=True)


if __name__ == "__main__":
    main()

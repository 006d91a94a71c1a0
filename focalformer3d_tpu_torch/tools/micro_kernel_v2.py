"""P4: every sparse conv geometry of one radial scan, on the H100.

The TPU probe (``tools/micro_kernel_v2.py``, ``_kernel_v2``) ran a per-tap
fused variant of the production kernel (v2) beside the production one (v1)
at each submanifold and strided conv of the radial 200k-point
FocalFormer3D_L scan, levels below ``sparse_dense_from``, with its parity
against the exact engine. v1 and v2 compute one function. Here the scan
goes through ``preprocess_points`` and the ``cuda`` engine's index build
(``sparse_encoder.Level``, ``conv_index``); at each geometry K1's probe in
full mode (``ops/sparse_conv_cuda.sparse_conv_probe``) is timed beside
production K1 (equal bit for bit) and held against the plain conv. Features
and weights as the original draws them: normal features at the active
sites, weights 0.1 x normal, from a seeded ``torch.Generator``.

    python -m focalformer3d_tpu_torch.tools.micro_kernel_v2
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs import get_config
from ..data import synthetic
from ..models.detector import preprocess_points
from ..models.sparse_encoder import Level, conv_index
from . import _common

FULL = ("FocalFormer3D_L", 200_000, 24, 32)  # config, points, boxes, max_gts
SMALL = ("Tiny_L", 3000, 6, 8)


def geometries(device: torch.device, size: str = "full"):
    """Yields (name, features bf16 (1, V_in, C), rules (1, 27, V_out),
    weights bf16 (27, C, Cout), out_valid (1, V_out)) for every conv the
    probe runs, in order."""
    name, n_points, n_boxes, max_gts = FULL if size == "full" else SMALL
    cfg = get_config(name)["model"]
    batch = synthetic.make_batch(
        np.random.RandomState(0), batch_size=1, n_points=n_points,
        n_boxes=n_boxes, max_gts=max_gts,
        num_classes=cfg.decoder.num_classes,
        pc_range=cfg.voxel.point_cloud_range, mode="radial")
    vox = preprocess_points(cfg, torch.from_numpy(batch["points"]).to(device),
                            torch.from_numpy(batch["points_mask"]).to(device))
    lvl = Level.from_voxels(vox["coords"], vox["voxel_mask"],
                            tuple(cfg.sparse_shape), False)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    ch = cfg.encoder_channels

    def weights(c, cout):
        return (0.1 * torch.randn(27, c, cout, generator=gen, device=device)
                ).to(torch.bfloat16)

    for level in range(cfg.sparse_dense_from):
        c = ch[level][0]
        x = torch.where(lvl.valid[..., None], torch.randn(
            1, lvl.capacity, c, generator=gen, device=device), 0.0).to(
                torch.bfloat16)
        yield (f"L{level} subm {c}->{c}, V={lvl.capacity}", x,
               conv_index(lvl, lvl, 3, 1, 1, "cuda"), weights(c, c),
               lvl.valid)
        pad = cfg.down_paddings[level]
        nxt = lvl.downsample(3, 2, pad, cfg.capacities[level + 1])
        cout = ch[level][-1]
        yield (f"L{level} down {c}->{cout}, V={lvl.capacity} -> "
               f"{nxt.capacity}", x, conv_index(lvl, nxt, 3, 2, pad, "cuda"),
               weights(c, cout), nxt.valid)
        lvl = nxt


def run(device: torch.device, size: str = "full") -> list:
    return [_common.conv_case(device, "P4", *geom)
            for geom in geometries(device, size)]


def main():
    _common.main(run)


if __name__ == "__main__":
    main()

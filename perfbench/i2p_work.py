"""The least time of the camera projection's work, counted from its shapes.

The layer is ``FocalEncoder.shared_conv_img`` (a 3x3 conv taking every
camera's FPN level 0 from ``c_img`` to ``c`` channels) and the first fusion
layer's ``I2P_block`` (a ``z`` x ``h`` x ``w`` grid of cell centres
projected into every camera, sampled bilinearly, and a one-head attention
per BEV cell over its ``z`` samples), both in float32 with TF32 off:

- operations: the products alone, as ``FlopCounterMode`` counts them (two
  per multiply-add): the 3x3 conv, the q / k / v / out projections, the
  attention's two contractions (logits and the weighted sum) and the
  grid's projection (``bev_aug``'s inverse, ``lidar2img`` and ``img_aug``
  on every point, in float64, as the pool's samples carry both
  augmentations; 0.1% of the whole, counted at the float32 peak). The
  sampling and the softmax are not products;
- bytes: each input and output of the layer once, four bytes an element:
  the FPN maps, the LiDAR map, the camera matrices, the weights and the
  camera BEV it returns.

``seconds_at_peak`` is the larger of the operations at the float32 peak
and the bytes at HBM's rate (``peaks.json``): the least time the chip
could take for the layer. ``PUBLISHED`` are FocalFormer3D_LC_Proj's shapes
(six 112 x 200 x 256 maps, a 10 x 180 x 180 grid, width 128).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

PEAKS = json.loads((Path(__file__).parent / "peaks.json").read_text())
PUBLISHED = dict(cams=6, fh=112, fw=200, c_img=256, c=128, z=10, h=180,
                 w=180)
F32 = 4


def count(cams: int, fh: int, fw: int, c_img: int, c: int, z: int, h: int,
          w: int) -> Dict[str, float]:
    """Operations and least bytes of the layer for one sample."""
    conv = 2.0 * cams * fh * fw * c * c_img * 9
    cells = h * w
    samples = z * cells
    proj = 2.0 * c * c * (cells + 2 * samples + cells)  # q, k, v, out
    attn = 2.0 * 2 * samples * c  # logits, weighted sum
    grid = 2.0 * samples * (3 * 3 + cams * 4 * 4 + cams * 3 * 3)
    weights = (c * c_img * 9 + c) + (4 * c * c + 4 * c)
    elements = (cams * fh * fw * c_img + cells * c + cams * 16 + weights
                + cells * c)
    return {"flops": conv + proj + attn + grid,
            "bytes": float(F32 * elements)}


def seconds_at_peak(device_name: str) -> float:
    """The layer's least time at the published shapes on the named card;
    KeyError for a card that ``peaks.json`` lacks."""
    pk = PEAKS[device_name]
    n = count(**PUBLISHED)
    return max(n["flops"] / pk["float32"], n["bytes"] / pk["hbm_bytes_per_s"])

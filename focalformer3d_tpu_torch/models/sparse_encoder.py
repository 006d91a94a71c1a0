"""VoxelNet sparse middle encoder (mmdet3d SparseEncoder, basicblock), eval.

Port of the eval forward of ``focalformer3d_tpu/models/sparse_encoder.py``
(the exact ``voxel`` path and ``_dense_tail``):

    conv_input: SubM(in -> c0) + BN + ReLU
    stage s:    SparseBasicBlocks, then a strided SparseConv (s2) + BN + ReLU
    conv_out:   SparseConv(k(3,1,1), s(2,1,1)) + BN + ReLU
    -> BEV (B, H, W, C * D_out), channel = c * D_out + d (mmdet3d .view)

Levels below ``dense_from`` are sparse: CSR rulebooks from
``ops/sparse_conv.py`` and the sparse-conv apply, with batch norm folded into
the conv weights (``w * g`` in float32, then bias ``b``). Levels from
``dense_from`` on run as dense 3D convs on the zero-filled grid, re-masked
to the active set after every conv (strided sets by a max-pool of the
mask), which is the same function.

Engines: ``cuda`` runs the sparse levels through the K1 kernel
(``ops/sparse_conv_cuda.sparse_conv``: bf16 operands, f32 accumulation) and
casts the dense tail to bfloat16, as the JAX ``pallas`` engine does;
``plain`` runs them as float32 gather + matmul and keeps the dense tail in
the input dtype, as the JAX ``voxel`` engine does. With absolute rulebooks
there are no tile windows, so the JAX engine's spill lists, its checked
reroute to the exact path and its ``diagnostics`` overflow counters have
nothing to guard here.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import sparse_conv as sc
from ..ops.sparse_conv_cuda import apply_conv_plain, sparse_conv
from .layers import bn_affine

ENGINES = ("auto", "plain", "cuda")


class SpConvWeight(nn.Module):
    """spconv weight holder, reference layout (kz, ky, kx, I, O)."""

    def __init__(self, ks: Tuple[int, int, int], cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(*ks, cin, cout))

    def folded(self, bn) -> Tuple[torch.Tensor, torch.Tensor]:
        """(K, I, O) dz-major weight with the eval BN folded in, and bias."""
        g, b = bn_affine(bn)
        w = self.weight.reshape(-1, *self.weight.shape[-2:])
        return w * g, b


def _conv_module(ks, cin, cout) -> nn.ModuleList:
    """mmdet3d SparseConvModule: ``.0`` conv weight, ``.1`` BN (eps 1e-3)."""
    return nn.ModuleList([SpConvWeight(ks, cin, cout),
                          nn.BatchNorm1d(cout, eps=1e-3)])


class SparseBasicBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv1 = SpConvWeight((3, 3, 3), c, c)
        self.bn1 = nn.BatchNorm1d(c, eps=1e-3)
        self.conv2 = SpConvWeight((3, 3, 3), c, c)
        self.bn2 = nn.BatchNorm1d(c, eps=1e-3)


def _pool_mask(mask, kernel, stride, padding):
    """Active set of a strided conv on a dense grid: any-tap-hit."""
    m = F.max_pool3d(mask[:, None].float(), kernel, stride, padding)
    return m[:, 0] > 0


def _dense_conv(x, w27, ks, stride, padding, gain, bias):
    """3D conv of (B, D, H, W, C) with the sparse weight layout, the eval BN
    folded in as in the JAX ``_dense_conv``."""
    cin, cout = w27.shape[-2:]
    w = (w27.reshape(*ks, cin, cout) * gain).permute(4, 3, 0, 1, 2)
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w.to(x.dtype), None, stride,
                 padding)
    y = y.permute(0, 2, 3, 4, 1)
    return (y.float() + bias).to(x.dtype)


class SparseEncoder(nn.Module):
    def __init__(self, in_channels: int = 5,
                 sparse_shape: Sequence[int] = (41, 1440, 1440),
                 output_channels: int = 128,
                 encoder_channels: Sequence[Sequence[int]] = (
                     (16, 16, 32), (32, 32, 64), (64, 64, 128), (128, 128)),
                 down_paddings: Sequence[Sequence[int]] = (
                     (1, 1, 1), (1, 1, 1), (0, 1, 1)),
                 capacities: Sequence[int] = (120000, 90000, 60000, 40000),
                 out_capacity: int = 40000,
                 engine: str = "auto",
                 dense_from: int = 4):
        super().__init__()
        if engine not in ENGINES:
            raise ValueError(f"engine {engine!r} not in {ENGINES}")
        self.sparse_shape = tuple(sparse_shape)
        self.encoder_channels = tuple(tuple(b) for b in encoder_channels)
        self.down_paddings = tuple(tuple(p) for p in down_paddings)
        self.capacities = tuple(capacities)
        self.out_capacity = out_capacity
        self.engine = engine
        self.dense_from = dense_from

        base = self.encoder_channels[0][0]
        self.conv_input = _conv_module((3, 3, 3), in_channels, base)
        self.encoder_layers = nn.Module()
        n_stage = len(self.encoder_channels)
        c = base
        for s, blocks in enumerate(self.encoder_channels):
            mods = []
            for j, out in enumerate(blocks):
                if j == len(blocks) - 1 and s != n_stage - 1:
                    mods.append(_conv_module((3, 3, 3), c, out))
                else:
                    mods.append(SparseBasicBlock(out))
                c = out
            self.encoder_layers.add_module(f"encoder_layer{s + 1}",
                                           nn.ModuleList(mods))
        self.conv_out = _conv_module((3, 1, 1), c, output_channels)

    def _stage(self, s: int) -> nn.ModuleList:
        return getattr(self.encoder_layers, f"encoder_layer{s + 1}")

    # ------------------------------------------------------------------
    def _engine(self, device) -> str:
        if self.engine == "auto":
            return "cuda" if device.type == "cuda" else "plain"
        return self.engine

    def _sparse_conv(self, x, rules, wmod, bn, valid, engine):
        w, b = wmod.folded(bn)
        if engine == "cuda":
            return sparse_conv(x.to(torch.bfloat16), rules,
                               w.to(torch.bfloat16), valid, b)
        return apply_conv_plain(x, rules, w, valid, b, x.dtype)

    def _basic(self, blk, x, rules, valid, engine):
        m = valid[..., None]
        y = F.relu(self._sparse_conv(x, rules, blk.conv1, blk.bn1, valid,
                                     engine))
        y = self._sparse_conv(y, rules, blk.conv2, blk.bn2, valid, engine)
        return torch.where(m, F.relu(y + x), 0.0)

    def forward(self, features, coords, valid):
        """features (B, V0, Cin), coords (B, V0, 3) int32 zyx in CSR order,
        valid (B, V0). Returns BEV features (B, H', W', C_out * D_out)."""
        engine = self._engine(features.device)
        shape = self.sparse_shape
        n_stage = len(self.encoder_channels)
        B = features.shape[0]
        x = torch.where(valid[..., None], features, 0.0)
        tables = [sc.build_table_csr(coords[b], valid[b], shape)
                  for b in range(B)]

        def subm_rules(tabs, shp):
            return torch.stack([sc.build_subm_rules(t, shp, 3)
                                for t in tabs])

        rules = subm_rules(tables, shape)
        x = F.relu(self._sparse_conv(x, rules, self.conv_input[0],
                                     self.conv_input[1], valid, engine))
        for i, blocks in enumerate(self.encoder_channels):
            stage = self._stage(i)
            last = i == n_stage - 1
            n_basic = len(blocks) - 1 if not last else len(blocks)
            for j in range(n_basic):
                x = self._basic(stage[j], x, rules, valid, engine)
            if last:
                break
            pad = self.down_paddings[i]
            down = [sc.build_downsample(coords[b], valid[b], shape, 3, 2, pad,
                                        self.capacities[i + 1])
                    for b in range(B)]
            out_shape = down[0][2]
            d_rules = torch.stack([
                sc.build_conv_rules(tables[b], shape, down[b][0], down[b][1],
                                    3, 2, pad)
                for b in range(B)])
            coords = torch.stack([d[0] for d in down])
            valid = torch.stack([d[1] for d in down])
            x = F.relu(self._sparse_conv(x, d_rules, stage[-1][0],
                                         stage[-1][1], valid, engine))
            shape = out_shape
            if i + 1 == self.dense_from:
                dense = torch.stack([sc.to_dense(x[b], coords[b], valid[b],
                                                 shape) for b in range(B)])
                mask = torch.stack([
                    sc.to_dense(valid.new_ones((valid.shape[1], 1),
                                               dtype=torch.float32),
                                coords[b], valid[b], shape)[..., 0] > 0
                    for b in range(B)])
                return self._dense_tail(dense, mask, i + 1, engine)
            tables = [sc.table_from_meta(coords[b], valid[b], down[b][4])
                      for b in range(B)]
            rules = subm_rules(tables, shape)

        ks_out, st_out = (3, 1, 1), (2, 1, 1)
        down = [sc.build_downsample(coords[b], valid[b], shape, ks_out,
                                    st_out, 0, self.out_capacity)
                for b in range(B)]
        out_shape = down[0][2]
        o_rules = torch.stack([
            sc.build_conv_rules(tables[b], shape, down[b][0], down[b][1],
                                ks_out, st_out, 0)
            for b in range(B)])
        coords = torch.stack([d[0] for d in down])
        valid = torch.stack([d[1] for d in down])
        x = F.relu(self._sparse_conv(x, o_rules, self.conv_out[0],
                                     self.conv_out[1], valid, engine))
        dense = torch.stack([sc.to_dense(x[b], coords[b], valid[b],
                                         out_shape) for b in range(B)])
        return self._collapse(dense)

    @staticmethod
    def _collapse(dense):
        """(B, D, H, W, C) -> (B, H, W, C * D), channel = c * D + d."""
        B, D, H, W, C = dense.shape
        return dense.permute(0, 2, 3, 4, 1).reshape(B, H, W, C * D)

    def _dense_conv_bn(self, x, mask, wmod, bn, ks, stride, padding, act):
        g, b = bn_affine(bn)
        y = _dense_conv(x, wmod.weight, ks, stride, padding, g, b)
        y = torch.where(mask[..., None], y, 0.0)
        return F.relu(y) if act else y

    def _dense_tail(self, x, mask, start: int, engine: str):
        """Levels >= ``start`` and conv_out on the dense grid. x (B, D, H, W,
        C) is zero at inactive cells; mask (B, D, H, W)."""
        in_dtype = x.dtype
        if engine == "cuda":
            x = x.to(torch.bfloat16)
        n_stage = len(self.encoder_channels)
        k3 = (3, 3, 3)
        for i in range(start, n_stage):
            blocks = self.encoder_channels[i]
            stage = self._stage(i)
            last = i == n_stage - 1
            n_basic = len(blocks) - 1 if not last else len(blocks)
            for j in range(n_basic):
                blk = stage[j]
                y = self._dense_conv_bn(x, mask, blk.conv1, blk.bn1, k3, 1,
                                        1, True)
                y = self._dense_conv_bn(y, mask, blk.conv2, blk.bn2, k3, 1,
                                        1, False)
                x = torch.where(mask[..., None], F.relu(y + x), 0.0)
            if not last:
                pad = self.down_paddings[i]
                mask = _pool_mask(mask, k3, 2, pad)
                x = self._dense_conv_bn(x, mask, stage[-1][0], stage[-1][1],
                                        k3, 2, pad, True)
        mask = _pool_mask(mask, (3, 1, 1), (2, 1, 1), 0)
        x = self._dense_conv_bn(x, mask, self.conv_out[0], self.conv_out[1],
                                (3, 1, 1), (2, 1, 1), 0, True)
        return self._collapse(x).to(in_dtype)

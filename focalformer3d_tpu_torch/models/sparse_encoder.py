"""VoxelNet sparse middle encoder (mmdet3d SparseEncoder, basicblock).

Port of ``focalformer3d_tpu/models/sparse_encoder.py`` (the exact ``voxel``
path, the ``pallas`` engines and ``_dense_tail``):

    conv_input: SubM(in -> c0) + BN + ReLU
    stage s:    SparseBasicBlocks, then a strided SparseConv (s2) + BN + ReLU
    conv_out:   SparseConv(k(3,1,1), s(2,1,1)) + BN + ReLU
    -> BEV (B, H, W, C * D_out), channel = c * D_out + d (mmdet3d .view)

Levels below the dense boundary are sparse: CSR rulebooks from
``ops/sparse_conv.py`` and the sparse-conv apply. Levels from it on run as
dense 3D convs on the zero-filled grid, re-masked to the active set after
every conv (strided sets by a max-pool of the mask), which is the same
function. The module's ``training`` flag picks the mode, as the JAX
``train`` argument does:

- eval: boundary ``dense_from`` (the config's ``sparse_dense_from_eval``),
  batch norm folded into the conv weights (``w * g`` in float32, then bias
  ``b``);
- training: boundary ``train_dense_from`` (``sparse_dense_from``), conv
  without bias, then ``MaskedBatchNorm`` with batch statistics over the
  active sites (``layers.apply_bn``); the dense tail runs in float32. On
  ``plain`` autograd runs through the float32 gather + matmul; on the
  kernel engines each sparse conv is differentiable on the kernels, as
  the JAX ``pallas`` engines' custom VJPs are:

  - ``cuda`` and ``cuda_mxu``: ``sparse_conv_cuda.sparse_conv_train`` (K1
    forward, K1 on the transposed rulebook for dx, the dW kernel on the
    rulebook). ``cuda_mxu``'s rulebooks are K2's; a strided conv's
    transpose is ``sparse_conv.transpose_rules`` of K2's rulebook (JAX
    decodes it and transposes, ``sparse_encoder.py:513-526``); a
    submanifold rulebook is its own transpose.
  - ``cuda_zrun``: ``sparse_conv_zrun_cuda.zrun_conv_train`` (K3 forward;
    K1's dx and dW on ``zrun_rules`` of the codes, built once per level
    beside them, and its transpose).

  ``cuda`` and ``cuda_zrun`` keep the training dense boundary;
  ``cuda_mxu`` is all-sparse in training too (JAX ``_mxu_forward``), so it
  runs K1 forward, dx and dW at L3 and conv_out as well.

Engines (the JAX engine each mirrors in parentheses):

- ``plain`` (``voxel``): float32 gather + matmul, the dense tail in the input
  dtype.
- ``cuda`` (``pallas``): the torch-op index build (``build_table_csr``,
  ``build_downsample``, ``build_conv_rules``, and ``transpose_rules`` for
  the strided convs' dx in training) and every sparse conv on K1
  (``ops/sparse_conv_cuda``: bf16 operands, f32 accumulation); the dense
  tail's input rounded to bfloat16 (computed in bfloat16 at eval).
- ``cuda_zrun`` (``pallas_zrun``): the same index build, but one z-run plan
  per conv (``ops/sparse_conv_zrun.build_zplan``) in place of its rulebook,
  and every sparse conv on K3 (``ops/sparse_conv_zrun_cuda.zrun_conv``); the
  dense tail in bfloat16.
- ``cuda_mxu`` (``pallas_mxu``): the meta chain. Each level is known by its
  column meta and packed sites (``downsample_meta``, ``colz_from_meta``), every
  rulebook comes from K2 (``ops/plan_builder_cuda.plan_rules``) and every conv
  runs on K1. Like the JAX engine it is all-sparse: L2, L3 and conv_out run
  sparse and ``dense_from`` is not read. Also like it, a level's meta keeps
  the voxels its capacity dropped, so on a scan that overflows a capacity
  the next level's active set parts from the coordinate engines'.

``auto`` is ``cuda`` for tensors on a card and ``plain`` on the CPU; the other
engines are chosen explicitly. On CPU tensors the kernel wrappers run their
plain versions. With absolute rulebooks there are no tile windows, so the JAX
engines' spill lists, checked reroute to the exact path and ``diagnostics``
overflow counters have nothing to guard here.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import plan_builder as pb
from ..ops import sparse_conv as sc
from ..ops.plan_builder_cuda import plan_rules
from ..ops.sparse_conv_cuda import (apply_conv_plain, sparse_conv,
                                    sparse_conv_train)
from ..ops.sparse_conv_zrun import build_zplan, zrun_rules
from ..ops.sparse_conv_zrun_cuda import zrun_conv, zrun_conv_train
from ..utils.profiler import span
from .layers import apply_bn, bn_affine

ENGINES = ("auto", "plain", "cuda", "cuda_mxu", "cuda_zrun")


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


def _sparse_bn(c: int) -> nn.BatchNorm1d:
    """``MaskedBatchNorm``: eps 1e-3, running decay 0.99 (momentum 0.01)."""
    return nn.BatchNorm1d(c, eps=1e-3, momentum=0.01)


def _conv_module(ks, cin, cout) -> nn.ModuleList:
    """mmdet3d SparseConvModule: ``.0`` conv weight, ``.1`` BN (eps 1e-3)."""
    return nn.ModuleList([SpConvWeight(ks, cin, cout), _sparse_bn(cout)])


class SparseBasicBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv1 = SpConvWeight((3, 3, 3), c, c)
        self.bn1 = _sparse_bn(c)
        self.conv2 = SpConvWeight((3, 3, 3), c, c)
        self.bn2 = _sparse_bn(c)


def _pool_mask(mask, kernel, stride, padding):
    """Active set of a strided conv on a dense grid: any-tap-hit."""
    m = F.max_pool3d(mask[:, None].float(), kernel, stride, padding)
    return m[:, 0] > 0


def _dense_conv(x, w27, ks, stride, padding, gain=None, bias=None):
    """3D conv of (B, D, H, W, C) with the sparse weight layout, the eval BN
    (``gain``, ``bias``) folded in as in the JAX ``_dense_conv``."""
    cin, cout = w27.shape[-2:]
    w = w27.reshape(*ks, cin, cout)
    if gain is not None:
        w = w * gain
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2)
                 .to(x.dtype), None, stride, padding)
    y = y.permute(0, 2, 3, 4, 1)
    if bias is None:
        return y
    return (y.float() + bias).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class Level:
    """The voxel sets of one resolution level, batched and CSR-ordered:
    valid (B, V), column metas (B, H*W + 1, 4), and the sites as coords
    (B, V, 3) zyx or, on the meta chain, as packed colz (B, V)."""

    shape: Tuple[int, int, int]
    valid: torch.Tensor
    meta: torch.Tensor
    coords: Optional[torch.Tensor] = None
    colz: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.valid.shape[1]

    def sites(self) -> torch.Tensor:
        if self.coords is None:
            return pb.coords_from_colz(self.colz, self.shape[2])
        return self.coords

    @staticmethod
    def from_voxels(coords, valid, shape, meta_chain: bool) -> "Level":
        meta = torch.stack([sc.build_table_csr(coords[b], valid[b],
                                               shape).meta
                            for b in range(valid.shape[0])])
        if meta_chain:
            return Level(shape, valid, meta,
                         colz=pb.colz_from_coords(coords, valid, shape[2]))
        return Level(shape, valid, meta, coords=coords)

    def downsample(self, ks, stride, pad, capacity: int) -> "Level":
        """The active output set of a strided conv: from the coordinate
        lists (``build_downsample``) or, on the meta chain, from the metas
        alone (``downsample_meta`` + ``colz_from_meta``, whose ``d`` is the
        input level's depth, as the JAX engine calls it)."""
        B = self.valid.shape[0]
        if self.coords is None:
            outs = [sc.downsample_meta(self.meta[b], self.shape, ks, stride,
                                       pad) for b in range(B)]
            total = torch.stack([o[2] for o in outs])
            valid = (torch.arange(capacity, device=total.device)[None]
                     < torch.clamp(total, max=capacity)[:, None])
            colz = torch.stack([pb.colz_from_meta(o[0], capacity,
                                                  d=self.shape[0])
                                for o in outs])
            return Level(outs[0][1], valid,
                         torch.stack([o[0] for o in outs]), colz=colz)
        outs = [sc.build_downsample(self.coords[b], self.valid[b], self.shape,
                                    ks, stride, pad, capacity)
                for b in range(B)]
        return Level(outs[0][2], torch.stack([o[1] for o in outs]),
                     torch.stack([o[4] for o in outs]),
                     coords=torch.stack([o[0] for o in outs]))


def backward_index(index: torch.Tensor, in_capacity: int, engine: str,
                   strided: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """What a training conv's backward reads on a kernel engine: the
    rulebook (B, K, V_out) of its dW, the rulebook ``index`` itself or, on
    ``cuda_zrun``, the one its codes encode (``zrun_rules``), and the
    transposed rulebook (B, K, V_in) of its dx, that rulebook where the
    conv is submanifold (its own transpose), else ``transpose_rules``."""
    rules = zrun_rules(index, in_capacity) if engine == "cuda_zrun" \
        else index
    if not strided:
        return rules, rules
    return rules, torch.stack([sc.transpose_rules(r, in_capacity)
                               for r in rules])


def conv_index(src: Level, dst: Level, ks, stride, pad, engine: str):
    """What the sparse conv from ``src`` to ``dst`` reads on ``engine``: the
    rulebook (B, K, V_out), from K2 on the meta chain, or the z-run plan
    (B, ky*kx, V_out) on ``cuda_zrun``."""
    if engine == "cuda_mxu":
        return plan_rules(src.meta, dst.colz, src.capacity, ks, stride, pad,
                          src.shape, dst.shape[2])
    build = build_zplan if engine == "cuda_zrun" else sc.build_conv_rules
    return torch.stack([
        build(sc.VoxelTable(src.coords[b], src.valid[b], src.meta[b]),
              src.shape, dst.coords[b], dst.valid[b], ks, stride, pad)
        for b in range(src.valid.shape[0])])


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
                 dense_from: int = 4,
                 train_dense_from: Optional[int] = None):
        super().__init__()
        if engine == "pillar":
            raise NotImplementedError(
                "engine 'pillar' (the JAX package's ops/pillar_conv.py, a "
                "TPU layout of engine 'voxel''s function) has no counterpart "
                "by design: use 'plain' or a kernel engine (ROADMAP.md, "
                "Queue 1, 'Without a counterpart, by design')")
        if engine not in ENGINES:
            raise ValueError(f"engine {engine!r} not in {ENGINES}")
        self.sparse_shape = tuple(sparse_shape)
        self.encoder_channels = tuple(tuple(b) for b in encoder_channels)
        self.down_paddings = tuple(tuple(p) for p in down_paddings)
        self.capacities = tuple(capacities)
        self.out_capacity = out_capacity
        self.engine = engine
        self.dense_from = dense_from
        self.train_dense_from = (dense_from if train_dense_from is None
                                 else train_dense_from)

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
        engine = self.engine
        if engine == "auto":
            engine = "cuda" if device.type == "cuda" else "plain"
        return engine

    def _sparse_conv(self, x, index, wmod, bn, valid, engine, bwd=None):
        """One sparse conv + BN: folded at eval; at training conv, batch
        norm over the active sites, re-mask. ``bwd`` is what a kernel
        engine's backward reads (``backward_index``)."""
        if not self.training:
            w, b = wmod.folded(bn)
            if engine == "plain":
                return apply_conv_plain(x, index, w, valid, b, x.dtype)
            conv = zrun_conv if engine == "cuda_zrun" else sparse_conv
            return conv(x.to(torch.bfloat16), index, w.to(torch.bfloat16),
                        valid, b)
        w = wmod.weight.reshape(-1, *wmod.weight.shape[-2:])
        if engine == "plain":
            y = apply_conv_plain(x, index, w, valid, None, x.dtype)
        elif engine == "cuda_zrun":
            y = zrun_conv_train(x, index, *bwd, w, valid)
        else:
            y = sparse_conv_train(x, index, bwd[1], w, valid)
        return torch.where(valid[..., None], apply_bn(y, bn, valid), 0.0)

    def _basic(self, blk, x, index, valid, engine, bwd):
        m = valid[..., None]
        y = F.relu(self._sparse_conv(x, index, blk.conv1, blk.bn1, valid,
                                     engine, bwd))
        y = self._sparse_conv(y, index, blk.conv2, blk.bn2, valid, engine,
                              bwd)
        return torch.where(m, F.relu(y + x), 0.0)

    def forward(self, features, coords, valid,
                mark: Optional[Callable[[str], None]] = None,
                levels: Optional[List[Level]] = None):
        """features (B, V0, Cin), coords (B, V0, 3) int32 zyx in CSR order,
        valid (B, V0). Returns BEV features (B, H', W', C_out * D_out).

        ``mark(stage)``, if given, is called as each stage ends: "index
        build" after each level's active set and rulebook (or plan), "sparse
        convs" after the convs that read them, "dense tail" after the dense
        levels. Each stage runs in a ``utils/profiler`` span named by the
        level it builds or writes: "index build/L<k>" and "sparse
        convs/L<k>" (a strided conv's level holds two of each, its
        downsample's and its own), conv_out's level ``len(
        encoder_channels)``, and "dense tail". ``levels``, if given,
        receives each sparse level built."""
        record = levels.append if levels is not None else (lambda _: None)
        engine = self._engine(features.device)
        meta_chain = engine == "cuda_mxu"
        dense_from = (self.train_dense_from if self.training
                      else self.dense_from)
        want_bwd = self.training and engine != "plain"

        def index_of(src, dst, ks, stride, pad):
            """The conv's index and what its backward reads."""
            index = conv_index(src, dst, ks, stride, pad, engine)
            bwd = (backward_index(index, src.capacity, engine, stride != 1)
                   if want_bwd else None)
            return index, bwd

        n_stage = len(self.encoder_channels)
        B = features.shape[0]
        with span("index build/L0", mark):
            x = torch.where(valid[..., None], features, 0.0)
            lvl = Level.from_voxels(coords, valid, self.sparse_shape,
                                    meta_chain)
            record(lvl)
            index, bwd = index_of(lvl, lvl, 3, 1, 1)
        for i, blocks in enumerate(self.encoder_channels):
            stage = self._stage(i)
            last = i == n_stage - 1
            n_basic = len(blocks) - 1 if not last else len(blocks)
            with span(f"sparse convs/L{i}", mark):
                if i == 0:
                    x = F.relu(self._sparse_conv(
                        x, index, self.conv_input[0], self.conv_input[1],
                        lvl.valid, engine, bwd))
                for j in range(n_basic):
                    x = self._basic(stage[j], x, index, lvl.valid, engine,
                                    bwd)
            if last:
                break
            pad = self.down_paddings[i]
            with span(f"index build/L{i + 1}", mark):
                out = lvl.downsample(3, 2, pad, self.capacities[i + 1])
                record(out)
                index, bwd = index_of(lvl, out, 3, 2, pad)
            with span(f"sparse convs/L{i + 1}", mark):
                x = F.relu(self._sparse_conv(
                    x, index, stage[-1][0], stage[-1][1], out.valid, engine,
                    bwd))
            lvl = out
            if not meta_chain and i + 1 == dense_from:
                with span("dense tail", mark):
                    sites = lvl.sites()
                    dense = torch.stack([
                        sc.to_dense(x[b], sites[b], lvl.valid[b], lvl.shape)
                        for b in range(B)])
                    ones = lvl.valid.new_ones((lvl.capacity, 1),
                                              dtype=torch.float32)
                    mask = torch.stack([
                        sc.to_dense(ones, sites[b], lvl.valid[b],
                                    lvl.shape)[..., 0] > 0 for b in range(B)])
                    return self._dense_tail(dense, mask, i + 1, engine)
            with span(f"index build/L{i + 1}", mark):
                index, bwd = index_of(lvl, lvl, 3, 1, 1)

        ks_out, st_out = (3, 1, 1), (2, 1, 1)
        with span(f"index build/L{n_stage}", mark):
            out = lvl.downsample(ks_out, st_out, 0, self.out_capacity)
            record(out)
            index, bwd = index_of(lvl, out, ks_out, st_out, 0)
        with span(f"sparse convs/L{n_stage}", mark):
            x = F.relu(self._sparse_conv(
                x, index, self.conv_out[0], self.conv_out[1], out.valid,
                engine, bwd))
            sites = out.sites()
            dense = torch.stack([sc.to_dense(x[b], sites[b], out.valid[b],
                                             out.shape) for b in range(B)])
            return self._collapse(dense)

    @staticmethod
    def _collapse(dense):
        """(B, D, H, W, C) -> (B, H, W, C * D), channel = c * D + d."""
        B, D, H, W, C = dense.shape
        return dense.permute(0, 2, 3, 4, 1).reshape(B, H, W, C * D)

    def _dense_conv_bn(self, x, mask, wmod, bn, ks, stride, padding, act):
        if self.training:  # float32, batch statistics over the active cells
            y = _dense_conv(x.float(), wmod.weight, ks, stride, padding)
            y = apply_bn(y, bn, mask)
        else:
            g, b = bn_affine(bn)
            y = _dense_conv(x, wmod.weight, ks, stride, padding, g, b)
        y = torch.where(mask[..., None], y, 0.0)
        return F.relu(y) if act else y

    def _dense_tail(self, x, mask, start: int, engine: str):
        """Levels >= ``start`` and conv_out on the dense grid. x (B, D, H, W,
        C) is zero at inactive cells; mask (B, D, H, W). The kernel engines
        round the tail's input to bfloat16, as the JAX ``pallas`` engines
        do (its convs then compute in float32 in training)."""
        in_dtype = x.dtype
        if engine != "plain":
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

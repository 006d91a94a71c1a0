"""VoxelNet sparse middle encoder (mmdet3d SparseEncoder, basicblock),
plain engine only: a frozen copy of the port's ``plain`` path.

    conv_input: SubM(in -> c0) + BN + ReLU
    stage s:    SparseBasicBlocks, then a strided SparseConv (s2) + BN + ReLU
    conv_out:   SparseConv(k(3,1,1), s(2,1,1)) + BN + ReLU
    -> BEV (B, H, W, C * D_out), channel = c * D_out + d (mmdet3d .view)

Levels below the dense boundary are sparse: CSR rulebooks from
``ops/sparse_conv.py`` and a float32 gather + matmul. Levels from it on run
as dense 3D convs on the zero-filled grid, re-masked to the active set
after every conv (strided sets by a max-pool of the mask), which is the
same function. Eval folds batch norm into the conv weights; training runs
the conv without bias, then batch norm over the active sites.

``WORK``, when a list, receives one ``(kind, active pairs, taps, cin,
cout, in rows, out rows)`` per conv, kind "sparse" or "dense": the sparse
convs from their rulebooks, the dense levels from their masks, so the
count is the sparse model's whatever boundary the dense tail starts at.
While it is set, the convs' own products are hidden from any counting
mode (``torch.utils.flop_counter``), which would count the padded gather
and the empty cells.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils._python_dispatch import _disable_current_modes

from ..ops import sparse_conv as sc
from .layers import apply_bn, bn_affine

# set to a list to record each conv's work (see the module's docstring)
WORK: Optional[list] = None


def apply_conv_plain(features: torch.Tensor, rules: torch.Tensor,
                     weights: torch.Tensor, out_valid: torch.Tensor,
                     bias: Optional[torch.Tensor] = None,
                     compute_dtype: torch.dtype = torch.float32
                     ) -> torch.Tensor:
    """Gather + matmul, batched. features (B, V_in, C); rules (B, K, V_out)
    with V_in as the miss sentinel; weights (K, C, Cout); out_valid (B,
    V_out)."""
    B, V_in, C = features.shape
    K, _, C_out = weights.shape
    V_out = rules.shape[2]
    if WORK is not None:
        hits = ((rules < V_in) & out_valid[:, None]).sum()
        WORK.append(("sparse", hits, K, C, C_out, _rows(rules, V_in),
                     out_valid.sum()))
    fpad = torch.cat([features, features.new_zeros((B, 1, C))], dim=1)
    idx = rules.transpose(1, 2).reshape(B, V_out * K).long()
    g = torch.gather(fpad, 1, idx[..., None].expand(-1, -1, C))
    g = g.reshape(B, V_out, K * C).to(compute_dtype)
    with _uncounted():
        acc = g @ weights.reshape(K * C, C_out).to(compute_dtype)
    if bias is not None:
        acc = acc + bias.to(compute_dtype)
    return torch.where(out_valid[..., None], acc, 0.0)


def _uncounted():
    return (_disable_current_modes() if WORK is not None
            else contextlib.nullcontext())


def _rows(rules: torch.Tensor, v_in: int) -> torch.Tensor:
    """Distinct input rows a rulebook reads."""
    seen = torch.zeros((rules.shape[0], v_in + 1), dtype=torch.bool,
                       device=rules.device)
    seen.scatter_(1, rules.reshape(rules.shape[0], -1).long(), True)
    return seen[:, :v_in].sum()


def _dense_work(mask_in, mask_out, ks, stride, padding, cin, cout):
    """A dense level's conv counted as the sparse conv it stands for: the
    active input sites under each active output site's window."""
    if WORK is None:
        return
    ones = torch.ones((1, 1, *ks), device=mask_in.device)
    with _uncounted():
        hits = F.conv3d(mask_in[:, None].float(), ones, None, stride,
                        padding)
    WORK.append(("dense", hits[:, 0][mask_out].sum().round().long(),
                 ones.numel(), cin, cout, mask_in.sum(), mask_out.sum()))


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
    with _uncounted():
        y = F.conv3d(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2)
                     .to(x.dtype), None, stride, padding)
    y = y.permute(0, 2, 3, 4, 1)
    if bias is None:
        return y
    return (y.float() + bias).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class Level:
    """The voxel sets of one resolution level, batched and CSR-ordered:
    valid (B, V), column metas (B, H*W + 1, 4) and the sites' coords (B, V,
    3) zyx."""

    shape: Tuple[int, int, int]
    valid: torch.Tensor
    meta: torch.Tensor
    coords: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.valid.shape[1]

    @staticmethod
    def from_voxels(coords, valid, shape) -> "Level":
        meta = torch.stack([sc.build_table_csr(coords[b], valid[b],
                                               shape).meta
                            for b in range(valid.shape[0])])
        return Level(shape, valid, meta, coords)

    def downsample(self, ks, stride, pad, capacity: int) -> "Level":
        """The active output set of a strided conv (``build_downsample``)."""
        B = self.valid.shape[0]
        outs = [sc.build_downsample(self.coords[b], self.valid[b], self.shape,
                                    ks, stride, pad, capacity)
                for b in range(B)]
        return Level(outs[0][2], torch.stack([o[1] for o in outs]),
                     torch.stack([o[4] for o in outs]),
                     torch.stack([o[0] for o in outs]))


def conv_index(src: Level, dst: Level, ks, stride, pad):
    """The rulebook (B, K, V_out) of the sparse conv from ``src`` to
    ``dst``."""
    return torch.stack([
        sc.build_conv_rules(sc.VoxelTable(src.coords[b], src.valid[b],
                                          src.meta[b]),
                            src.shape, dst.coords[b], dst.valid[b], ks,
                            stride, pad)
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
                 dense_from: int = 4,
                 train_dense_from: Optional[int] = None):
        super().__init__()
        self.sparse_shape = tuple(sparse_shape)
        self.encoder_channels = tuple(tuple(b) for b in encoder_channels)
        self.down_paddings = tuple(tuple(p) for p in down_paddings)
        self.capacities = tuple(capacities)
        self.out_capacity = out_capacity
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

    def _sparse_conv(self, x, index, wmod, bn, valid):
        """One sparse conv + BN: folded at eval; at training conv, batch
        norm over the active sites, re-mask."""
        if not self.training:
            w, b = wmod.folded(bn)
            return apply_conv_plain(x, index, w, valid, b, x.dtype)
        w = wmod.weight.reshape(-1, *wmod.weight.shape[-2:])
        y = apply_conv_plain(x, index, w, valid, None, x.dtype)
        return torch.where(valid[..., None], apply_bn(y, bn, valid), 0.0)

    def _basic(self, blk, x, index, valid):
        m = valid[..., None]
        y = F.relu(self._sparse_conv(x, index, blk.conv1, blk.bn1, valid))
        y = self._sparse_conv(y, index, blk.conv2, blk.bn2, valid)
        return torch.where(m, F.relu(y + x), 0.0)

    def forward(self, features, coords, valid):
        """features (B, V0, Cin), coords (B, V0, 3) int32 zyx in CSR order,
        valid (B, V0). Returns BEV features (B, H', W', C_out * D_out)."""
        dense_from = (self.train_dense_from if self.training
                      else self.dense_from)
        n_stage = len(self.encoder_channels)
        B = features.shape[0]
        x = torch.where(valid[..., None], features, 0.0)
        lvl = Level.from_voxels(coords, valid, self.sparse_shape)
        index = conv_index(lvl, lvl, 3, 1, 1)
        x = F.relu(self._sparse_conv(x, index, self.conv_input[0],
                                     self.conv_input[1], lvl.valid))
        for i, blocks in enumerate(self.encoder_channels):
            stage = self._stage(i)
            last = i == n_stage - 1
            n_basic = len(blocks) - 1 if not last else len(blocks)
            for j in range(n_basic):
                x = self._basic(stage[j], x, index, lvl.valid)
            if last:
                break
            pad = self.down_paddings[i]
            out = lvl.downsample(3, 2, pad, self.capacities[i + 1])
            index = conv_index(lvl, out, 3, 2, pad)
            x = F.relu(self._sparse_conv(
                x, index, stage[-1][0], stage[-1][1], out.valid))
            lvl = out
            if i + 1 == dense_from:
                sites = lvl.coords
                dense = torch.stack([
                    sc.to_dense(x[b], sites[b], lvl.valid[b], lvl.shape)
                    for b in range(B)])
                ones = lvl.valid.new_ones((lvl.capacity, 1),
                                          dtype=torch.float32)
                mask = torch.stack([
                    sc.to_dense(ones, sites[b], lvl.valid[b],
                                lvl.shape)[..., 0] > 0 for b in range(B)])
                return self._dense_tail(dense, mask, i + 1)
            index = conv_index(lvl, lvl, 3, 1, 1)

        ks_out, st_out = (3, 1, 1), (2, 1, 1)
        out = lvl.downsample(ks_out, st_out, 0, self.out_capacity)
        index = conv_index(lvl, out, ks_out, st_out, 0)
        x = F.relu(self._sparse_conv(
            x, index, self.conv_out[0], self.conv_out[1], out.valid))
        sites = out.coords
        dense = torch.stack([sc.to_dense(x[b], sites[b], out.valid[b],
                                         out.shape) for b in range(B)])
        return self._collapse(dense)

    @staticmethod
    def _collapse(dense):
        """(B, D, H, W, C) -> (B, H, W, C * D), channel = c * D + d."""
        B, D, H, W, C = dense.shape
        return dense.permute(0, 2, 3, 4, 1).reshape(B, H, W, C * D)

    def _dense_conv_bn(self, x, mask, mask_out, wmod, bn, ks, stride,
                       padding, act):
        cin, cout = wmod.weight.shape[-2:]
        _dense_work(mask, mask_out, ks, stride, padding, cin, cout)
        if self.training:  # float32, batch statistics over the active cells
            y = _dense_conv(x.float(), wmod.weight, ks, stride, padding)
            y = apply_bn(y, bn, mask_out)
        else:
            g, b = bn_affine(bn)
            y = _dense_conv(x, wmod.weight, ks, stride, padding, g, b)
        y = torch.where(mask_out[..., None], y, 0.0)
        return F.relu(y) if act else y

    def _dense_tail(self, x, mask, start: int):
        """Levels >= ``start`` and conv_out on the dense grid. x (B, D, H, W,
        C) is zero at inactive cells; mask (B, D, H, W)."""
        in_dtype = x.dtype
        n_stage = len(self.encoder_channels)
        k3 = (3, 3, 3)
        for i in range(start, n_stage):
            blocks = self.encoder_channels[i]
            stage = self._stage(i)
            last = i == n_stage - 1
            n_basic = len(blocks) - 1 if not last else len(blocks)
            for j in range(n_basic):
                blk = stage[j]
                y = self._dense_conv_bn(x, mask, mask, blk.conv1, blk.bn1,
                                        k3, 1, 1, True)
                y = self._dense_conv_bn(y, mask, mask, blk.conv2, blk.bn2,
                                        k3, 1, 1, False)
                x = torch.where(mask[..., None], F.relu(y + x), 0.0)
            if not last:
                pad = self.down_paddings[i]
                out = _pool_mask(mask, k3, 2, pad)
                x = self._dense_conv_bn(x, mask, out, stage[-1][0],
                                        stage[-1][1], k3, 2, pad, True)
                mask = out
        out = _pool_mask(mask, (3, 1, 1), (2, 1, 1), 0)
        x = self._dense_conv_bn(x, mask, out, self.conv_out[0],
                                self.conv_out[1], (3, 1, 1), (2, 1, 1), 0,
                                True)
        return self._collapse(x).to(in_dtype)

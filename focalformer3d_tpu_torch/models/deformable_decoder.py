"""Box-level deformable transformer decoder (DeformableDETR-style).

Port of ``focalformer3d_tpu/models/deformable_decoder.py``. Submodules follow
mmcv's ``BaseTransformerLayer`` names (``attentions.0.attn`` an
``nn.MultiheadAttention`` container, ``attentions.1`` the deformable
cross-attention, ``ffns.0.layers``, ``norms.N``) so reference keys load as
they are; the math is written out to match the JAX modules (layer norm eps
1e-6 as flax's default). In training (the module's ``training`` flag) the
JAX modules' dropouts (rate ``dropout``, 0.1: after the self-attention and
cross-attention output projections and after each FFN layer) draw their
bits from the ``generator`` argument.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.msda import msda_sample
from .layers import dropout, filled, linear


class MSDeformAttention(nn.Module):
    def __init__(self, embed_dim: int = 128, num_heads: int = 8,
                 num_levels: int = 3, num_points: int = 4,
                 dropout: float = 0.1):
        super().__init__()
        self.nH, self.L, self.P = num_heads, num_levels, num_points
        self.dropout = dropout
        n = num_heads * num_levels * num_points
        self.sampling_offsets = nn.Linear(embed_dim, n * 2)
        self.attention_weights = nn.Linear(embed_dim, n)
        self.value_proj = nn.Linear(embed_dim, embed_dim)
        self.output_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, query, value_levels: Sequence[torch.Tensor],
                reference_points, query_pos=None, dtype=None,
                generator=None):
        """query (B, Q, C); value_levels [(B, H_l, W_l, C)];
        reference_points (B, Q, 2) normalized to [0, 1]."""
        B, Q, C = query.shape
        nH, L, P = self.nH, self.L, self.P
        identity = query
        if query_pos is not None:
            query = query + query_pos
        offsets = linear(query, self.sampling_offsets, dtype)
        offsets = offsets.reshape(B, Q, nH, L, P, 2).float()
        attn = linear(query, self.attention_weights, dtype)
        attn = torch.softmax(attn.reshape(B, Q, nH, L * P), dim=-1)
        attn = attn.reshape(B, Q, nH, L, P)
        values = [linear(v, self.value_proj, dtype) for v in value_levels]
        norm = filled([n for v in value_levels for n in (v.shape[2],
                                                        v.shape[1])],
                      query.device).reshape(len(value_levels), 2)
        loc = (reference_points[:, :, None, None, None, :]
               + offsets / norm[None, None, None, :, None, :])
        out = msda_sample(values, loc, attn, nH)
        out = linear(out, self.output_proj, dtype)
        if self.training:
            out = dropout(out, self.dropout, generator)
        return (identity + out).to(out.dtype)


class _SelfAttention(nn.Module):
    """Holds ``attn`` (an ``nn.MultiheadAttention`` used for its parameter
    layout: packed ``in_proj_weight``/``in_proj_bias`` and ``out_proj``)."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.attn = nn.MultiheadAttention(embed_dim, num_heads,
                                          batch_first=True)

    def forward(self, query, query_pos=None, dtype=None, attn_mask=None,
                generator=None):
        """attn_mask (B, Q, Q) bool, True = blocked (the torch convention)."""
        B, Q, C = query.shape
        nH = self.num_heads
        Dh = C // nH
        dt = dtype or query.dtype
        wq, wk, wv = self.attn.in_proj_weight.to(dt).chunk(3)
        bq, bk, bv = self.attn.in_proj_bias.to(dt).chunk(3)
        qk_in = (query + query_pos if query_pos is not None else query).to(dt)
        q = F.linear(qk_in, wq, bq).reshape(B, Q, nH, Dh)
        k = F.linear(qk_in, wk, bk).reshape(B, Q, nH, Dh)
        v = F.linear(query.to(dt), wv, bv).reshape(B, Q, nH, Dh)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(Dh)
        if attn_mask is not None:
            logits = torch.where(attn_mask[:, None], -1e9, logits)
        w = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, Q, C)
        out = linear(out, self.attn.out_proj, dt)
        if self.training:
            out = dropout(out, self.dropout, generator)
        return (query + out).to(out.dtype)


class _FFN(nn.Module):
    def __init__(self, embed_dim: int, ffn_dim: int, dropout: float):
        super().__init__()
        self.dropout = dropout
        self.layers = nn.Sequential(
            nn.Sequential(nn.Linear(embed_dim, ffn_dim), nn.ReLU()),
            nn.Linear(ffn_dim, embed_dim),
        )

    def forward(self, x, dtype=None, generator=None):
        y = F.relu(linear(x, self.layers[0][0], dtype))
        if self.training:
            y = dropout(y, self.dropout, generator)
        y = linear(y, self.layers[1], dtype)
        if self.training:
            y = dropout(y, self.dropout, generator)
        return y


class DecoderLayer(nn.Module):
    """self-attn -> norm -> deformable cross-attn -> norm -> FFN -> norm."""

    def __init__(self, embed_dim: int = 128, num_heads: int = 8,
                 num_levels: int = 3, num_points: int = 4,
                 ffn_dim: int = 1024, dropout: float = 0.1):
        super().__init__()
        self.attentions = nn.ModuleList([
            _SelfAttention(embed_dim, num_heads, dropout),
            MSDeformAttention(embed_dim, num_heads, num_levels, num_points,
                              dropout),
        ])
        self.ffns = nn.ModuleList([_FFN(embed_dim, ffn_dim, dropout)])
        self.norms = nn.ModuleList(
            nn.LayerNorm(embed_dim, eps=1e-6) for _ in range(3)
        )

    def _norm(self, i, x, dtype):
        n = self.norms[i]
        dt = dtype or x.dtype
        return F.layer_norm(x.to(dt), n.normalized_shape, n.weight.to(dt),
                            n.bias.to(dt), n.eps)

    def forward(self, query, value_levels, reference_points, query_pos=None,
                dtype=None, attn_mask=None, generator=None):
        query = self._norm(0, self.attentions[0](query, query_pos, dtype,
                                                 attn_mask, generator),
                           dtype)
        query = self.attentions[1](query, value_levels, reference_points,
                                   query_pos, dtype, generator)
        query = self._norm(1, query, dtype)
        y = self.ffns[0](query, dtype, generator)
        return self._norm(2, query + y, dtype)


class DeformableDecoder(nn.Module):
    def __init__(self, num_layers: int = 3, embed_dim: int = 128,
                 num_heads: int = 8, num_levels: int = 3, num_points: int = 4,
                 ffn_dim: int = 1024, dropout: float = 0.1):
        super().__init__()
        self.layers = nn.ModuleList(
            DecoderLayer(embed_dim, num_heads, num_levels, num_points,
                         ffn_dim, dropout)
            for _ in range(num_layers)
        )

    def forward(self, query, value_levels, reference_points, query_pos=None,
                dtype=None, attn_mask=None, generator=None):
        for layer in self.layers:
            query = layer(query, value_levels, reference_points, query_pos,
                          dtype, attn_mask, generator)
        return query

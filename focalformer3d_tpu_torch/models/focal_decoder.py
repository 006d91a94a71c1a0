"""FocalDecoder head, eval: Hard Instance Probing + box-level decoder.

Port of the eval forward of ``focalformer3d_tpu/models/focal_decoder.py``
and its ``get_bboxes``:

* per stage, a BEV heatmap (the first stage reuses ``heatmap_head``), the
  accumulated mask of earlier stages, max-pool peak suppression with
  kernel-1 classes, and the top ``num_proposals`` (class, cell) picks as
  queries with class embeddings; ``poscls`` masking of the picked cells;
* a 3-level BEV pyramid, RoI grid pooling from the previous round's boxes,
  and ``num_decoder_layers`` rounds of the deformable decoder with FFN
  prediction heads.

The denoising GT groups (training) and the ``pos`` / ``boxcls`` mask modes
are not ported. Inputs and outputs keep the JAX layouts: BEV maps
(B, H, W, C); per-round outputs (B, rounds, Q, d).

Top-k ties: after peak suppression many cells are exactly 0, and
``torch.topk`` does not promise an order among equal values, so proposals
come from a stable descending sort (ties to the lower flat index, as
``lax.top_k``) over the flat (class * H*W + cell) order.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import FocalDecoderConfig
from ..core import box_coder as bc
from ..core.nms import top_k_mask
from ..ops.bilinear import grid_sample_norm
from .deformable_decoder import DeformableDecoder
from .layers import (ConvBN, MLP, PredictionFFN, apply_bn, conv2d_nhwc,
                     linear, sine_embed_2d)

# shape of the reference checkpoint's bev_pos buffer (a 180 x 180 grid)
REF_BEV_POS_SHAPE = (1, 32400, 2)


def _bev_pos(H: int, W: int, scale: float, device) -> torch.Tensor:
    """(H*W, 2) grid-centre coordinates (x, y); p = y*W + x."""
    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=device),
        torch.arange(W, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([xs + 0.5, ys + 0.5], dim=-1).reshape(H * W, 2) * scale


def _peak_suppress(heat, k: int, kernel1: Sequence[int]):
    """heat (B, C, H, W): zero the non-local-max pixels. Borders are
    suppressed for kernel-k classes (the reference's VALID max-pool)."""
    pad = k // 2
    H, W = heat.shape[-2:]
    local_max = torch.zeros_like(heat)
    local_max[:, :, pad:H - pad, pad:W - pad] = F.max_pool2d(heat, k, 1, 0)
    for c in kernel1:
        local_max[:, c] = heat[:, c]
    return heat * (heat == local_max)


def _dilate_mask(mask, k: int, kernel1: Sequence[int]):
    """mask (B, C, H, W) in {0, 1}: SAME max-pool dilation, kernel-1
    classes kept as they are."""
    dil = F.max_pool2d(mask, k, 1, k // 2)
    for c in kernel1:
        dil[:, c] = mask[:, c]
    return dil


def _stable_top_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest along the last axis, ties to lower index."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def _rotate_z(points, angle):
    """Rotate (..., N, 2) points counter-clockwise about +z by (...,)."""
    c, s = torch.cos(angle)[..., None], torch.sin(angle)[..., None]
    x, y = points[..., 0], points[..., 1]
    return torch.stack([c * x - s * y, s * x + c * y], dim=-1)


class _HeatmapHead(nn.Module):
    """Sequential[ConvModule(h, h, 3), Conv2d(h, ncls, 3)]; f32 logits."""

    def __init__(self, hidden: int, num_classes: int):
        super().__init__()
        self.add_module("0", ConvBN(hidden, hidden, 3))
        self.add_module("1", nn.Conv2d(hidden, num_classes, 3, padding=1))

    def forward(self, x, dtype=None):
        y = getattr(self, "0")(x, dtype)
        out = getattr(self, "1")
        return conv2d_nhwc(y, out.weight, out.bias, 1, 1, dtype=dtype).float()


class FocalDecoder(nn.Module):
    def __init__(self, cfg: FocalDecoderConfig):
        super().__init__()
        if cfg.mask_heatmap_mode != "poscls" or cfg.classaware_reg:
            raise NotImplementedError(
                "only the 'poscls' mask mode without class-aware "
                "regression is ported")
        self.cfg = cfg
        h, ncls = cfg.hidden, cfg.num_classes
        self.heatmap_head = _HeatmapHead(h, ncls)
        start = 1 if cfg.reuse_first_heatmap else 0
        self.heatmap_head_img = nn.ModuleDict({
            str(i): _HeatmapHead(h, ncls)
            for i in range(start, cfg.total_stages)
        })
        self.class_encoding = nn.Conv1d(ncls, h, 1)
        n_levels = 1
        if cfg.multiscale:
            self.dconv = ConvBN(h, h, 3, stride=2)
            self.dconv2 = ConvBN(h, h, 3, stride=2)
            n_levels = 3
        self.decoder = nn.ModuleList(
            DeformableDecoder(cfg.inner_layers, h, cfg.num_heads, n_levels, 4)
            for _ in range(cfg.num_decoder_layers)
        )
        self.pos_embed_learned = nn.ModuleList(
            MLP(256, h, h, 2) for _ in range(cfg.num_decoder_layers)
        )
        heads = {"center": 2, "height": 1, "dim": 3, "rot": 2}
        if cfg.with_vel:
            heads["vel"] = 2
        heads["heatmap"] = ncls
        self.prediction_heads = nn.ModuleList(
            PredictionFFN(h, heads) for _ in range(cfg.num_decoder_layers)
        )
        if cfg.roi_feats:
            pre = cfg.roi_feats ** 2 * h * n_levels
            layers = []
            for li in range(3):
                out = cfg.hidden_roi if li < 2 else h
                layers += [nn.Linear(pre, out, bias=False),
                           nn.BatchNorm1d(out), nn.ReLU(),
                           nn.Dropout(cfg.roi_dropout)]
                pre = out
            self.roi_mlp = nn.Sequential(*layers)
        # carried for reference checkpoints only; positions are recomputed
        # from the BEV size at every forward, as on the JAX side
        self.register_buffer("bev_pos", torch.zeros(REF_BEV_POS_SHAPE))

    def _grid_points(self, boxes_std):
        """RoI grid points (..., R*R, 2): world xy inside each box."""
        R = self.cfg.roi_feats
        ii, jj = torch.meshgrid(
            torch.arange(R, dtype=torch.float32, device=boxes_std.device),
            torch.arange(R, dtype=torch.float32, device=boxes_std.device),
            indexing="ij")
        base = torch.stack([ii, jj], -1).reshape(R * R, 2)
        dims = boxes_std[..., 3:5]
        local = (base + 0.5) / R * dims[..., None, :] - dims[..., None, :] / 2
        return _rotate_z(local, boxes_std[..., 6]) + boxes_std[..., None, :2]

    def _roi_features(self, levels, query_box, dtype):
        cfg = self.cfg
        B, Qn = query_box.shape[:2]
        qb = query_box
        std = bc.decode_box(
            cfg.coder, qb[..., :2], qb[..., 2:3],
            qb[..., 3:6] * cfg.roi_expand_ratio, qb[..., 6:8],
            qb[..., 8:10] if cfg.with_vel else None,
        )
        gp = self._grid_points(std)
        pcr = torch.tensor(cfg.pc_range, dtype=torch.float32,
                           device=qb.device)
        gn = ((gp - pcr[:2]) / (pcr[3:5] - pcr[:2]) * 2.0 - 1.0).clamp(-2, 2)
        roi = torch.cat([
            torch.stack([grid_sample_norm(v[b], gn[b]) for b in range(B)])
            for v in levels
        ], dim=-1)  # (B, Qn, RR, L*C)
        # channel-major flatten (feature = c*RR + rr), as the reference
        y = roi.transpose(2, 3).reshape(B, Qn, -1)
        mods = list(self.roi_mlp)
        for li in range(3):
            y = F.relu(apply_bn(linear(y, mods[4 * li], dtype),
                                mods[4 * li + 1]))
        return y

    def forward(self, lidar_feat: torch.Tensor,
                stage_feats: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """lidar_feat (B, H, W, C) pts_feat_conv; stage_feats per-stage BEV
        maps (+ extra map last). Returns the JAX head's eval output dict."""
        cfg = self.cfg
        dt = cfg.tdtype
        dev = lidar_feat.device
        B, H, W, C = lidar_feat.shape
        ncls, S, P, HW = cfg.num_classes, cfg.total_stages, \
            cfg.num_proposals, H * W

        stage_feats = list(stage_feats)
        extra = stage_feats.pop(-1) if cfg.extra_feat else None
        if cfg.reuse_first_heatmap:
            stage_feats = [lidar_feat] + stage_feats
        if len(stage_feats) != S:
            raise ValueError(f"{len(stage_feats)} stage maps for {S} stages")
        bev_pos = _bev_pos(H, W, 1.0, dev)
        dense_heatmap = self.heatmap_head(lidar_feat, dt)  # (B, H, W, ncls)

        acc_mask = torch.ones((B, ncls, H, W), device=dev)
        q_feats, q_pos, q_score, q_labels = [], [], [], []
        heatmaps, masks = [], []
        for i in range(S):
            if i == 0 and cfg.reuse_first_heatmap:
                dh = dense_heatmap
            else:
                dh = self.heatmap_head_img[str(i)](stage_feats[i], dt)
                if i == 0:
                    heatmaps.append(dense_heatmap)
                    masks.append(acc_mask)
            heatmaps.append(dh)
            masks.append(acc_mask)
            heat = torch.sigmoid(dh.permute(0, 3, 1, 2)) * acc_mask
            peaks = _peak_suppress(heat, cfg.nms_kernel_size,
                                   cfg.kernel1_classes)
            top_i = _stable_top_k(peaks.reshape(B, ncls * HW), P)
            top_cls = torch.div(top_i, HW, rounding_mode="floor")
            top_p = top_i % HW

            feat = stage_feats[i].reshape(B, HW, C)
            qf = torch.gather(feat, 1, top_p[..., None].expand(-1, -1, C))
            one_hot = F.one_hot(top_cls, ncls).to(qf.dtype)
            qf = qf + F.linear(one_hot.to(dt),
                               self.class_encoding.weight[..., 0].to(dt),
                               self.class_encoding.bias.to(dt))
            heat_flat = peaks.reshape(B, ncls, HW).transpose(1, 2)
            q_feats.append(qf)
            q_pos.append(bev_pos[top_p])
            q_score.append(torch.gather(
                heat_flat, 1, top_p[..., None].expand(-1, -1, ncls)))
            q_labels.append(top_cls.to(torch.int32))

            sel = torch.zeros((B, ncls * HW), device=dev)
            sel.scatter_(1, top_i, 1.0)
            acc_mask = acc_mask * (1.0 - _dilate_mask(
                sel.reshape(B, ncls, H, W), cfg.nms_kernel_size,
                cfg.kernel1_classes))

        query_feat = torch.cat(q_feats, dim=1)  # (B, S*P, C)
        query_pos = torch.cat(q_pos, dim=1)
        query_score = torch.cat(q_score, dim=1)
        query_labels = torch.cat(q_labels, dim=1)

        levels = [extra if cfg.extra_feat else stage_feats[-1]]
        level_pos = [_bev_pos(H, W, 1.0, dev)]
        if cfg.multiscale:
            levels.append(self.dconv(levels[-1], dt))
            levels.append(self.dconv2(levels[-1], dt))
            level_pos.append(_bev_pos(H // 2, W // 2, 2.0, dev))
            level_pos.append(_bev_pos(H // 4, W // 4, 4.0, dev))
        norm_wh = torch.tensor([W, H], dtype=torch.float32, device=dev)

        rounds: List[Dict[str, torch.Tensor]] = []
        query_box = None
        for r in range(cfg.num_decoder_layers):
            ref = query_pos / norm_wh
            pos_embed = self.pos_embed_learned[r]
            qpe = pos_embed(sine_embed_2d(ref), dt)
            vals = levels
            if cfg.bevpos:
                vals = [
                    v + pos_embed(sine_embed_2d(lp / norm_wh), dt).reshape(
                        1, v.shape[1], v.shape[2], cfg.hidden)
                    for v, lp in zip(levels, level_pos)
                ]
            if cfg.roi_feats and query_box is not None:
                y = self._roi_features(levels, query_box, dt)
                query_feat = (query_feat + y).to(y.dtype)
            query_feat = self.decoder[r](query_feat, vals, ref, qpe, dt)

            res = self.prediction_heads[r](query_feat, dt)
            res["center"] = res["center"] + query_pos
            query_pos = res["center"]
            if cfg.roi_based_reg and query_box is not None:
                res["dim"] = torch.cat(
                    [res["dim"][..., :2] + query_box[..., 3:5],
                     res["dim"][..., 2:]], dim=-1)
                res["rot"] = res["rot"] + query_box[..., 6:8]
            parts = [res["center"], res["height"], res["dim"], res["rot"]]
            if cfg.with_vel:
                parts.append(res["vel"])
            query_box = torch.cat(parts, dim=-1)
            rounds.append(res)

        out = {k: torch.stack([r[k] for r in rounds], dim=1)
               for k in rounds[0]}
        out["query_labels"] = query_labels
        out["query_heatmap_score"] = query_score
        out["dense_heatmap"] = torch.stack(heatmaps, dim=1)
        out["multistage_masks"] = torch.stack(
            [m.permute(0, 2, 3, 1) for m in masks], dim=1)
        return out


def get_bboxes(cfg: FocalDecoderConfig, out: Dict[str, torch.Tensor],
               max_out: int = 200) -> Dict[str, torch.Tensor]:
    """Final-round predictions -> fixed-size box lists: bboxes (B, Q, 9),
    scores, labels, and a mask with at most ``max_out`` entries per
    sample (no NMS, as the nuScenes default)."""
    num_prop = cfg.total_stages * cfg.num_proposals

    def last(x):
        return x[:, -1, :num_prop]

    heat = torch.sigmoid(last(out["heatmap"]))
    one_hot = F.one_hot(out["query_labels"][:, :num_prop].long(),
                        cfg.num_classes).to(heat.dtype)
    score = heat * out["query_heatmap_score"][:, :num_prop] * one_hot
    dec = bc.decode(
        cfg.coder, score, last(out["center"]), last(out["height"]),
        last(out["dim"]), last(out["rot"]),
        last(out["vel"]) if cfg.with_vel else None, apply_filter=True,
    )
    dec["mask"] = top_k_mask(dec["scores"], dec["mask"], max_out)
    return dec

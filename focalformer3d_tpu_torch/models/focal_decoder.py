"""FocalDecoder head: Hard Instance Probing + box-level decoder.

Port of ``focalformer3d_tpu/models/focal_decoder.py`` and its
``get_bboxes``:

* per stage, a BEV heatmap (the first stage reuses ``heatmap_head``), the
  accumulated mask of earlier stages, max-pool peak suppression with
  kernel-1 classes, and the top ``num_proposals`` (class, cell) picks as
  queries with class embeddings; the mask of the picks for the next
  stages (``mask_heatmap_mode``): ``poscls`` the picked (class, cell)
  pairs, ``pos`` the picked cells in every class, ``boxcls`` the picked
  pairs and, in each pick's class, the cells inside its box, which a dense
  per-class box head of the stage regresses (``heatmap_box_head.{i}``,
  detached; ``ops/points_in_boxes``);
* a 3-level BEV pyramid, RoI grid pooling from the previous round's boxes,
  and ``num_decoder_layers`` rounds of the deformable decoder with FFN
  prediction heads.

* in training (the module's ``training`` flag): the denoising GT query
  groups (``add_gt_groups`` noised copies of the GT boxes, their noise from
  ``gt_group_noise``) behind an attention mask, RoI-MLP and decoder dropout
  from the ``generator`` argument, and the ``gt_valid_mask`` /
  ``gt_query_labels`` outputs the losses read. Stop-gradients sit where
  the JAX head has them (heatmap picks, query positions, query boxes).

Where the neck has more fusion layers than the head has heatmap stages
(DeformFormer3D_Waymo_L and _Waymo15_L: two layers, one stage without
reuse), the stages read the deepest maps; JAX's head asserts that the two
counts agree, so those configs run in the port only (ROADMAP.md Queue 3).

No named config sets ``pos`` or ``boxcls``. JAX's key inventory lists no
box heads: the port names them ``heatmap_box_head.{i}`` after the heatmap
heads (``utils/jax_keys``). With ``classaware_reg``
(FocalFormer3D_Waymo15_L) the box heads are ``num_classes`` times as
wide, and each query reads the slice of its label before the RoI box is
added. Inputs and outputs keep the JAX layouts: BEV
maps (B, H, W, C); per-round outputs (B, rounds, Q, d).

On a card at eval without grad every shape in the head is static, so the
forward runs as CUDA graph replays from a geometry's second call: a graph
a block of ``_blocks`` (the dense heatmap, each heatmap stage, the queries
and value levels, each round, the output stack), replayed in its span, the
returned dict copied out of the graphs' pool (``_block_runs``,
``utils/graphs``; counted in ``DECODER_BLOCKS``). Its constants are device
fills (``layers.filled``), so the head reads no device value on the host.

Top-k ties: after peak suppression many cells are exactly 0, and
``torch.topk`` does not promise an order among equal values, so proposals
come from a stable descending sort (ties to the lower flat index, as
``lax.top_k``) over the flat (class * H*W + cell) order.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import FocalDecoderConfig
from ..core import box_coder as bc
from ..core.nms import top_k_mask
from ..ops import cuda_build
from ..ops.bilinear import grid_sample_norm
from ..ops.points_in_boxes import points_in_boxes
from ..utils import graphs
from ..utils.profiler import span
from .deformable_decoder import DeformableDecoder
from .layers import (FLAX_BN_MOMENTUM, ConvBN, MLP, PredictionFFN,
                     apply_bn, conv2d_nhwc, dropout, filled, linear,
                     sine_embed_2d)

# shape of the reference checkpoint's bev_pos buffer (a 180 x 180 grid)
REF_BEV_POS_SHAPE = (1, 32400, 2)
MASK_MODES = ("poscls", "pos", "boxcls")
# the dense box heads' regression per class (``boxcls``), whatever the
# code size: centre offset 2, height 1, dims 3, sin / cos 2, velocity 2
BOX_DIM = 10
# head blocks on a card, by how: replayed from a CUDA graph, captured into
# one, or run eagerly (``train_step.kernel_launches``)
DECODER_BLOCKS = cuda_build.Launches("decoder_graph_replay",
                                     "decoder_graph_capture",
                                     "decoder_eager")


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


def gt_group_noise(generator: Optional[torch.Generator], shape,
                   device) -> torch.Tensor:
    """U(-1, 1) offsets of the denoising GT queries, (B, NG*G, 2) in units
    of half the box extents (``jax.random.uniform(minval=-1, maxval=1)`` in
    the JAX head)."""
    return torch.rand(shape, generator=generator, device=device) * 2.0 - 1.0


def _rotate_z(points, angle):
    """Rotate (..., N, 2) points counter-clockwise about +z by (...,)."""
    c, s = torch.cos(angle)[..., None], torch.sin(angle)[..., None]
    x, y = points[..., 0], points[..., 1]
    return torch.stack([c * x - s * y, s * x + c * y], dim=-1)


def _gather_query_boxes(dense_boxes, bev_pos, top_i, ncls: int, HW: int):
    """The dense box regressions at the picked (class, cell) indices, with
    the reference's clipping, detached: dense_boxes (B, H, W, BOX_DIM *
    ncls) -> (B, P, BOX_DIM)."""
    B = dense_boxes.shape[0]
    bd = dense_boxes.shape[-1] // ncls
    df = dense_boxes.reshape(B, HW, ncls, bd).transpose(1, 2) \
        .reshape(B, ncls * HW, bd)
    qb = torch.gather(df, 1, top_i[..., None].expand(-1, -1, bd)).detach()
    cell = bev_pos[top_i % HW]
    return torch.cat([
        qb[..., 0:2] + torch.floor(cell),
        qb[..., 2:3].clamp(-5.0, 3.0),
        qb[..., 3:6].clamp(math.log(0.5), math.log(15.0)),
        qb[..., 6:8].clamp(-1.0, 1.0),
        qb[..., 8:].clamp(-15.0, 15.0)], dim=-1)


def _boxcls_mask(cfg, qb, top_cls, bev_pos, top_i, shape):
    """``boxcls``: the picked (class, cell) pairs and, in each pick's class
    channel, the BEV cells inside its box (its dims less a 1 m margin,
    0.7-10 m); a cell inside several boxes takes the first pick's class.
    Returns (B, ncls, H, W) in {0, 1}."""
    B, ncls, H, W = shape
    HW = H * W
    center = bc.decode_center(cfg.coder, qb[..., 0:2])
    pcr = cfg.pc_range
    cx = center[..., 0].clamp(pcr[0], pcr[3])
    cy = center[..., 1].clamp(pcr[1], pcr[4])
    dxy = (torch.exp(qb[..., 3:5]) - 1.0).clamp(0.7, 10.0)
    yaw = torch.atan2(qb[..., 6], qb[..., 7])
    boxes = torch.stack([cx, cy, torch.full_like(cx, -100.0), dxy[..., 0],
                         dxy[..., 1], torch.full_like(cx, 1000.0), yaw], -1)
    cells = bc.decode_center(cfg.coder, bev_pos)
    cells3 = torch.cat([cells, cells.new_zeros(HW, 1)], dim=-1)
    sel = []
    for b in range(B):
        idx = points_in_boxes(cells3, boxes[b]).long()  # (HW,) pick or -1
        cls_cell = torch.where(idx >= 0, top_cls[b][idx.clamp(min=0)],
                               ncls)
        selb = F.one_hot(cls_cell, ncls + 1)[:, :ncls].float()
        # a scatter: ``selp[top_i[b]] = 1.0`` syncs on a card
        selp = torch.zeros(ncls * HW, device=qb.device).scatter_(
            0, top_i[b], 1.0)
        sel.append(torch.maximum(selb.T, selp.reshape(ncls, HW)))
    return torch.stack(sel).reshape(B, ncls, H, W)


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
        if cfg.mask_heatmap_mode not in MASK_MODES:
            raise ValueError(f"mask_heatmap_mode {cfg.mask_heatmap_mode!r} "
                             f"not in {MASK_MODES}")
        if cfg.mask_heatmap_mode == "boxcls" and not cfg.heatmap_box:
            raise ValueError("boxcls masking needs heatmap_box")
        self.cfg = cfg
        h, ncls = cfg.hidden, cfg.num_classes
        self.heatmap_head = _HeatmapHead(h, ncls)
        start = 1 if cfg.reuse_first_heatmap else 0
        self.heatmap_head_img = nn.ModuleDict({
            str(i): _HeatmapHead(h, ncls)
            for i in range(start, cfg.total_stages)
        })
        if cfg.mask_heatmap_mode == "boxcls":  # JAX's _HeatmapBoxHead
            self.heatmap_box_head = nn.ModuleDict({
                str(i): _HeatmapHead(h, BOX_DIM * ncls)
                for i in range(cfg.total_stages)})
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
        if cfg.classaware_reg:  # one slice of each box head per class
            heads = {k: d * ncls for k, d in heads.items()}
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
                           nn.BatchNorm1d(out, momentum=FLAX_BN_MOMENTUM),
                           nn.ReLU(),
                           nn.Dropout(cfg.roi_dropout)]
                pre = out
            self.roi_mlp = nn.Sequential(*layers)
        # carried for reference checkpoints only; positions are recomputed
        # from the BEV size at every forward, as on the JAX side
        self.register_buffer("bev_pos", torch.zeros(REF_BEV_POS_SHAPE))
        # the eval head's CUDA graphs by geometry (``_block_runs``)
        self._graphs = graphs.GraphCache(DECODER_BLOCKS, "decoder")

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

    def _roi_features(self, levels, query_box, dtype, generator):
        cfg = self.cfg
        B, Qn = query_box.shape[:2]
        qb = query_box
        std = bc.decode_box(
            cfg.coder, qb[..., :2], qb[..., 2:3],
            qb[..., 3:6] * cfg.roi_expand_ratio, qb[..., 6:8],
            qb[..., 8:10] if cfg.with_vel else None,
        )
        gp = self._grid_points(std)
        pcr = filled(cfg.pc_range, qb.device)
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
            if self.training:
                y = dropout(y, mods[4 * li + 3].p, generator)
        return y

    def _gt_groups(self, gt_boxes, gt_labels, gt_valid, peaks, feats,
                   bev_pos, generator):
        """Denoising GT queries (JAX ``focal_decoder.py:374-436``): each GT
        box repeated ``add_gt_groups`` times with its centre moved inside
        the box by ``gt_group_noise``; a copy moved too far (centre offset
        >= ``add_gt_pos_thresh`` or noise norm >= the box-noise threshold)
        is labelled background. Returns (feats, pos, scores, labels, valid)
        of the group queries; invalid GT slots are zeroed."""
        cfg = self.cfg
        B, H, W, C = feats.shape
        ncls, NG, G = cfg.num_classes, cfg.add_gt_groups, gt_boxes.shape[1]
        dev = feats.device
        noise = gt_group_noise(generator, (B, NG * G, 2), dev)
        gb = gt_boxes.repeat(1, NG, 1)
        gl = gt_labels.repeat(1, NG)
        gvalid = gt_valid.repeat(1, NG)
        cy, sy = torch.cos(gb[..., 6]), torch.sin(gb[..., 6])
        wvec = torch.stack([cy * gb[..., 3], sy * gb[..., 3]], -1)
        hvec = torch.stack([-sy * gb[..., 4], cy * gb[..., 4]], -1)
        center_noise = wvec / 2 * noise[..., 0:1] + hvec / 2 * noise[..., 1:2]
        centers = gb[..., :2] + center_noise
        positive = ((torch.linalg.norm(center_noise, dim=-1)
                     < cfg.add_gt_pos_thresh)
                    & (torch.linalg.norm(noise, dim=-1)
                       < cfg.add_gt_pos_boxnoise_thresh))
        labels = torch.where(positive & gvalid, gl, ncls).to(torch.int32)
        pcr = filled(cfg.pc_range, dev)
        cx = torch.clamp(centers[..., 0], pcr[0] + 1e-6, pcr[3] - 1e-5)
        cyy = torch.clamp(centers[..., 1], pcr[1] + 1e-6, pcr[4] - 1e-5)
        gx = ((cx - pcr[0]) / (pcr[3] - pcr[0]) * W).to(torch.int32)
        gy = ((cyy - pcr[1]) / (pcr[4] - pcr[1]) * H).to(torch.int32)
        p = (gy.clamp(0, H - 1) * W + gx.clamp(0, W - 1)).long()
        gqf = torch.gather(feats.reshape(B, H * W, C), 1,
                           p[..., None].expand(-1, -1, C))
        heat_flat = peaks.reshape(B, ncls, H * W).transpose(1, 2)
        gqs = torch.gather(heat_flat, 1, p[..., None].expand(-1, -1, ncls))
        one_hot = F.one_hot(labels.long(), ncls + 1)[..., :ncls]
        dt = cfg.tdtype
        gqf = gqf + F.linear(one_hot.to(dt),
                             self.class_encoding.weight[..., 0].to(dt),
                             self.class_encoding.bias.to(dt))
        vmask = gvalid[..., None].to(gqf.dtype)
        return (gqf * vmask, bev_pos[p] * vmask, gqs * vmask, labels,
                gvalid)

    def _apply(self, *args, **kwargs):
        # the graphs read the parameters' storage, which a move or a cast
        # replaces
        self._graphs.clear()
        return super()._apply(*args, **kwargs)

    def forward(self, lidar_feat: torch.Tensor,
                stage_feats: List[torch.Tensor],
                gt_boxes: Optional[torch.Tensor] = None,
                gt_labels: Optional[torch.Tensor] = None,
                gt_valid: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """lidar_feat (B, H, W, C) pts_feat_conv; stage_feats per-stage BEV
        maps (+ extra map last); in training the padded GT (B, G, 9) boxes,
        (B, G) labels and validity for the denoising groups, and the
        generator of the dropouts and the group noise. Runs the blocks of
        ``_blocks``, each heatmap stage in the ``utils/profiler`` span
        "decoder/heatmap <i>" and each decoder round in "decoder/layer
        <r>" (``_block_spans``), as CUDA graph replays where
        ``_block_runs`` says. Returns the JAX head's output dict."""
        maps = self._maps(stage_feats)
        runs, replayed = self._block_runs(lidar_feat, maps, gt_boxes,
                                          gt_labels, gt_valid, generator)
        for name in self._block_spans():
            with span(name) if name else contextlib.nullcontext():
                out = next(runs)
        if replayed:  # the replay's outputs live in the graphs' pool
            out = {k: v.clone() for k, v in out.items()}
        return out

    def _maps(self, stage_feats: Sequence[torch.Tensor]
              ) -> List[torch.Tensor]:
        """The maps the head reads beside lidar_feat: the heatmap stages'
        own, then the extra map. Where the neck has more fusion layers
        than the head has heatmap stages (the DeformFormer3D Waymo configs:
        two layers, one stage) the stages read the deepest maps, where
        JAX's head asserts (ROADMAP.md Queue 3)."""
        cfg = self.cfg
        stage_feats = list(stage_feats)
        extra = [stage_feats.pop(-1)] if cfg.extra_feat else []
        reuse = int(cfg.reuse_first_heatmap)
        n_maps = cfg.total_stages - reuse
        maps = stage_feats[max(len(stage_feats) - n_maps, 0):]
        if len(maps) != n_maps:
            raise ValueError(f"{len(maps) + reuse} stage maps for "
                             f"{cfg.total_stages} stages")
        return maps + extra

    def _block_spans(self) -> List[Optional[str]]:
        """The span of each block of ``_blocks``; None for the blocks
        between the sub-spans: the dense heatmap before the stages, the
        queries (and denoising groups) and value levels before the rounds,
        the output stack after them."""
        cfg = self.cfg
        return ([None]
                + [f"decoder/heatmap {i}" for i in range(cfg.total_stages)]
                + [None]
                + [f"decoder/layer {r}"
                   for r in range(cfg.num_decoder_layers)]
                + [None])

    def _block_runs(self, lidar_feat, maps, gt_boxes, gt_labels, gt_valid,
                    generator):
        """The blocks of ``_blocks``, and whether they are graph replays.

        On a card at eval without grad every shape in the head is static,
        so the head runs eagerly at a geometry's first call (its warm-up),
        is captured at its second, a CUDA graph a block, and replays at
        every later call (``utils/graphs``). It runs eagerly on the CPU, in
        training or with the denoising groups' GT given, with grad
        enabled, inside another capture and under a dispatch mode."""
        inputs = (lidar_feat, *maps)

        def build(*t):
            return self._blocks(t[0], t[1:], gt_boxes, gt_labels, gt_valid,
                                generator)

        if lidar_feat.device.type != "cuda":
            return build(*inputs), False
        if (self.training or gt_boxes is not None or torch.is_grad_enabled()
                or graphs.must_run_eagerly()):
            return self._graphs.eager(build(*inputs)), False
        cfg = self.cfg
        key = (self.training, torch.is_inference_mode_enabled(),
               lidar_feat.device, cfg.tdtype,
               tuple((t.shape, t.dtype) for t in inputs),
               cfg.num_proposals, cfg.total_stages, cfg.num_decoder_layers)
        return self._graphs.run(key, build, len(self._block_spans()),
                                inputs)

    def _blocks(self, lidar_feat, maps, gt_boxes, gt_labels, gt_valid,
                generator):
        """The forward in the blocks of ``_block_spans``: yields None after
        each block but the last, the output dict after the last."""
        cfg = self.cfg
        dt = cfg.tdtype
        dev = lidar_feat.device
        B, H, W, C = lidar_feat.shape
        ncls, S, P, HW = cfg.num_classes, cfg.total_stages, \
            cfg.num_proposals, H * W

        extra = maps[-1] if cfg.extra_feat else None
        stage_feats = list(maps[:len(maps) - int(cfg.extra_feat)])
        if cfg.reuse_first_heatmap:
            stage_feats = [lidar_feat] + stage_feats
        bev_pos = _bev_pos(H, W, 1.0, dev)
        dense_heatmap = self.heatmap_head(lidar_feat, dt)  # (B, H, W, ncls)

        acc_mask = torch.ones((B, ncls, H, W), device=dev)
        q_feats, q_pos, q_score, q_labels = [], [], [], []
        heatmaps, masks = [], []
        yield None

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
            heat = (torch.sigmoid(dh.permute(0, 3, 1, 2).detach())
                    * acc_mask)
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

            if cfg.mask_heatmap_mode == "boxcls":
                db = self.heatmap_box_head[str(i)](stage_feats[i], dt)
                sel = _boxcls_mask(
                    cfg, _gather_query_boxes(db, bev_pos, top_i, ncls, HW),
                    top_cls, bev_pos, top_i, (B, ncls, H, W))
            elif cfg.mask_heatmap_mode == "pos":
                sel = torch.zeros((B, HW), device=dev)
                sel.scatter_(1, top_p, 1.0)
                sel = sel.reshape(B, 1, H, W).expand(B, ncls, H, W)
            else:
                sel = torch.zeros((B, ncls * HW), device=dev)
                sel.scatter_(1, top_i, 1.0)
                sel = sel.reshape(B, ncls, H, W)
            acc_mask = acc_mask * (1.0 - _dilate_mask(
                sel, cfg.nms_kernel_size, cfg.kernel1_classes))
            yield None

        query_feat = torch.cat(q_feats, dim=1)  # (B, S*P, C)
        query_pos = torch.cat(q_pos, dim=1)
        query_score = torch.cat(q_score, dim=1)
        query_labels = torch.cat(q_labels, dim=1)
        num_prop = query_feat.shape[1]

        groups = None
        attn_mask = None
        if self.training and cfg.add_gt_groups > 0 and gt_boxes is not None:
            groups = self._gt_groups(gt_boxes, gt_labels, gt_valid, peaks,
                                     stage_feats[-1], bev_pos, generator)
            gqf, gqp, gqs, glab, gv = groups
            query_feat = torch.cat([query_feat, gqf], dim=1)
            query_pos = torch.cat([query_pos, gqp], dim=1)
            query_score = torch.cat([query_score, gqs], dim=1)
            query_labels = torch.cat([query_labels, glab], dim=1)
            # real queries see only real queries; a group query sees the
            # real ones and every valid group query
            Qn = query_feat.shape[1]
            attn_mask = torch.ones((B, Qn, Qn), dtype=torch.bool, device=dev)
            attn_mask[:, :, :num_prop] = False
            attn_mask[:, num_prop:, num_prop:] = ~(gv[:, :, None]
                                                   & gv[:, None, :])

        levels = [extra if cfg.extra_feat else stage_feats[-1]]
        level_pos = [_bev_pos(H, W, 1.0, dev)]
        if cfg.multiscale:
            levels.append(self.dconv(levels[-1], dt))
            levels.append(self.dconv2(levels[-1], dt))
            level_pos.append(_bev_pos(H // 2, W // 2, 2.0, dev))
            level_pos.append(_bev_pos(H // 4, W // 4, 4.0, dev))
        norm_wh = filled((W, H), dev)
        yield None

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
                y = self._roi_features(levels, query_box, dt, generator)
                query_feat = (query_feat + y).to(y.dtype)
            query_feat = self.decoder[r](query_feat, vals, ref, qpe, dt,
                                         attn_mask, generator)

            res = self.prediction_heads[r](query_feat, dt)
            if cfg.classaware_reg:
                res = _class_slices(res, query_labels, ncls)
            res["center"] = res["center"] + query_pos
            query_pos = res["center"].detach()
            if cfg.roi_based_reg and query_box is not None:
                res["dim"] = torch.cat(
                    [res["dim"][..., :2] + query_box[..., 3:5],
                     res["dim"][..., 2:]], dim=-1)
                res["rot"] = res["rot"] + query_box[..., 6:8]
            parts = [res["center"], res["height"], res["dim"], res["rot"]]
            if cfg.with_vel:
                parts.append(res["vel"])
            query_box = torch.cat(parts, dim=-1).detach()
            rounds.append(res)
            yield None

        out = {k: torch.stack([r[k] for r in rounds], dim=1)
               for k in rounds[0]}
        out["query_labels"] = query_labels
        out["query_heatmap_score"] = query_score
        out["dense_heatmap"] = torch.stack(heatmaps, dim=1)
        out["multistage_masks"] = torch.stack(
            [m.permute(0, 2, 3, 1) for m in masks], dim=1)
        if groups is not None:
            out["gt_valid_mask"] = groups[4]
            out["gt_query_labels"] = groups[3]
        yield out


def _class_slices(res: Dict[str, torch.Tensor], labels: torch.Tensor,
                  ncls: int) -> Dict[str, torch.Tensor]:
    """Class-aware regression (JAX ``focal_decoder.py:553-560``): each box
    head's (B, Q, ncls * d) output -> the d values of each query's label,
    clipped to [0, ncls - 1] (a background group query reads the last
    class)."""
    lab = labels.long().clamp(0, ncls - 1)
    out = dict(res)
    for k in ("center", "height", "dim", "rot", "vel"):
        if k in res:
            B, Q, n = res[k].shape
            d = n // ncls
            idx = lab[..., None, None].expand(B, Q, 1, d)
            out[k] = torch.gather(res[k].reshape(B, Q, ncls, d), 2,
                                  idx)[:, :, 0]
    return out


def get_bboxes(cfg: FocalDecoderConfig, out: Dict[str, torch.Tensor],
               max_out: int = 200) -> Dict[str, torch.Tensor]:
    """Final-round predictions -> fixed-size box lists: bboxes (B, Q, 9),
    scores, labels, and a mask with at most ``max_out`` entries per
    sample (no NMS, as the nuScenes default)."""
    num_prop = cfg.total_stages * cfg.num_proposals

    def last(x):
        return x[:, -1, :num_prop]

    with span("get_bboxes"):
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

"""Detection loss: Hungarian targets + focal / L1 / gaussian-focal terms.

Port of ``focalformer3d_tpu/training/losses.py``: per (sample, decoder
round) Hungarian assignment on the decoded, detached boxes (all problems of
a batch solved together, ``core/assigner.py``), the classification focal
loss over the matched labels, L1 box regression with code weights, the
dense heatmap gaussian-focal loss under the multistage masks, and the
denoising GT-group losses; per-round diagnostics as the JAX metrics.

Data parallel (``parallel/mesh.py``): every normaliser (``num_pos``, the
heatmap's and the GT groups' ``avg_factor``) counts the global batch, as
JAX's sums over its global batch axis; each rank's loss is its own
numerators over those denominators, so the global loss is the sum of the
ranks' losses.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..configs import FocalDecoderConfig
from ..core import assigner as assigner_lib
from ..core import box_coder as bc
from ..core import gaussian
from ..core import losses as L
from ..parallel import mesh


@dataclasses.dataclass(frozen=True)
class LossConfig:
    assigner: assigner_lib.AssignerConfig = dataclasses.field(
        default_factory=assigner_lib.AssignerConfig)
    code_weights: Tuple[float, ...] = (
        1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.2, 0.2)
    loss_cls_weight: float = 1.0
    loss_bbox_weight: float = 0.25
    loss_heatmap_weight: float = 1.0
    gt_query_loss_weight: float = 1.0
    gaussian_overlap: float = 0.1
    min_radius: int = 2


def _pred_vector(out, sl, with_vel: bool) -> torch.Tensor:
    keys = ("center", "height", "dim", "rot") + (("vel",) if with_vel else ())
    return torch.cat([out[k][sl] for k in keys], dim=-1)


def detection_loss(cfg: FocalDecoderConfig, lcfg: LossConfig,
                   out: Dict[str, torch.Tensor], gt_boxes: torch.Tensor,
                   gt_labels: torch.Tensor, gt_valid: torch.Tensor
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """out: the head's training output; gt_boxes (B, G, 9) world boxes
    (z bottom), gt_labels (B, G), gt_valid (B, G). Returns (total loss,
    metrics); metrics also carry ``assign_iterations``, the auction's loop
    count (one host sync each)."""
    coder = cfg.coder
    R = cfg.num_decoder_layers
    num_prop = cfg.total_stages * cfg.num_proposals
    B, G = gt_boxes.shape[:2]
    ncls = cfg.num_classes
    dev = gt_boxes.device
    cw = torch.tensor(lcfg.code_weights[:cfg.code_size], device=dev)
    real = (slice(None), slice(None), slice(0, num_prop))

    heat = out["heatmap"][real]
    with torch.no_grad():
        boxes_dec = bc.decode_box(
            coder, out["center"][real], out["height"][real],
            out["dim"][real], out["rot"][real],
            out["vel"][real] if cfg.with_vel else None)  # (B, R, Q, 7|9)
        gtb = gt_boxes[:, None].expand(B, R, G, gt_boxes.shape[-1])
        gtl = gt_labels[:, None].expand(B, R, G)
        res = assigner_lib.hungarian_assign_3d(
            lcfg.assigner, boxes_dec, heat.detach(), gtb, gtl,
            gt_valid[:, None].expand(B, R, G), cfg.pc_range)
        assigned = res["assigned_gt"]
        if cfg.gt_center_limit is not None:
            assigned = assigner_lib.apply_gt_center_limit(
                assigned, boxes_dec, gtb, cfg.gt_center_limit)
    overlaps = res["max_overlaps"]

    pos = assigned >= 0
    safe = assigned.clamp(0, G - 1).long()
    labels = torch.where(pos, torch.gather(gtl, -1, safe), ncls)
    gt_enc = bc.encode(coder, gt_boxes)  # (B, G, code)
    code = gt_enc.shape[-1]
    tgt = torch.gather(gt_enc[:, None].expand(B, R, G, code), 2,
                       safe[..., None].expand(*safe.shape, code))

    # dense heatmap targets under the multistage masks
    H, W = out["dense_heatmap"].shape[2:4]
    pcr = torch.tensor(cfg.pc_range, dtype=torch.float32, device=dev)
    vs = torch.tensor(cfg.voxel_size, dtype=torch.float32, device=dev)
    hm_t = torch.stack([
        gaussian.heatmap_targets(gt_boxes[b], gt_labels[b], gt_valid[b],
                                 ncls, pcr, vs, cfg.out_size_factor, (H, W),
                                 lcfg.gaussian_overlap, lcfg.min_radius)
        for b in range(B)])  # (B, ncls, H, W)
    masks = out["multistage_masks"]  # (B, S', H, W, ncls)
    hm_masked = hm_t.permute(0, 2, 3, 1)[:, None] * masks

    # the normalisers count the global batch, as JAX's sums over its
    # global batch axis: one collective of the raw counts, clamped after
    counts = mesh.all_reduce_(torch.stack([
        pos.sum(), (hm_masked == 1.0).sum(), gt_valid.sum()]), "loss")
    num_pos = torch.clamp(counts[0], min=1).float()

    loss_cls = L.sigmoid_focal_loss(
        heat.reshape(-1, ncls), labels.reshape(-1), None,
        avg_factor=num_pos, loss_weight=lcfg.loss_cls_weight)
    preds = _pred_vector(out, real, cfg.with_vel)
    box_w = pos[..., None].to(preds.dtype) * cw
    loss_bbox = L.l1_loss(preds, tgt, box_w, avg_factor=num_pos,
                          loss_weight=lcfg.loss_bbox_weight)

    # dense heatmap loss under the multistage masks
    loss_heatmap = L.gaussian_focal_loss(
        L.clip_sigmoid(out["dense_heatmap"]), hm_masked, masks,
        avg_factor=torch.clamp(counts[1], min=1).float(),
        loss_weight=lcfg.loss_heatmap_weight)

    metrics = {
        "loss_cls": loss_cls,
        "loss_bbox": loss_bbox,
        "loss_heatmap": loss_heatmap,
        "num_pos": num_pos,
        "matched_ious": torch.where(pos, overlaps, 0.0).sum() / num_pos,
    }
    for r in range(R):
        metrics[f"layer_{r}_loss_cls"] = L.sigmoid_focal_loss(
            heat[:, r].reshape(-1, ncls), labels[:, r].reshape(-1), None,
            avg_factor=num_pos, loss_weight=lcfg.loss_cls_weight)
        metrics[f"layer_{r}_loss_bbox"] = L.l1_loss(
            preds[:, r], tgt[:, r], box_w[:, r], avg_factor=num_pos,
            loss_weight=lcfg.loss_bbox_weight)
    total = loss_cls + loss_bbox + loss_heatmap

    # denoising GT-group losses
    if "gt_valid_mask" in out and cfg.add_gt_groups > 0:
        NGG = out["gt_valid_mask"].shape[1]  # NG * G
        NG = cfg.add_gt_groups
        grp = (slice(None), slice(None), slice(num_prop, None))
        gq_labels = out["gt_query_labels"][:, None].expand(B, R, NGG)
        gq_valid = out["gt_valid_mask"][:, None].expand(B, R, NGG)
        avg = torch.clamp(counts[2] * NG * R, min=1).float()
        gt_query_loss_cls = L.sigmoid_focal_loss(
            out["heatmap"][grp].reshape(-1, ncls), gq_labels.reshape(-1),
            gq_valid.reshape(-1).float(), avg_factor=avg,
            loss_weight=lcfg.gt_query_loss_weight)
        gq_preds = _pred_vector(out, grp, cfg.with_vel)
        gq_tgt = gt_enc.repeat(1, NG, 1)[:, None].expand(B, R, NGG, code)
        positive = (gq_labels != ncls) & gq_valid
        gt_query_loss_box = L.l1_loss(
            gq_preds, gq_tgt, positive[..., None].to(gq_preds.dtype) * cw,
            avg_factor=avg,
            loss_weight=lcfg.gt_query_loss_weight * lcfg.loss_bbox_weight)
        metrics["gt_query_loss_cls"] = gt_query_loss_cls
        metrics["gt_query_loss_box"] = gt_query_loss_box
        total = total + gt_query_loss_cls + gt_query_loss_box

    metrics["loss"] = total
    metrics["assign_iterations"] = res["iterations"]
    return total, metrics

"""The reference checkpoint's keys and their places in the JAX package's
flax variables, for the configs the port runs.

The port's own copy of ``focalformer3d_tpu.utils.ref_keys
.reference_state_shapes`` and of ``focalformer3d_tpu.utils.convert
.build_mapping`` with its ``t2f_*`` layout transforms, cut to the branches
the port has: the point branch with the mean VFEs or the Waymo configs'
``HardVFE`` (``pts_voxel_encoder.vfe_layers.{i}.linear`` / ``.norm`` ->
flax ``vfe/vfe_fc{i}`` / ``vfe/vfe_bn{i}``), the ResNet-50 + FPN image
branch, the LSS camera BEV or I2P (``shared_conv_img`` and the
``I2P_block``), the ``bevfusionmb2`` and ``bevfusion`` necks with their
camera blocks, and the head. ``tests/test_torch_imports.py`` holds both
against the JAX package's functions for every registered config: the same
keys, shapes, flax paths and transforms.

One departure: with ``classaware_reg`` (FocalFormer3D_Waymo15_L) the box
heads' output convs are ``num_classes`` times as wide, in the model of
either package, and here; JAX's ``reference_state_shapes`` lists them at
the class-agnostic width (a fault of the JAX package, ROADMAP.md Queue 3),
so its own bridge cannot load its own class-aware model.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

Shape = Tuple[int, ...]
Target = Tuple[str, Tuple[str, ...], Optional[Callable]]

# torch buffers that carry no learned state (recomputed by the models)
IGNORED = (
    r".*num_batches_tracked$",
    r"pts_bbox_head\.bev_pos$",
    r"imgpts_neck\.cam_lss\.frustum$",
    r"pts_bbox_head\.query_pos$",
)


def _check_ported(cfg) -> None:
    if (cfg.input_img and cfg.cam_proj not in ("lss", "i2p")) \
            or cfg.iterbev not in ("bevfusionmb2", "bevfusion"):
        raise NotImplementedError(
            "the weight bridge covers the LSS and I2P camera projections "
            "and the bevfusionmb2 and bevfusion necks")


# ---------------------------------------------------------------------------
# reference state-dict shapes
# ---------------------------------------------------------------------------

def _bn_shapes(d: Dict[str, Shape], prefix: str, c: int) -> None:
    d[f"{prefix}.weight"] = (c,)
    d[f"{prefix}.bias"] = (c,)
    d[f"{prefix}.running_mean"] = (c,)
    d[f"{prefix}.running_var"] = (c,)
    d[f"{prefix}.num_batches_tracked"] = ()


def _convmodule_shapes(d, prefix, cin, cout, k) -> None:
    """mmcv ConvModule: .conv (no bias) + .bn."""
    d[f"{prefix}.conv.weight"] = (cout, cin, k, k)
    _bn_shapes(d, f"{prefix}.bn", cout)


def _inverted_residual_shapes(d, prefix, cin, cout, expand) -> None:
    hidden = cin * expand
    if expand != 1:
        d[f"{prefix}.conv.0.0.weight"] = (hidden, cin, 1, 1)
        _bn_shapes(d, f"{prefix}.conv.0.1", hidden)
        d[f"{prefix}.conv.1.0.weight"] = (hidden, 1, 3, 3)
        _bn_shapes(d, f"{prefix}.conv.1.1", hidden)
        d[f"{prefix}.conv.2.weight"] = (cout, hidden, 1, 1)
        _bn_shapes(d, f"{prefix}.conv.3", cout)
    else:
        d[f"{prefix}.conv.0.0.weight"] = (hidden, 1, 3, 3)
        _bn_shapes(d, f"{prefix}.conv.0.1", hidden)
        d[f"{prefix}.conv.1.weight"] = (cout, hidden, 1, 1)
        _bn_shapes(d, f"{prefix}.conv.2", cout)


def _heatmap_head_shapes(d, prefix, hidden, num_classes) -> None:
    _convmodule_shapes(d, f"{prefix}.0", hidden, hidden, 3)
    d[f"{prefix}.1.weight"] = (num_classes, hidden, 3, 3)
    d[f"{prefix}.1.bias"] = (num_classes,)


def reference_state_shapes(cfg) -> Dict[str, Shape]:
    """cfg: a DetectorConfig the port runs. Returns {torch_key: shape} in
    the reference checkpoint's order."""
    _check_ported(cfg)
    d: Dict[str, Shape] = {}
    # the reference builds the point branch of a camera-only config too,
    # so its checkpoint carries those keys; the model has no such modules
    # (``absent``)
    _point_branch_shapes(d, cfg)
    if cfg.input_img:
        _image_branch_shapes(d, cfg)
    _neck_shapes(d, cfg)
    _head_shapes(d, cfg)
    return d


def _point_branch_shapes(d, cfg) -> None:
    enc = cfg.encoder_channels
    cin = 5
    if cfg.vfe_type == "HardVFE":
        # mmdet3d VFELayer: Linear (no bias) + BN1d, max over the slots
        for i, ch in enumerate(cfg.vfe_channels):
            d[f"pts_voxel_encoder.vfe_layers.{i}.linear.weight"] = (ch, cin)
            _bn_shapes(d, f"pts_voxel_encoder.vfe_layers.{i}.norm", ch)
            cin = ch
    # pts_middle_encoder (SparseEncoder, basicblock)
    base = enc[0][0]
    d["pts_middle_encoder.conv_input.0.weight"] = (3, 3, 3, cin, base)
    _bn_shapes(d, "pts_middle_encoder.conv_input.1", base)
    c = base
    for s, blocks in enumerate(enc):
        for j, out in enumerate(blocks):
            p = f"pts_middle_encoder.encoder_layers.encoder_layer{s + 1}.{j}"
            if j == len(blocks) - 1 and s != len(enc) - 1:
                d[f"{p}.0.weight"] = (3, 3, 3, c, out)
                _bn_shapes(d, f"{p}.1", out)
            else:
                d[f"{p}.conv1.weight"] = (3, 3, 3, out, out)
                _bn_shapes(d, f"{p}.bn1", out)
                d[f"{p}.conv2.weight"] = (3, 3, 3, out, out)
                _bn_shapes(d, f"{p}.bn2", out)
            c = out
    d["pts_middle_encoder.conv_out.0.weight"] = (
        3, 1, 1, c, cfg.sparse_out_channels)
    _bn_shapes(d, "pts_middle_encoder.conv_out.1", cfg.sparse_out_channels)

    # SECOND backbone: z planes left after the strided chain and conv_out
    z = cfg.sparse_shape[0]
    for s in range(len(enc) - 1):
        z = (z + 2 * cfg.down_paddings[s][0] - 3) // 2 + 1
    z = (z - 3) // 2 + 1
    sec_in = cfg.sparse_out_channels * z
    for i, out in enumerate(cfg.second_channels):
        block_in = sec_in if i == 0 else cfg.second_channels[i - 1]
        for k in range(cfg.second_layers[i] + 1):
            ci = block_in if k == 0 else out
            d[f"pts_backbone.blocks.{i}.{3 * k}.weight"] = (out, ci, 3, 3)
            _bn_shapes(d, f"pts_backbone.blocks.{i}.{3 * k + 1}", out)

    # SECONDFPN: stride 1 -> 1x1 conv, 2 -> ConvTranspose2d (I, O, kH, kW)
    for i, out in enumerate(cfg.fpn_channels):
        cin_i = cfg.second_channels[i]
        if i == 0:
            d[f"pts_neck.deblocks.{i}.0.weight"] = (out, cin_i, 1, 1)
        else:
            d[f"pts_neck.deblocks.{i}.0.weight"] = (cin_i, out, 2, 2)
        _bn_shapes(d, f"pts_neck.deblocks.{i}.1", out)



def _image_branch_shapes(d, cfg) -> None:
    """mmdet ResNet-50 (the reference keys exist for depth 50 only) and
    FPN (lateral and output convs with bias)."""
    d["img_backbone.conv1.weight"] = (64, 3, 7, 7)
    _bn_shapes(d, "img_backbone.bn1", 64)
    stage_blocks = {50: (3, 4, 6, 3)}[cfg.img_backbone_depth]
    rc = 64
    for s, nb in enumerate(stage_blocks):
        w = 64 * (2 ** s)
        for i in range(nb):
            p = f"img_backbone.layer{s + 1}.{i}"
            ci = rc if i == 0 else 4 * w
            d[f"{p}.conv1.weight"] = (w, ci, 1, 1)
            _bn_shapes(d, f"{p}.bn1", w)
            d[f"{p}.conv2.weight"] = (w, w, 3, 3)
            _bn_shapes(d, f"{p}.bn2", w)
            d[f"{p}.conv3.weight"] = (4 * w, w, 1, 1)
            _bn_shapes(d, f"{p}.bn3", 4 * w)
            if i == 0:
                d[f"{p}.downsample.0.weight"] = (4 * w, ci, 1, 1)
                _bn_shapes(d, f"{p}.downsample.1", 4 * w)
        rc = 4 * w
    for i, ci in enumerate((256, 512, 1024, 2048)):
        d[f"img_neck.lateral_convs.{i}.conv.weight"] = (256, ci, 1, 1)
        d[f"img_neck.lateral_convs.{i}.conv.bias"] = (256,)
        d[f"img_neck.fpn_convs.{i}.conv.weight"] = (256, 256, 3, 3)
        d[f"img_neck.fpn_convs.{i}.conv.bias"] = (256,)


def _neck_shapes(d, cfg) -> None:
    """FocalEncoder: shared_conv_pts, the LSS or shared_conv_img, the fusion
    blocks (I2P's learnedAlign where a layer projects the cameras,
    bevfusionmb2 or bevfusion, the camera BEV's iterimg_conv) and
    extra_output."""
    h = cfg.decoder.hidden
    if cfg.input_pts:
        d["imgpts_neck.shared_conv_pts.weight"] = (
            h, sum(cfg.fpn_channels), 3, 3)
        d["imgpts_neck.shared_conv_pts.bias"] = (h,)
    if cfg.input_img and cfg.cam_proj == "lss":
        lss = cfg.lss
        d["imgpts_neck.cam_lss.frustum"] = (lss.depth_bins, *lss.feat_hw, 3)
        d["imgpts_neck.cam_lss.camencode.depthnet.weight"] = (
            lss.depth_bins + lss.cam_channels, lss.input_channels, 1, 1)
        d["imgpts_neck.cam_lss.camencode.depthnet.bias"] = (
            lss.depth_bins + lss.cam_channels,)
        cz = lss.cam_channels * lss.nx[2]
        chans = [(cz, cz), (cz, 512), (512, 512), (512, lss.out_channels)]
        for k, (ci, co) in enumerate(chans):
            d[f"imgpts_neck.cam_lss.bevencode.{3 * k}.weight"] = (
                co, ci, 3, 3)
            _bn_shapes(d, f"imgpts_neck.cam_lss.bevencode.{3 * k + 1}", co)
    i2p = cfg.input_img and cfg.cam_proj == "i2p"
    if i2p:  # 3x3 conv of FPN level 0 (256 channels) to the hidden width
        d["imgpts_neck.shared_conv_img.weight"] = (h, 256, 3, 3)
        d["imgpts_neck.shared_conv_img.bias"] = (h,)
    for i in range(cfg.neck_layers):
        p = f"imgpts_neck.fusion_blocks.{i}"
        if i2p and (not cfg.iter_bev_cam or i == 0):
            # one-head attention: {q,k,v}_proj_weight, a fused in_proj_bias
            la = f"{p}.I2P_block.learnedAlign"
            for n in ("q", "k", "v"):
                d[f"{la}.{n}_proj_weight"] = (h, h)
            d[f"{la}.in_proj_bias"] = (3 * h,)
            d[f"{la}.out_proj.weight"] = (h, h)
            d[f"{la}.out_proj.bias"] = (h,)
        if cfg.iterbev == "bevfusionmb2":
            _inverted_residual_shapes(d, f"{p}.P_IML", h, h, 2)
            _inverted_residual_shapes(d, f"{p}.P_out_proj", 2 * h, h, 1)
            _inverted_residual_shapes(d, f"{p}.P_integration", 2 * h, h, 1)
        else:
            for j in range(2):
                _convmodule_shapes(d, f"{p}.P_IML.query_project.{j}", h, h, 1)
                _convmodule_shapes(d, f"{p}.P_IML.key_project.{j}", h, h, 1)
            _convmodule_shapes(d, f"{p}.P_IML.value_project", h, h, 1)
            _convmodule_shapes(d, f"{p}.P_out_proj", 2 * h, h, 1)
            _convmodule_shapes(d, f"{p}.P_integration", 2 * h, h, 1)
        if cfg.input_img:  # iterimg_conv = Sequential(resnet.BasicBlock)
            d[f"{p}.iterimg_conv.0.conv1.weight"] = (h, h, 3, 3)
            _bn_shapes(d, f"{p}.iterimg_conv.0.bn1", h)
            d[f"{p}.iterimg_conv.0.conv2.weight"] = (h, h, 3, 3)
            _bn_shapes(d, f"{p}.iterimg_conv.0.bn2", h)
    if cfg.extra_feat:
        _convmodule_shapes(d, "imgpts_neck.extra_output", h, h, 3)


def _head_shapes(d, cfg) -> None:
    dec = cfg.decoder
    h = dec.hidden
    ncls = dec.num_classes
    hb = "pts_bbox_head"
    _heatmap_head_shapes(d, f"{hb}.heatmap_head", h, ncls)
    n_stages = dec.multistage_heatmap + (1 if dec.reuse_first_heatmap else 0)
    start = 1 if dec.reuse_first_heatmap else 0
    for i in range(start, n_stages):
        _heatmap_head_shapes(d, f"{hb}.heatmap_head_img.{i}", h, ncls)
    d[f"{hb}.class_encoding.weight"] = (h, ncls, 1)
    d[f"{hb}.class_encoding.bias"] = (h,)
    if dec.multiscale:
        _convmodule_shapes(d, f"{hb}.dconv", h, h, 3)
        _convmodule_shapes(d, f"{hb}.dconv2", h, h, 3)
    nH, L, P = dec.num_heads, 3 if dec.multiscale else 1, 4
    for i in range(dec.num_decoder_layers):
        for l in range(dec.inner_layers):
            p = f"{hb}.decoder.{i}.layers.{l}"
            d[f"{p}.attentions.0.attn.in_proj_weight"] = (3 * h, h)
            d[f"{p}.attentions.0.attn.in_proj_bias"] = (3 * h,)
            d[f"{p}.attentions.0.attn.out_proj.weight"] = (h, h)
            d[f"{p}.attentions.0.attn.out_proj.bias"] = (h,)
            d[f"{p}.attentions.1.sampling_offsets.weight"] = (
                nH * L * P * 2, h)
            d[f"{p}.attentions.1.sampling_offsets.bias"] = (nH * L * P * 2,)
            d[f"{p}.attentions.1.attention_weights.weight"] = (nH * L * P, h)
            d[f"{p}.attentions.1.attention_weights.bias"] = (nH * L * P,)
            d[f"{p}.attentions.1.value_proj.weight"] = (h, h)
            d[f"{p}.attentions.1.value_proj.bias"] = (h,)
            d[f"{p}.attentions.1.output_proj.weight"] = (h, h)
            d[f"{p}.attentions.1.output_proj.bias"] = (h,)
            d[f"{p}.ffns.0.layers.0.0.weight"] = (1024, h)
            d[f"{p}.ffns.0.layers.0.0.bias"] = (1024,)
            d[f"{p}.ffns.0.layers.1.weight"] = (h, 1024)
            d[f"{p}.ffns.0.layers.1.bias"] = (h,)
            for n in range(3):
                d[f"{p}.norms.{n}.weight"] = (h,)
                d[f"{p}.norms.{n}.bias"] = (h,)
        d[f"{hb}.pos_embed_learned.{i}.layers.0.weight"] = (h, 256)
        d[f"{hb}.pos_embed_learned.{i}.layers.0.bias"] = (h,)
        d[f"{hb}.pos_embed_learned.{i}.layers.1.weight"] = (h, h)
        d[f"{hb}.pos_embed_learned.{i}.layers.1.bias"] = (h,)
        heads = {"center": 2, "height": 1, "dim": 3, "rot": 2}
        if dec.code_size == 10:
            heads["vel"] = 2
        if dec.classaware_reg:
            heads = {k: w * ncls for k, w in heads.items()}
        heads["heatmap"] = ncls
        for head, out in heads.items():
            p = f"{hb}.prediction_heads.{i}.{head}"
            d[f"{p}.0.conv.weight"] = (64, h, 1)
            _bn_shapes(d, f"{p}.0.bn", 64)
            d[f"{p}.1.weight"] = (out, 64, 1)
            d[f"{p}.1.bias"] = (out,)
    if dec.roi_feats:
        pre = dec.roi_feats ** 2 * h * (3 if dec.multiscale else 1)
        for layer in range(3):
            out = dec.hidden_roi if layer < 2 else h
            d[f"{hb}.roi_mlp.{4 * layer}.weight"] = (out, pre)
            _bn_shapes(d, f"{hb}.roi_mlp.{4 * layer + 1}", out)
            pre = out
    d[f"{hb}.bev_pos"] = (1, 32400, 2)


# ---------------------------------------------------------------------------
# layout transforms (torch layout -> flax layout)
# ---------------------------------------------------------------------------

def t2f_conv(w):  # (O, I[/g], kH, kW) -> (kH, kW, I[/g], O)
    return np.transpose(w, (2, 3, 1, 0))


def t2f_deconv(w):
    """ConvTranspose2d (I, O, kH, kW) -> flax HWIO, spatially flipped."""
    return np.transpose(w, (2, 3, 0, 1))[::-1, ::-1]


def t2f_linear(w):  # (O, I) -> (I, O)
    return np.transpose(w)


def t2f_conv1d(w):  # (O, I, 1) -> (I, O)
    return np.transpose(w[..., 0])


def t2f_spconv(w):  # (kz, ky, kx, I, O) -> (K, I, O), dz-major taps
    return np.reshape(w, (-1, w.shape[-2], w.shape[-1]))


def _split3(a):
    """Slice ``a`` of the packed (q, k, v) rows of an in-projection."""
    return lambda w: w[a * (w.shape[0] // 3):(a + 1) * (w.shape[0] // 3)]


def _split3_t(a):
    return lambda w: np.transpose(w[a * w.shape[1]:(a + 1) * w.shape[1]])


# ---------------------------------------------------------------------------
# key -> flax path mapping
# ---------------------------------------------------------------------------

POINT_BRANCH = ("pts_voxel_encoder.", "pts_middle_encoder.", "pts_backbone.",
                "pts_neck.")


def absent(cfg, key: str) -> bool:
    """True for a key of a branch the config's model does not build: the
    point branch of a camera-only config (JAX's ``convert_tree`` skips
    these as ``skipped_absent``)."""
    return not cfg.input_pts and key.startswith(POINT_BRANCH)


def is_ignored(key: str) -> bool:
    return any(re.fullmatch(p, key) for p in IGNORED)


def _bn(prefix: Tuple[str, ...], leaf: str) -> Optional[Target]:
    """One torch BatchNorm leaf -> a flax BatchNorm at ``prefix``."""
    return {
        "weight": ("params", prefix + ("scale",), None),
        "bias": ("params", prefix + ("bias",), None),
        "running_mean": ("batch_stats", prefix + ("mean",), None),
        "running_var": ("batch_stats", prefix + ("var",), None),
    }.get(leaf)


def _set_bn(m, tk, prefix, leaf) -> None:
    t = _bn(prefix, leaf)
    if t:
        m[tk] = [t]


def _kb(leaf: str) -> str:
    return "kernel" if leaf == "weight" else "bias"


def _convbn(m, tkey: str, tprefix: str, fprefix: Tuple[str, ...]) -> bool:
    """mmcv ConvModule ('.conv' + '.bn') -> flax ConvBN (Conv_0 +
    BatchNorm_0)."""
    g = re.fullmatch(rf"{re.escape(tprefix)}\.conv\.(weight|bias)", tkey)
    if g:
        leaf = g.group(1)
        m[tkey] = [("params", fprefix + ("Conv_0", _kb(leaf)),
                    t2f_conv if leaf == "weight" else None)]
        return True
    g = re.fullmatch(
        rf"{re.escape(tprefix)}\.bn\.(weight|bias|running_mean|running_var)",
        tkey)
    if g:
        _set_bn(m, tkey, fprefix + ("BatchNorm_0",), g.group(1))
        return True
    return False


def _inverted_residual(m, tkey: str, tprefix: str,
                       fprefix: Tuple[str, ...], ndim: int) -> bool:
    """torchvision InvertedResidual -> flax InvertedResidual (Conv_i /
    BatchNorm_i in creation order); the expand / no-expand layouts differ
    only in the torch indices present."""
    g = re.fullmatch(
        rf"{re.escape(tprefix)}\.conv\.(\d)(?:\.(\d))?\."
        r"(weight|bias|running_mean|running_var)", tkey)
    if not g:
        return False
    a, b, leaf = int(g.group(1)), g.group(2), g.group(3)
    if b is not None:  # ConvBNReLU sub-Sequential: .0 conv, .1 bn
        if int(b) == 0 and leaf == "weight":
            m[tkey] = [("params", fprefix + (f"Conv_{a}", "kernel"),
                        t2f_conv)]
        else:
            _set_bn(m, tkey, fprefix + (f"BatchNorm_{a}",), leaf)
    elif leaf == "weight" and ndim == 4:  # project conv
        m[tkey] = [("params", fprefix + (f"Conv_{a}", "kernel"), t2f_conv)]
    else:  # project bn
        _set_bn(m, tkey, fprefix + (f"BatchNorm_{a - 1}",), leaf)
    return True


def _encoder_target(m, tk) -> bool:
    """pts_voxel_encoder, pts_backbone, pts_neck and pts_middle_encoder
    keys."""
    g = re.fullmatch(r"pts_voxel_encoder\.vfe_layers\.(\d)\.(linear\.weight|"
                     r"norm\.(?:weight|bias|running_mean|running_var))", tk)
    if g:
        i, rest = int(g.group(1)), g.group(2)
        if rest == "linear.weight":
            m[tk] = [("params", ("vfe", f"vfe_fc{i}", "kernel"), t2f_linear)]
        else:
            _set_bn(m, tk, ("vfe", f"vfe_bn{i}"), rest.split(".")[1])
        return True
    g = re.fullmatch(r"pts_backbone\.blocks\.(\d)\.(\d+)\.(weight|bias|"
                     r"running_mean|running_var)", tk)
    if g:
        i, j, leaf = int(g.group(1)), int(g.group(2)), g.group(3)
        conv_idx, rem = divmod(j, 3)
        name = ("pts_backbone", f"block{i}_conv{conv_idx}")
        if rem == 0 and leaf == "weight":
            m[tk] = [("params", name + ("Conv_0", "kernel"), t2f_conv)]
        elif rem == 1:
            _set_bn(m, tk, name + ("BatchNorm_0",), leaf)
        return True
    g = re.fullmatch(r"pts_neck\.deblocks\.(\d)\.(\d)\.(weight|bias|"
                     r"running_mean|running_var)", tk)
    if g:
        i, j, leaf = int(g.group(1)), int(g.group(2)), g.group(3)
        if j == 0 and leaf == "weight":
            m[tk] = [
                ("params", ("pts_neck", f"deblock{i}_conv", "kernel"),
                 t2f_conv),
                ("params", ("pts_neck", f"deblock{i}_deconv", "kernel"),
                 t2f_deconv),
            ]
        elif j == 1:
            _set_bn(m, tk, ("pts_neck", f"deblock{i}_bn"), leaf)
        return True
    g = re.fullmatch(r"pts_middle_encoder\.(conv_input|conv_out)\.(\d)\."
                     r"(weight|bias|running_mean|running_var)", tk)
    if g:
        name, j, leaf = g.group(1), int(g.group(2)), g.group(3)
        if j == 0 and leaf == "weight":
            m[tk] = [("params", ("pts_middle_encoder", name, "w"),
                      t2f_spconv)]
        elif j == 1:
            _set_bn(m, tk, ("pts_middle_encoder", name, "MaskedBatchNorm_0"),
                    leaf)
        return True
    g = re.fullmatch(r"pts_middle_encoder\.encoder_layers\.encoder_layer(\d)"
                     r"\.(\d)\.(conv|bn)(\d)\.(weight|bias|running_mean|"
                     r"running_var)", tk)
    if g:
        s, j = int(g.group(1)) - 1, int(g.group(2))
        kind, n, leaf = g.group(3), int(g.group(4)) - 1, g.group(5)
        base = ("pts_middle_encoder", f"stage{s}_block{j}", f"conv{n}")
        if kind == "conv" and leaf == "weight":
            m[tk] = [("params", base + ("w",), t2f_spconv)]
        elif kind == "bn":
            _set_bn(m, tk, base + ("MaskedBatchNorm_0",), leaf)
        return True
    g = re.fullmatch(r"pts_middle_encoder\.encoder_layers\.encoder_layer(\d)"
                     r"\.(\d)\.(\d)\.(weight|bias|running_mean|running_var)",
                     tk)
    if g:
        s = int(g.group(1)) - 1
        j, leaf = int(g.group(3)), g.group(4)
        base = ("pts_middle_encoder", f"down{s}")
        if j == 0 and leaf == "weight":
            m[tk] = [("params", base + ("w",), t2f_spconv)]
        elif j == 1:
            _set_bn(m, tk, base + ("MaskedBatchNorm_0",), leaf)
        return True
    return False


def _image_target(m, tk) -> bool:
    """img_backbone (ResNet) and img_neck (FPN) keys."""
    g = re.fullmatch(r"img_backbone\.conv1\.weight", tk)
    if g:
        m[tk] = [("params", ("img_backbone", "conv1", "kernel"), t2f_conv)]
        return True
    g = re.fullmatch(r"img_backbone\.bn1\.(weight|bias|running_mean|"
                     r"running_var)", tk)
    if g:
        _set_bn(m, tk, ("img_backbone", "bn1", "BatchNorm_0"), g.group(1))
        return True
    g = re.fullmatch(r"img_backbone\.layer(\d)\.(\d+)\.conv(\d)\.weight", tk)
    if g:
        s, i, n = g.groups()
        m[tk] = [("params", ("img_backbone", f"layer{s}_{i}", f"conv{n}",
                             "kernel"), t2f_conv)]
        return True
    g = re.fullmatch(r"img_backbone\.layer(\d)\.(\d+)\.bn(\d)\.(weight|bias|"
                     r"running_mean|running_var)", tk)
    if g:
        s, i, n, leaf = g.groups()
        _set_bn(m, tk, ("img_backbone", f"layer{s}_{i}", f"bn{n}",
                        "BatchNorm_0"), leaf)
        return True
    g = re.fullmatch(r"img_backbone\.layer(\d)\.(\d+)\.downsample\.(\d)\."
                     r"(weight|bias|running_mean|running_var)", tk)
    if g:
        s, i, j, leaf = g.group(1), g.group(2), int(g.group(3)), g.group(4)
        base = ("img_backbone", f"layer{s}_{i}")
        if j == 0 and leaf == "weight":
            m[tk] = [("params", base + ("ds_conv", "kernel"), t2f_conv)]
        else:
            _set_bn(m, tk, base + ("ds_bn", "BatchNorm_0"), leaf)
        return True
    g = re.fullmatch(r"img_neck\.(lateral_convs|fpn_convs)\.(\d)\.conv\."
                     r"(weight|bias)", tk)
    if g:
        kind, i, leaf = g.groups()
        name = f"lateral{i}" if kind == "lateral_convs" else f"fpn_conv{i}"
        m[tk] = [("params", ("img_neck", name, _kb(leaf)),
                  t2f_conv if leaf == "weight" else None)]
        return True
    return False


def _i2p_target(m, tk, fb, rest) -> bool:
    """A fusion block's I2P keys: the reference's one-head attention
    stores {q,k,v}_proj_weight and one fused in_proj_bias (thirds q, k, v);
    flax has four Dense layers (``models/i2p.py``)."""
    g = re.fullmatch(r"I2P_block\.learnedAlign\.(q|k|v)_proj_weight", rest)
    if g:
        m[tk] = [("params", fb + ("I2P_block", f"{g.group(1)}_proj",
                                  "kernel"), t2f_linear)]
        return True
    if rest == "I2P_block.learnedAlign.in_proj_bias":
        m[tk] = [("params", fb + ("I2P_block", f"{n}_proj", "bias"),
                  lambda b, a=a: b[a * (b.shape[0] // 3):
                                   (a + 1) * (b.shape[0] // 3)])
                 for a, n in enumerate(("q", "k", "v"))]
        return True
    g = re.fullmatch(r"I2P_block\.learnedAlign\.out_proj\.(weight|bias)",
                     rest)
    if g:
        leaf = g.group(1)
        m[tk] = [("params", fb + ("I2P_block", "out_proj", _kb(leaf)),
                  t2f_linear if leaf == "weight" else None)]
        return True
    return False


def _neck_target(m, tk, shapes) -> bool:
    """imgpts_neck keys: shared_conv_pts / shared_conv_img, extra_output,
    the LSS and the fusion blocks of either neck (with I2P's)."""
    g = re.fullmatch(r"imgpts_neck\.(shared_conv_pts|shared_conv_img)\."
                     r"(weight|bias)", tk)
    if g:
        name, leaf = g.group(1), g.group(2)
        m[tk] = [("params", ("imgpts_neck", name, _kb(leaf)),
                  t2f_conv if leaf == "weight" else None)]
        return True
    if _convbn(m, tk, "imgpts_neck.extra_output",
               ("imgpts_neck", "extra_output")):
        return True
    g = re.fullmatch(
        r"imgpts_neck\.cam_lss\.camencode\.depthnet\.(weight|bias)", tk)
    if g:
        leaf = g.group(1)
        m[tk] = [("params", ("imgpts_neck", "cam_lss", "camencode",
                             "depthnet", _kb(leaf)),
                  t2f_conv if leaf == "weight" else None)]
        return True
    g = re.fullmatch(r"imgpts_neck\.cam_lss\.bevencode\.(\d+)\.(weight|bias|"
                     r"running_mean|running_var)", tk)
    if g:
        conv_idx, rem = divmod(int(g.group(1)), 3)
        leaf = g.group(2)
        base = ("imgpts_neck", "cam_lss", "bevencode")
        if rem == 0 and leaf == "weight":
            m[tk] = [("params", base + (f"conv{conv_idx}", "kernel"),
                      t2f_conv)]
        elif rem == 1:
            _set_bn(m, tk, base + (f"bn{conv_idx}",), leaf)
        return True
    g = re.match(r"imgpts_neck\.fusion_blocks\.(\d)\.(.+)", tk)
    if not g:
        return False
    i, rest = g.group(1), g.group(2)
    fb = ("imgpts_neck", f"fusion{i}")
    tb = f"imgpts_neck.fusion_blocks.{i}"
    for mod in ("P_IML", "P_out_proj", "P_integration"):
        if rest.startswith(f"{mod}.conv.") and _inverted_residual(
                m, tk, f"{tb}.{mod}", fb + (mod,), len(shapes[tk])):
            return True  # bevfusionmb2
    g2 = re.fullmatch(r"P_IML\.(query|key)_project\.(\d)\..+", rest)
    if g2:  # bevfusion LocalContextBlock projections
        name = ("q_proj" if g2.group(1) == "query" else "k_proj") \
            + g2.group(2)
        _convbn(m, tk, f"{tb}.P_IML.{g2.group(1)}_project.{g2.group(2)}",
                fb + ("P_IML", name))
        return True
    if _convbn(m, tk, f"{tb}.P_IML.value_project", fb + ("P_IML", "v_proj")):
        return True
    for mod in ("P_out_proj", "P_integration"):  # bevfusion ConvBN
        if _convbn(m, tk, f"{tb}.{mod}", fb + (mod,)):
            return True
    if _i2p_target(m, tk, fb, rest):
        return True
    g2 = re.fullmatch(r"iterimg_conv\.0\.(conv|bn)(\d)\.(weight|bias|"
                      r"running_mean|running_var)", rest)
    if g2:  # Sequential(resnet.BasicBlock) -> BasicBlock2d's two ConvBN
        kind, n, leaf = g2.group(1), int(g2.group(2)) - 1, g2.group(3)
        base = fb + ("iterimg", f"ConvBN_{n}")
        if kind == "conv" and leaf == "weight":
            m[tk] = [("params", base + ("Conv_0", "kernel"), t2f_conv)]
        else:
            _set_bn(m, tk, base + ("BatchNorm_0",), leaf)
    return True


def _head_target(m, tk) -> bool:
    """pts_bbox_head keys."""
    if not tk.startswith("pts_bbox_head."):
        return False
    rest = tk[len("pts_bbox_head."):]
    hb = ("pts_bbox_head",)
    g = re.fullmatch(
        r"(heatmap_head|heatmap_head_img\.(\d))\.(\d)\.(?:(conv|bn)\.)?"
        r"(weight|bias|running_mean|running_var)", rest)
    if g:
        img_i, j, kind, leaf = g.group(2), int(g.group(3)), g.group(4), \
            g.group(5)
        name = ("heatmap_head" if img_i is None
                else f"heatmap_head_img{img_i}")
        if j == 0 and kind == "conv" and leaf == "weight":
            m[tk] = [("params", hb + (name, "ConvBN_0", "Conv_0", "kernel"),
                      t2f_conv)]
        elif j == 0 and kind == "bn":
            _set_bn(m, tk, hb + (name, "ConvBN_0", "BatchNorm_0"), leaf)
        elif j == 1 and kind is None:
            m[tk] = [("params", hb + (name, "Conv_0", _kb(leaf)),
                      t2f_conv if leaf == "weight" else None)]
        return True
    g = re.fullmatch(r"class_encoding\.(weight|bias)", rest)
    if g:
        leaf = g.group(1)
        m[tk] = [("params", hb + ("class_encoding", _kb(leaf)),
                  t2f_conv1d if leaf == "weight" else None)]
        return True
    for name in ("dconv", "dconv2"):
        if _convbn(m, tk, f"pts_bbox_head.{name}", hb + (name,)):
            return True
    g = re.fullmatch(r"decoder\.(\d)\.layers\.(\d)\.(.+)", rest)
    if g:
        lb = hb + (f"decoder{g.group(1)}", f"layer{g.group(2)}")
        sub = g.group(3)
        qkv = ("q", "k", "v")
        if sub == "attentions.0.attn.in_proj_weight":
            m[tk] = [("params", lb + ("self_attn", n, "kernel"), _split3_t(a))
                     for a, n in enumerate(qkv)]
        elif sub == "attentions.0.attn.in_proj_bias":
            m[tk] = [("params", lb + ("self_attn", n, "bias"), _split3(a))
                     for a, n in enumerate(qkv)]
        elif sub.startswith("attentions.0.attn.out_proj."):
            leaf = sub.rsplit(".", 1)[1]
            m[tk] = [("params", lb + ("self_attn", "out", _kb(leaf)),
                      t2f_linear if leaf == "weight" else None)]
        else:
            g2 = re.fullmatch(r"attentions\.1\.(sampling_offsets|"
                              r"attention_weights|value_proj|output_proj)\."
                              r"(weight|bias)", sub)
            g3 = re.fullmatch(r"norms\.(\d)\.(weight|bias)", sub)
            g4 = re.fullmatch(r"ffns\.0\.layers\.(0\.0|1)\.(weight|bias)",
                              sub)
            if g2:
                leaf = g2.group(2)
                m[tk] = [("params", lb + ("cross_attn", g2.group(1),
                                          _kb(leaf)),
                          t2f_linear if leaf == "weight" else None)]
            elif g3:
                leaf = g3.group(2)
                m[tk] = [("params", lb + (f"norm{int(g3.group(1)) + 1}",
                                          "scale" if leaf == "weight"
                                          else "bias"), None)]
            elif g4:
                name = "ffn1" if g4.group(1) == "0.0" else "ffn2"
                leaf = g4.group(2)
                m[tk] = [("params", lb + (name, _kb(leaf)),
                          t2f_linear if leaf == "weight" else None)]
        return True
    g = re.fullmatch(
        r"pos_embed_learned\.(\d)\.layers\.(\d)\.(weight|bias)", rest)
    if g:
        leaf = g.group(3)
        m[tk] = [("params", hb + (f"pos_embed{g.group(1)}",
                                  f"Dense_{g.group(2)}", _kb(leaf)),
                  t2f_linear if leaf == "weight" else None)]
        return True
    g = re.fullmatch(r"prediction_heads\.(\d)\.(\w+)\.(\d)\.(?:(conv|bn)\.)?"
                     r"(weight|bias|running_mean|running_var)", rest)
    if g:
        i, head, j = g.group(1), g.group(2), int(g.group(3))
        kind, leaf = g.group(4), g.group(5)
        pb = hb + (f"pred{i}",)
        if j == 0 and kind == "conv" and leaf == "weight":
            m[tk] = [("params", pb + (f"{head}_fc0", "kernel"), t2f_conv1d)]
        elif j == 0 and kind == "bn":
            _set_bn(m, tk, pb + (f"{head}_bn0",), leaf)
        elif j == 1 and kind is None:
            m[tk] = [("params", pb + (f"{head}_out", _kb(leaf)),
                      t2f_conv1d if leaf == "weight" else None)]
        return True
    g = re.fullmatch(r"roi_mlp\.(\d+)\.(weight|bias|running_mean|"
                     r"running_var)", rest)
    if g:
        layer, rem = divmod(int(g.group(1)), 4)
        leaf = g.group(2)
        if rem == 0 and leaf == "weight":
            m[tk] = [("params", hb + (f"roi_mlp_{layer}", "kernel"),
                      t2f_linear)]
        elif rem == 1:
            _set_bn(m, tk, hb + (f"roi_bn_{layer}",), leaf)
    return True


def build_mapping(shapes: Dict[str, Shape]) -> Dict[str, List[Target]]:
    """{torch_key: [(collection, flax_path, transform), ...]} for
    {torch_key: shape} of a model the port runs. Multi-target entries are
    the in-projection split (q/k/v) and the SECONDFPN conv-or-deconv
    choice."""
    m: Dict[str, List[Target]] = {}
    for tk in shapes:
        if not is_ignored(tk):
            (_encoder_target(m, tk) or _image_target(m, tk)
             or _neck_target(m, tk, shapes) or _head_target(m, tk))
    return m

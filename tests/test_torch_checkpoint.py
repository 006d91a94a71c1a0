"""The port's checkpoints: every case of ``tests/test_checkpoint.py`` on
``focalformer3d_tpu_torch.training.checkpoint`` (save / restore round trip,
``keep_last`` retention, auto-resume, partial image-branch load, freeze
masks that follow the flags: the JAX test's float multipliers are
``trainable_mask`` as 0 / 1), on a small module whose parameter names are
the reference keys the JAX test's flax paths stand for; plus what the
port's format adds: the files load with ``torch.load(weights_only=True)``,
the optimizer state is keyed by parameter name, and a partial load is
shape-checked and non-strict."""
import numpy as np
import pytest
import torch
from torch import nn

from focalformer3d_tpu_torch.configs import DetectorConfig
from focalformer3d_tpu_torch.training import checkpoint as ckpt
from focalformer3d_tpu_torch.training import optim
from focalformer3d_tpu_torch.training.train_step import trainable_mask


def _leaf(*shape, rng):
    return nn.Parameter(torch.from_numpy(
        rng.randn(*shape).astype(np.float32)))


class _Net(nn.Module):
    """img_backbone.conv1.weight, pts_backbone.block0.weight,
    imgpts_neck.cam_lss.w, imgpts_neck.shared_conv_pts.weight and a
    batch-norm buffer, as the JAX test's tree."""

    def __init__(self, seed):
        super().__init__()
        rng = np.random.RandomState(seed)
        self.img_backbone = nn.Module()
        self.img_backbone.conv1 = nn.Module()
        self.img_backbone.conv1.weight = _leaf(3, 3, rng=rng)
        self.pts_backbone = nn.Module()
        self.pts_backbone.block0 = nn.Module()
        self.pts_backbone.block0.weight = _leaf(4, rng=rng)
        self.imgpts_neck = nn.Module()
        self.imgpts_neck.cam_lss = nn.Module()
        self.imgpts_neck.cam_lss.w = _leaf(2, rng=rng)
        self.imgpts_neck.shared_conv_pts = nn.Module()
        self.imgpts_neck.shared_conv_pts.weight = _leaf(2, rng=rng)
        self.bn = nn.BatchNorm1d(3, affine=False)  # buffers only
        self.bn.running_mean.fill_(float(seed))


def _state(seed=0, frozen_by=None):
    """The net and its optimizer state; with a config ``frozen_by``, the
    parameters its flags freeze do not require a gradient, as the
    detector marks them."""
    model = _Net(seed)
    if frozen_by is not None:
        keep = trainable_mask(frozen_by,
                              [n for n, _ in model.named_parameters()])
        for n, p in model.named_parameters():
            p.requires_grad_(keep[n])
    tx = optim.make_optimizer()
    opt_state = tx.init(model.named_parameters())
    for i, t in enumerate(opt_state.mu + opt_state.nu):
        t.fill_(seed + i)
    opt_state.count = seed
    return model, opt_state


class TestCheckpoint:
    def test_save_restore_roundtrip(self, tmp_path):
        m, s = _state(3)
        ckpt.save_checkpoint(str(tmp_path), m, s, epoch=1)
        r, rs = _state(0)
        ckpt.restore_checkpoint(str(tmp_path / "epoch_1"), r, rs)
        for k, v in m.state_dict().items():
            assert torch.equal(r.state_dict()[k], v), k
        assert rs.count == 3 and rs.names == s.names
        for a, b in zip(rs.mu + rs.nu, s.mu + s.nu):
            assert torch.equal(a, b)

    def test_keep_last(self, tmp_path):
        for e in range(1, 5):
            ckpt.save_checkpoint(str(tmp_path), *_state(e), epoch=e,
                                 keep_last=2)
        assert ckpt.list_epochs(str(tmp_path)) == [3, 4]

    def test_auto_resume(self, tmp_path):
        m, s = _state(0)
        assert ckpt.auto_resume(str(tmp_path), m, s) == 0
        assert s.count == 0
        ckpt.save_checkpoint(str(tmp_path), *_state(7), epoch=2)
        assert ckpt.auto_resume(str(tmp_path), m, s) == 2
        assert s.count == 7
        assert float(m.bn.running_mean[0]) == 7.0

    def test_partial_img_load(self):
        dst = _state(0)[0].state_dict()
        src = _state(9)[0].state_dict()
        merged = ckpt.load_partial_params(dst, src, ckpt.img_branch_filter)
        for k in ("img_backbone.conv1.weight", "imgpts_neck.cam_lss.w"):
            assert torch.equal(merged[k], src[k]), k
        # non-image branches untouched
        for k in ("pts_backbone.block0.weight",
                  "imgpts_neck.shared_conv_pts.weight",
                  "bn.running_mean"):
            assert torch.equal(merged[k], dst[k]), k


class TestFreezeMask:
    def test_masks_follow_flags(self):
        names = [n for n, _ in _Net(0).named_parameters()]
        cfg = DetectorConfig(freeze_img=True, freeze_pts=True,
                             freeze_camlss=True)
        assert trainable_mask(cfg, names) == {n: False for n in names}
        assert trainable_mask(DetectorConfig(), names) == \
            {n: True for n in names}

    @pytest.mark.parametrize("flag,frozen", [
        ("freeze_img", {"img_backbone.conv1.weight"}),
        ("freeze_camlss", {"imgpts_neck.cam_lss.w"}),
        ("freeze_pts", {"pts_backbone.block0.weight",
                        "imgpts_neck.shared_conv_pts.weight"}),
    ])
    def test_each_flag(self, flag, frozen):
        names = [n for n, _ in _Net(0).named_parameters()]
        mask = trainable_mask(DetectorConfig(**{flag: True}), names)
        assert {n for n, keep in mask.items() if not keep} == frozen


def test_weights_only_load(tmp_path):
    m, s = _state(5)
    path = ckpt.save_checkpoint(str(tmp_path), m, s, epoch=3,
                                meta={"config": "Tiny_L", "seed": 5})
    payload = torch.load(f"{path}/{ckpt.STATE_FILE}", weights_only=True)
    assert payload["step"] == 5 and payload["meta"]["config"] == "Tiny_L"
    assert sorted(payload["opt_state"]["mu"]) == sorted(s.names)
    assert set(payload["state_dict"]) == set(m.state_dict())


def test_masked_opt_state_is_keyed_by_the_trainable_names(tmp_path):
    cfg = DetectorConfig(freeze_pts=True)
    m, s = _state(2, frozen_by=cfg)
    assert s.names == ["img_backbone.conv1.weight", "imgpts_neck.cam_lss.w"]
    ckpt.save_checkpoint(str(tmp_path), m, s, epoch=1)
    payload = ckpt.load_payload(str(tmp_path / "epoch_1"))
    assert sorted(payload["opt_state"]["mu"]) == sorted(s.names)
    # an unmasked optimizer state cannot be filled from it
    r, rs = _state(0)
    with pytest.raises(KeyError, match="no optimizer state"):
        ckpt.restore_checkpoint(str(tmp_path / "epoch_1"), r, rs)


def test_partial_load_checks_shapes_and_is_not_strict():
    dst = {"a": torch.zeros(3), "b": torch.zeros(2, 2), "only_dst":
           torch.ones(1)}
    src = {"a": torch.arange(3.0, dtype=torch.float64),
           "b": torch.ones(4), "only_src": torch.ones(5)}
    merged = ckpt.load_partial_params(dst, src)
    assert merged["a"].dtype == torch.float32
    assert torch.equal(merged["a"], torch.arange(3.0))
    assert torch.equal(merged["b"], dst["b"])  # shape differs: kept
    assert torch.equal(merged["only_dst"], dst["only_dst"])
    assert set(merged) == set(dst)

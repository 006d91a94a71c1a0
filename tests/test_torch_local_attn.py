"""The fusion layers' local attention (``ops/local_attn.py``).

On the CPU: the backward's torch formula over saved softmax weights
(``local_attention_backward``) against autograd through the plain loop,
at k 3 and 9, batch 2, a ragged 10 x 13 map, float64 and float32; the
CPU dispatch runs the plain loop; the operand checks and the shared-memory
sizes the kernel is launched with; ``train_step.kernel_launches`` carries
``local_attn``.

On a card (marker ``cuda``, skipped without one; this file imports
neither JAX nor the JAX package): the kernel against the plain loop in
float32 (within 1e-5 of the output's scale: the same float32 sums in
another order) and in bf16 against the float32 plain loop on the same
values (within 2**-8 of scale: the kernel computes in float32 and rounds
once, half a bf16 ulp), at the cells' (1, 180, 180, 128) and at ragged
shapes, H and W below the 8 x 8 tile among them; gradients through the
autograd Function against autograd through the plain loop; the wrapper
raising on what it does not take; one launch a call.

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_local_attn.py
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from focalformer3d_tpu_torch.ops import local_attn as la
from focalformer3d_tpu_torch.training import train_step


def _maps(seed, shape, dtype=torch.float64, device="cpu", scale=0.5):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(scale * rng.standard_normal(shape)).to(
        device=device, dtype=dtype) for _ in range(3)]


def _weights(q, k, ks):
    """The softmax weights (B, H, W, ks^2) in float64, the out-of-image
    neighbours masked by their coordinates."""
    B, H, W, _ = q.shape
    r = ks // 2
    q, k = q.double(), k.double()
    kp = torch.nn.functional.pad(k, (0, 0, r, r, r, r))
    ys = torch.arange(H, device=q.device)[:, None]
    xs = torch.arange(W, device=q.device)[None, :]
    logits, valid = [], []
    for dy in range(ks):
        for dx in range(ks):
            logits.append((q * kp[:, dy:dy + H, dx:dx + W]).sum(-1))
            valid.append((ys + dy - r >= 0) & (ys + dy - r < H)
                         & (xs + dx - r >= 0) & (xs + dx - r < W))
    logits = torch.stack(logits, -1).masked_fill(
        ~torch.stack(valid, -1), float("-inf"))
    return torch.softmax(logits, -1)


def _rel(got, ref):
    return float((got.double() - ref.double()).abs().max()
                 / ref.double().abs().max())


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 2e-5)])
@pytest.mark.parametrize("ks", [3, 9])
def test_backward_formula_matches_autograd_through_the_plain_loop(ks, dtype,
                                                                  tol):
    q, k, v = (t.requires_grad_() for t in _maps(ks, (2, 10, 13, 8), dtype))
    dout = _maps(ks + 100, (2, 10, 13, 8), dtype)[0]
    with torch.enable_grad():  # whatever an earlier test left set
        out = la.local_attention_plain(q, k, v, ks)
        want = torch.autograd.grad(out, (q, k, v), dout)
    w = _weights(q.detach(), k.detach(), ks).to(
        torch.promote_types(dtype, torch.float32))
    got = la.local_attention_backward(dout, q.detach(), k.detach(),
                                      v.detach(), w, ks)
    for g, r in zip(got, want):
        assert g.dtype == dtype and g.shape == r.shape
        assert _rel(g, r) <= tol


def test_weights_give_the_plain_output():
    """The test's weights are the plain loop's: sum_d w * v[p + d]."""
    q, k, v = _maps(1, (2, 10, 13, 8))
    w = _weights(q, k, 9)
    vp = torch.nn.functional.pad(v, (0, 0, 4, 4, 4, 4))
    out = sum(w[..., 9 * dy + dx, None] * vp[:, dy:dy + 10, dx:dx + 13]
              for dy in range(9) for dx in range(9))
    assert _rel(out, la.local_attention_plain(q, k, v, 9)) <= 1e-12


def test_cpu_runs_the_plain_loop():
    q, k, v = _maps(2, (1, 6, 7, 5), torch.float32)
    la.reset_launch_count()
    assert torch.equal(la.local_attention(q, k, v, 3),
                       la.local_attention_plain(q, k, v, 3))
    assert la.launch_count() == 0
    with pytest.raises(ValueError, match="on a card"):
        la.local_attention_cuda(q, k, v, 3)


@pytest.mark.parametrize("args,err,match", [
    (((1, 8, 8, 16), torch.float32, 4), ValueError, "kernel_size"),
    (((1, 8, 8, 16), torch.float32, 11), ValueError, "kernel_size"),
    (((1, 8, 8, 16), torch.float16, 9), TypeError, "must be one of"),
    (((1, 8, 8, 16), torch.float64, 9), TypeError, "must be one of"),
    (((1, 8, 8, 12), torch.bfloat16, 9), ValueError, "16-byte"),
    (((1, 8, 8, 6), torch.float32, 9), ValueError, "16-byte"),
    (((8, 16),), ValueError, "one \\(\\.\\.\\., H, W, C\\) shape"),
    (((1, 8, 8, 512), torch.bfloat16, 9), ValueError, "shared memory"),
    (((1, 8, 8, 256), torch.float32, 9), ValueError, "shared memory")])
def test_check_operands_raises_on_what_the_kernel_does_not_take(args, err,
                                                                match):
    shape, dtype, ks = (*args, torch.float32, 9)[:3]
    q = torch.zeros(shape, dtype=dtype)
    with pytest.raises(err, match=match):
        la.check_operands(q, q, q, ks)


def test_check_operands_raises_on_mixed_operands():
    q = torch.zeros((1, 8, 8, 16))
    with pytest.raises(TypeError):
        la.check_operands(q, q.bfloat16(), q, 9)
    with pytest.raises(ValueError):
        la.check_operands(q, q, torch.zeros((1, 8, 9, 16)), 9)


@pytest.mark.parametrize("c,dtype,ks", [(128, torch.bfloat16, 9),
                                        (128, torch.float32, 9),
                                        (320, torch.bfloat16, 9),
                                        (8, torch.bfloat16, 3),
                                        (32, torch.float32, 3)])
def test_check_operands_takes_the_fusion_layers_widths(c, dtype, ks):
    q = torch.zeros((2, 10, 13, c), dtype=dtype)
    la.check_operands(q, q, q, ks)


def test_smem_bytes_at_the_cells_width():
    """bf16 C 128 k 9: a 16 x 16 halo and an 8 x 8 q tile of 17-chunk
    positions (one chunk of padding), a chunk more a row, and 64 x 81
    float32 logits: two blocks fit an SM's 228 KB."""
    assert la.smem_bytes(128, 2, 9) == 16 * (16 * (16 * 17 + 1)
                                             + 8 * (8 * 17 + 1)) + 64 * 81 * 4
    assert la.smem_bytes(128, 2, 9) == 108160
    assert 2 * (la.smem_bytes(128, 2, 9) + 1024) <= 228 * 1024
    assert la.smem_bytes(128, 4, 9) <= la.MAX_SMEM


def test_kernel_launches_carry_local_attn():
    q, k, v = _maps(3, (1, 5, 5, 8), torch.float32)
    train_step.reset_kernel_launches()
    la.local_attention(q, k, v, 3)
    assert train_step.kernel_launches()["local_attn"] == 0


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


SHAPES = [(1, 180, 180, 128), (2, 10, 13, 32), (1, 5, 7, 16),
          (3, 17, 9, 64), (1, 1, 1, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("ks", [9, 3, 5, 7])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_the_plain_loop_on_card(dev, shape, ks):
    q, k, v = _maps(sum(shape) + ks, shape, torch.float32, dev)
    ref = la.local_attention_plain(q, k, v, ks)
    la.reset_launch_count()
    got, w = la.local_attention_cuda(q, k, v, ks, weights=True)
    torch.cuda.synchronize()
    assert la.launch_count() == 1 and got.dtype == torch.float32
    assert _rel(got, ref) <= 1e-5
    assert _rel(w, _weights(q, k, ks)) <= 1e-5
    b16 = [t.bfloat16() for t in (q, k, v)]
    ref16 = la.local_attention_plain(*(t.float() for t in b16), ks)
    got16 = la.local_attention(*b16, ks)
    torch.cuda.synchronize()
    assert la.launch_count() == 2 and got16.dtype == torch.bfloat16
    assert _rel(got16, ref16) <= 2.0 ** -8
    assert torch.isfinite(got16.float()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2.0 ** -8)])
@pytest.mark.parametrize("ks", [9, 3])
def test_gradients_match_autograd_through_the_plain_loop_on_card(dev, ks,
                                                                 dtype, tol):
    """The Function's gradients against autograd through the plain loop in
    float32 on the same values (bf16 operands and output gradient widened):
    float32 within 1e-5 of scale; bf16 within 2**-8 (the backward computes
    in float32 and its gradients round once to bf16)."""
    shape = (2, 23, 19, 32)
    q, k, v = _maps(ks, shape, torch.float32, dev)
    dout = _maps(ks + 7, shape, torch.float32, dev)[0].to(dtype)
    ops = [t.to(dtype).requires_grad_() for t in (q, k, v)]
    ref_ops = [t.detach().float().requires_grad_() for t in ops]
    la.reset_launch_count()
    with torch.enable_grad():
        want = torch.autograd.grad(la.local_attention_plain(*ref_ops, ks),
                                   ref_ops, dout.float())
        out = la.local_attention(*ops, ks)
        got = torch.autograd.grad(out, ops, dout)
    torch.cuda.synchronize()
    assert la.launch_count() == 1
    for g, r in zip(got, want):
        assert g.dtype == dtype
        assert _rel(g, r) <= tol


@pytest.mark.cuda
def test_no_weights_without_a_gradient_on_card(dev):
    q, k, v = (t.requires_grad_() for t in
               _maps(5, (1, 12, 12, 16), torch.float32, dev))
    with torch.no_grad():
        out = la.local_attention(q, k, v, 9)
    assert out.grad_fn is None
    with torch.enable_grad():
        out = la.local_attention(q, k, v, 9)
    assert type(out.grad_fn).__name__ == "LocalAttentionBackward"


@pytest.mark.cuda
@pytest.mark.parametrize("args,err", [
    (((1, 8, 8, 16), torch.float16, 9), TypeError),
    (((1, 8, 8, 12), torch.bfloat16, 9), ValueError),
    (((1, 8, 8, 16), torch.float32, 8), ValueError),
    (((1, 8, 8, 512), torch.bfloat16, 9), ValueError)])
def test_wrapper_raises_on_card(dev, args, err):
    shape, dtype, ks = args
    q = torch.zeros(shape, dtype=dtype, device=dev)
    la.reset_launch_count()
    with pytest.raises(err):
        la.local_attention(q, q, q, ks)
    with pytest.raises(ValueError):
        la.local_attention(q, q.cpu(), q, 9)
    assert la.launch_count() == 0

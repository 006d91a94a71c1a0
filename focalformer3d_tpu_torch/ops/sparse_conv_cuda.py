"""K1: the sparse conv, forward and backward, as hand-written CUDA kernels.

``sparse_conv`` is the forward entry point. For tensors on a card it
launches the kernel of ``csrc/sparse_conv.cu`` (replacing the TPU kernel
``focalformer3d_tpu/ops/sparse_conv_pallas.py:_kernel``); for tensors on the
CPU it runs ``apply_conv_plain`` with the kernel's rounding. Both compute
``focalformer3d_tpu.ops.sparse_conv.apply_conv`` over absolute rulebooks:

    out[b, j] = out_valid[b, j] ? bias + sum_k feats[b, rules[b, k, j]] @ W[k]
                                : 0

``sparse_conv_train`` is the differentiable conv of the training path, a
``torch.autograd.Function`` that carries the JAX custom VJP
(``sparse_conv_pallas._conv_core``) with its rounding:

- forward: ``sparse_conv`` with the features and weights cast to bf16
  inside the Function, so the cotangents come back in the caller's dtype;
- dx: the same kernel on the transposed rulebook with ``W[K-1-k]^T`` and
  the cotangent cast to bf16 (``conv_dx``, counted apart from the forward);
- dW: the kernel of ``csrc/sparse_conv_wgrad.cu`` (``conv_wgrad``;
  ``dW[k] = sum_j bf16(x[rules[k, j]])^T g[j]``, g in f32 split into two
  bf16 parts by ``split_bf16``, both products on tensor cores into f32
  sums), which replaces the TPU kernel's gather mode, the dot after it and
  the spill correction (``sparse_conv_pallas.py:726-767``);
- db: the sum of the masked cotangent.

``sparse_conv_probe`` is the same forward kernel with its phases switched
(``PHASES`` of ``csrc/sparse_conv.cu``): ``PHASE_GATHER`` copies the gathered
rows, ``PHASE_MMA`` copies W and runs the tensor-core product. ``PHASE_FULL``
is production K1's own instantiation; the other modes time a part of it, as
the TPU probes P1b, P4, P5 and P8 did with copies of their kernel, and
compute ``out_valid ? bias : 0``. It counts its launches apart (``probe``)
and can force either instruction route (``route``).

Host-side parts of the kernel's design, each with a version the CPU runs:
``pack_weights`` (W as the kernel's shared-memory image; ``unpack_weights``
inverts it), ``tile_schedule`` (which tiles each persistent block visits),
``hit_shares`` (how much work skipping at 128-, 64- and 16-row granularity
leaves) and ``route_for`` (the instruction chosen per width).

Each kernel's plain version sits beside it and is what a CPU tensor gets.
The kernels are compiled with ``nvcc`` into ``focalformer3d_tpu_torch/_build/``
at first use (a few seconds each; plain C interfaces loaded with
``ctypes``), from the sources in this package only.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import cuda_build

SOURCE = cuda_build.CSRC / "sparse_conv.cu"
WGRAD_SOURCE = cuda_build.CSRC / "sparse_conv_wgrad.cu"
COUTS = (16, 32, 64, 128)
MAX_C = 256
KERNEL_MAX_C = 128  # channels per launch; wider inputs run in halves
MAX_TAPS = 32  # one bit per tap in the kernel's hit masks
TILE = 128  # output sites per tile of the kernel
ROUTE_WGMMA = 0  # wgmma.mma_async m64nNk16 on 64-row groups
ROUTE_MMA_SYNC = 1  # mma.sync m16n8k16 on 16-row strips
ROUTE_NAMES = {ROUTE_WGMMA: "wgmma", ROUTE_MMA_SYNC: "mma.sync"}
WGRAD_BLOCKS = 2048  # target blocks per dW launch (taps x site slices)
WGRAD_SLICE_UNIT = 256  # a slice's sites: 32 for each of the block's warps
WGRAD_ROUTE = ROUTE_MMA_SYNC  # the dW kernel's product: mma.sync m16n8k16

PHASE_GATHER = 1
PHASE_MMA = 2
PHASE_FULL = PHASE_GATHER | PHASE_MMA

_fn = None
_probe_fn = None
_grid_fn = None
_wgrad_fn = None
_wgrad_chunk_fn = None
_launches = cuda_build.Launches("forward", "dx", "wgrad", "probe")


def launch_count(kind: str = "forward") -> int:
    """Launches of one kernel use since the last ``reset_launch_count``:
    ``forward`` (K1), ``dx`` (K1 on a transposed rulebook), ``wgrad`` (the
    dW kernel) or ``probe`` (K1 with its phases switched)."""
    return _launches.counts[kind]


def reset_launch_count() -> None:
    _launches.reset()


def _load():
    global _fn
    if _fn is None:
        _fn = cuda_build.load(
            SOURCE, "sparse_conv_forward",
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    return _fn


def _load_probe():
    global _probe_fn
    if _probe_fn is None:
        _probe_fn = cuda_build.load(
            SOURCE, "sparse_conv_probe",
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    return _probe_fn


def _load_grid():
    global _grid_fn
    if _grid_fn is None:
        _grid_fn = cuda_build.load(
            SOURCE, "sparse_conv_grid",
            [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)])
    return _grid_fn


def _load_wgrad():
    global _wgrad_fn
    if _wgrad_fn is None:
        _wgrad_fn = cuda_build.load(
            WGRAD_SOURCE, "sparse_conv_wgrad",
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    return _wgrad_fn


@functools.lru_cache(maxsize=16)
def wgrad_chunk(c: int, c_out: int) -> int:
    """Hits per chunk of the dW kernel at kernel widths (C, Cout): 128
    where its stage of 128 rows stays small, else 64."""
    global _wgrad_chunk_fn
    if _wgrad_chunk_fn is None:
        _wgrad_chunk_fn = cuda_build.load(
            WGRAD_SOURCE, "sparse_conv_wgrad_chunk", [ctypes.c_int] * 2)
    chunk = _wgrad_chunk_fn(c, c_out)
    if chunk <= 0:
        raise ValueError(f"dW kernel has no widths C={c}, Cout={c_out}")
    return chunk


def wgrad_slices(n_sites: int, n_taps: int):
    """(slices, sites per slice) of one dW launch over ``n_sites`` sites
    (B x V_out): about ``WGRAD_BLOCKS`` blocks of (tap, slice), each slice
    a multiple of ``WGRAD_SLICE_UNIT`` sites, the last one ragged."""
    unit = WGRAD_SLICE_UNIT
    slices = max(1, min(-(-n_sites // unit), -(-WGRAD_BLOCKS // n_taps)))
    per = -(-max(n_sites, 1) // slices)
    per = -(-per // unit) * unit
    return -(-max(n_sites, 1) // per), per


def pad_channels(x: torch.Tensor, dim: int):
    """Zero-pad one channel dim to a multiple of 16 (C=5 -> 16)."""
    c = x.shape[dim]
    cp = -(-c // 16) * 16
    if cp == c:
        return x
    pad = [0, 0] * (x.dim() - 1 - dim % x.dim()) + [0, cp - c]
    return torch.nn.functional.pad(x, pad)


def apply_conv_plain(features: torch.Tensor, rules: torch.Tensor,
                     weights: torch.Tensor, out_valid: torch.Tensor,
                     bias: Optional[torch.Tensor] = None,
                     compute_dtype: torch.dtype = torch.float32
                     ) -> torch.Tensor:
    """Gather + matmul of ``sparse_conv.apply_conv``, batched.

    features (B, V_in, C); rules (B, K, V_out) with V_in as the miss
    sentinel; weights (K, C, Cout); out_valid (B, V_out). Operands are cast
    to ``compute_dtype`` and the result is returned in that dtype."""
    B, V_in, C = features.shape
    K, _, C_out = weights.shape
    V_out = rules.shape[2]
    fpad = torch.cat([features, features.new_zeros((B, 1, C))], dim=1)
    idx = rules.transpose(1, 2).reshape(B, V_out * K).long()
    g = torch.gather(fpad, 1, idx[..., None].expand(-1, -1, C))
    g = g.reshape(B, V_out, K * C).to(compute_dtype)
    acc = g @ weights.reshape(K * C, C_out).to(compute_dtype)
    if bias is not None:
        acc = acc + bias.to(compute_dtype)
    return torch.where(out_valid[..., None], acc, 0.0)


def check_operands(features, index, weights, out_valid, bias,
                   taps_per_entry: int = 1):
    """Dtype, device, contiguity and shape checks shared by the conv
    kernels' wrappers: ``index`` (B, R, V_out) int32 holds one entry per
    ``taps_per_entry`` taps of ``weights`` (K, C, Cout)."""
    dev = features.device
    if features.dtype != torch.bfloat16 or weights.dtype != torch.bfloat16:
        raise TypeError("features and weights must be bfloat16")
    if index.dtype != torch.int32 or out_valid.dtype != torch.bool:
        raise TypeError("rules must be int32 and out_valid bool")
    if bias is not None and bias.dtype != torch.float32:
        raise TypeError("bias must be float32")
    tensors = [features, index, weights, out_valid] + (
        [bias] if bias is not None else [])
    for t in tensors:
        if t.device != dev:
            raise ValueError("all operands must be on one device")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    if features.dim() != 3 or index.dim() != 3 or weights.dim() != 3:
        raise ValueError("features (B,V,C), rules (B,K,V_out), weights "
                         "(K,C,Cout) expected")
    B, _, C = features.shape
    K, Cw, C_out = weights.shape
    if (Cw != C or index.shape[0] != B
            or index.shape[1] * taps_per_entry != K):
        raise ValueError(f"shape mismatch: features {tuple(features.shape)}"
                         f" rules {tuple(index.shape)} weights "
                         f"{tuple(weights.shape)}")
    if out_valid.shape != (B, index.shape[2]):
        raise ValueError("out_valid must be (B, V_out)")
    if bias is not None and bias.shape != (C_out,):
        raise ValueError("bias must be (Cout,)")


def pad_operands(features, weights, bias, max_c: int):
    """Pad C to a multiple of 16 and Cout up to the next width in ``COUTS``,
    as the conv kernels take them (zero channels add nothing)."""
    c_out = weights.shape[2]
    if features.shape[2] > max_c or c_out > COUTS[-1]:
        raise ValueError(f"kernel takes C <= {max_c} and Cout <= "
                         f"{COUTS[-1]}; got C={features.shape[2]}, "
                         f"Cout={c_out}")
    cout_k = next(c for c in COUTS if c >= c_out)
    features = pad_channels(features, 2)
    weights = pad_channels(weights, 1)
    if cout_k != c_out:
        weights = torch.nn.functional.pad(weights, (0, cout_k - c_out))
        if bias is not None:
            bias = torch.nn.functional.pad(bias, (0, cout_k - c_out))
    cuda_build.check_aligned(features, weights)
    return features, weights, bias


def _pack_layout(t: torch.Tensor) -> torch.Tensor:
    """(K, C, Cout) -> (K, C / 16, Cout, 2, 8): per tap and 16-channel
    K-block the transposed tile, row n holding its 16 channels as two
    8-value halves, swapped where bit 2 of n is set (the 32-byte swizzle of
    ``csrc/mma_sm90.cuh``)."""
    K, C, c_out = t.shape
    t = t.reshape(K, C // 16, 2, 8, c_out).permute(0, 1, 4, 2, 3)
    swap = ((torch.arange(c_out, device=t.device) >> 2) & 1).bool()
    return torch.where(swap[None, None, :, None, None], t.flip(3), t)


@functools.lru_cache(maxsize=64)
def _pack_index(K: int, C: int, c_out: int, device: torch.device):
    """Flat positions in a (K, C, Cout) tensor of the packed image's
    elements, in the image's order."""
    pos = torch.arange(K * C * c_out, device=device).reshape(K, C, c_out)
    return _pack_layout(pos).reshape(-1).contiguous()


def pack_weights(weights: torch.Tensor) -> torch.Tensor:
    """W (K, C, Cout), C a multiple of 16 and Cout of 8, as the kernel keeps
    it in shared memory: (K, C / 16, Cout, 16), ``W[k]^T`` cut into K-blocks
    of 16 channels with the swizzle of ``_pack_layout``. One gather through
    a cached index."""
    K, C, c_out = weights.shape
    if C % 16 or c_out % 8:
        raise ValueError(f"pack_weights takes C % 16 == 0 and Cout % 8 == 0;"
                         f" got C={C}, Cout={c_out}")
    idx = _pack_index(K, C, c_out, weights.device)
    return weights.reshape(-1).index_select(0, idx).reshape(
        K, C // 16, c_out, 16)


def unpack_weights(packed: torch.Tensor) -> torch.Tensor:
    """The (K, C, Cout) tensor that ``pack_weights`` packed."""
    K, J, c_out, _ = packed.shape
    idx = _pack_index(K, J * 16, c_out, packed.device)
    flat = torch.empty_like(packed).reshape(-1)
    flat[idx] = packed.reshape(-1)
    return flat.reshape(K, J * 16, c_out)


def tile_schedule(batch: int, v_out: int, grid: int):
    """The tiles each persistent block visits, as the kernel's loop walks
    them: block i takes tiles i, i + grid, ... of the batch's
    ``batch * ceil(v_out / TILE)`` tiles, tile t being sites
    ``(t % per_sample) * TILE ..`` of sample ``t // per_sample``. Returns a
    list per block of (sample, first site)."""
    per_sample = -(-v_out // TILE)
    n_tiles = batch * per_sample
    return [[(t // per_sample, (t % per_sample) * TILE)
             for t in range(i, n_tiles, grid)] for i in range(grid)]


def hit_shares(rules: torch.Tensor, v_in: int) -> dict:
    """How much of the product's work skipping leaves, at each granularity
    the kernel could skip at: the share of (128-site tile, tap), (64-row
    group, tap), (16-row strip, tap) and (site, tap) pairs of a rulebook
    (B, K, V_out) that hold at least one hit (a rule below ``v_in``), over
    the tiles the kernel launches (the last tile of a sample is padded with
    misses). Keys ``tile``, ``group64``, ``strip16``, ``site``."""
    return hit_shares_of((rules >= 0) & (rules < v_in))


def hit_shares_of(hit: torch.Tensor) -> dict:
    """``hit_shares`` of a boolean (B, K, V_out) hit tensor."""
    B, K, v_out = hit.shape
    pad = -v_out % TILE
    if pad:
        hit = torch.nn.functional.pad(hit, (0, pad))
    out = {}
    for name, rows in (("tile", TILE), ("group64", 64), ("strip16", 16),
                       ("site", 1)):
        groups = hit.reshape(B, K, -1, rows).any(-1)
        out[name] = float(groups.float().mean()) if groups.numel() else 0.0
    return out


def kernel_widths(c: int, c_out: int):
    """The (C, Cout) one launch runs for a conv of widths (c, c_out): C
    padded to a multiple of 16 (at most ``KERNEL_MAX_C`` per launch), Cout
    to the next width in ``COUTS``."""
    return (min(-(-c // 16) * 16, KERNEL_MAX_C),
            next(n for n in COUTS if n >= c_out))


def route_for(c: int, c_out: int) -> int:
    """The instruction route production K1 takes at kernel widths (C, Cout):
    ``wgmma`` from C = 64 on, ``mma.sync`` below.

    Measured on an NVIDIA H100 80GB HBM3 at 700 W: both routes' times per
    conv geometry of a radial 200k-point scan and of a training batch of
    two, below; the P2 probe prints kernel A's rate per route at K1's
    widths. The card test ``test_k1_at_every_conv_of_a_full_scan`` holds
    both routes at every conv of that scan. A route's worth is its product
    rate at the width divided by the share of (group, tap) pairs its
    skipping leaves: 64-row groups for wgmma, 16-row strips for mma.sync.

    - C = Cout = 16: kernel A runs 18.7 (wgmma) against 19.9 TFLOP/s
      (mma.sync), the shares on the scan are 0.87 against 0.69, and K1
      itself takes 0.0730 against 0.0641 ms: mma.sync.
    - 32: 72.8 against 75.7 TFLOP/s, shares 0.98 against 0.93, K1 0.1474
      against 0.1483 ms at 32 -> 32 (a tie) and 0.1987 against 0.1689 ms at
      32 -> 64: mma.sync.
    - 64: 210.5 against 143.7 TFLOP/s, shares 0.98 against 0.96, K1 0.2176
      against 0.2337 ms at 64 -> 64 and 0.1212 against 0.1618 ms at
      64 -> 128: wgmma. dx at 64 -> 32 agrees (0.2815 against 0.2895 ms).
    - 128: 292.0 against 174.9 TFLOP/s, K1 0.2330 against 0.3331 ms: wgmma.

    On real scans nearly every strip of a used tile has a hit (0.64-0.96),
    so the finer skipping of mma.sync pays only where both routes run at
    the same rate, below C = 64."""
    return ROUTE_WGMMA if c >= 64 else ROUTE_MMA_SYNC


@functools.lru_cache(maxsize=256)
def _grid(B: int, V_out: int, K: int, C: int, c_out: int, route: int):
    """(persistent blocks, stages, W resident, shared bytes) of one conv on
    the current card."""
    info = (ctypes.c_int * 4)()
    grid = _load_grid()(B, V_out, K, C, c_out, route, info)
    if grid <= 0:
        raise RuntimeError(f"sparse_conv_grid failed: cudaError {-grid} for "
                           f"K={K}, C={C}, Cout={c_out}")
    return grid, info[0], bool(info[1]), info[2]


def launch_plan(B: int, V_out: int, K: int, C: int, c_out: int,
                route: Optional[int] = None) -> dict:
    """What one launch at kernel widths does on the current card: its
    route, persistent grid, pipeline stages, whether W stays in shared
    memory, and the shared bytes a block takes."""
    route = route_for(C, c_out) if route is None else route
    grid, stages, resident, smem = _grid(B, V_out, K, C, c_out, route)
    return {"route": ROUTE_NAMES[route], "grid": grid, "stages": stages,
            "w_resident": resident, "smem_bytes": smem}


def _launch(features, rules, weights, out_valid, bias, phases, route, kind):
    """One launch at kernel widths (C <= KERNEL_MAX_C), counted as
    ``kind``."""
    B, V_in, C = features.shape
    K, _, C_out = weights.shape
    V_out = rules.shape[2]
    out = torch.empty((B, V_out, C_out), dtype=torch.float32,
                      device=features.device)
    if B == 0 or V_out == 0:
        return out
    route = route_for(C, C_out) if route is None else route
    grid = _grid(B, V_out, K, C, C_out, route)[0]
    packed = pack_weights(weights)
    stream = torch.cuda.current_stream(features.device).cuda_stream
    args = (features.data_ptr(), rules.data_ptr(), packed.data_ptr(),
            bias.data_ptr() if bias is not None else None,
            out_valid.data_ptr(), out.data_ptr(), B, V_in, V_out, K, C, C_out,
            route, grid)
    if phases is None:
        cuda_build.check_launch(_load()(*args, stream), "sparse_conv")
    else:
        cuda_build.check_launch(_load_probe()(*args, phases, stream),
                                "sparse_conv_probe")
    _launches.add(kind)
    return out


def _run_forward(features, rules, weights, out_valid, bias, kind,
                 phases=None, route=None):
    """Launch the forward kernel, or with ``phases`` its probe (checked
    operands on a card), counting each launch as ``kind``. Inputs wider than ``KERNEL_MAX_C`` channels run as
    one launch per 128-channel part, summed (the bias rides on the
    first)."""
    c_out = weights.shape[2]
    if weights.shape[0] > MAX_TAPS:
        raise ValueError(f"kernel takes K <= {MAX_TAPS} taps; got "
                         f"K={weights.shape[0]}")
    features, weights, bias = pad_operands(features, weights, bias, MAX_C)
    C = features.shape[2]
    out = None
    for c0 in range(0, C, KERNEL_MAX_C):
        whole = C <= KERNEL_MAX_C
        part = _launch(
            features if whole else
            features[..., c0:c0 + KERNEL_MAX_C].contiguous(), rules,
            weights if whole else
            weights[:, c0:c0 + KERNEL_MAX_C].contiguous(), out_valid,
            bias if c0 == 0 else None, phases, route, kind)
        out = part if out is None else out + part
    return out if out.shape[2] == c_out else out[..., :c_out].contiguous()


def sparse_conv(features: torch.Tensor, rules: torch.Tensor,
                weights: torch.Tensor, out_valid: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sparse conv apply with bf16 operands and f32 accumulation.

    features bf16 (B, V_in, C); rules int32 (B, K, V_out) of CSR positions
    with V_in as the miss sentinel; weights bf16 (K, C, Cout), dz-major
    taps; bias f32 (Cout,) or None; out_valid bool (B, V_out); all
    contiguous, on one device. Returns f32 (B, V_out, Cout); inactive
    sites are zero. C is zero-padded to a multiple of 16 and Cout to a
    width in ``COUTS`` here. On a CUDA device this launches the kernel (or
    raises); on the CPU it runs ``apply_conv_plain`` with the same
    rounding."""
    check_operands(features, rules, weights, out_valid, bias)
    if not cuda_build.on_card(features):
        return apply_conv_plain(features, rules, weights, out_valid,
                                bias, torch.float32)
    return _run_forward(features, rules, weights, out_valid, bias, "forward")


def sparse_conv_probe_plain(features, rules, weights, out_valid, bias=None,
                            phases: int = PHASE_FULL) -> torch.Tensor:
    """What each mode computes: ``apply_conv_plain`` in full mode, else
    ``out_valid ? bias : 0`` (the product never reaches the output)."""
    if phases == PHASE_FULL:
        return apply_conv_plain(features, rules, weights, out_valid, bias,
                                torch.float32)
    B, V_out = out_valid.shape
    out = torch.zeros((B, V_out, weights.shape[2]), dtype=torch.float32,
                      device=features.device)
    if bias is not None:
        out = out + bias
    return torch.where(out_valid[..., None], out, 0.0)


def sparse_conv_probe(features: torch.Tensor, rules: torch.Tensor,
                      weights: torch.Tensor, out_valid: torch.Tensor,
                      bias: Optional[torch.Tensor] = None,
                      phases: int = PHASE_FULL,
                      route: Optional[int] = None) -> torch.Tensor:
    """K1's forward kernel with only the phases in ``phases`` (bits
    ``PHASE_GATHER``, ``PHASE_MMA``); operands as ``sparse_conv``. Full mode
    runs production K1's own code, so it equals ``sparse_conv`` bit for bit
    on production's route (``route=None``: ``route_for``'s choice;
    ``ROUTE_WGMMA`` or ``ROUTE_MMA_SYNC`` forces one). On a CUDA device this
    launches the kernel (or raises); on the CPU it runs
    ``sparse_conv_probe_plain``."""
    if phases not in (0, PHASE_GATHER, PHASE_MMA, PHASE_FULL):
        raise ValueError(f"phases={phases} is not a mode of the probe")
    if route not in (None, ROUTE_WGMMA, ROUTE_MMA_SYNC):
        raise ValueError(f"route={route} is not a route of the kernel")
    check_operands(features, rules, weights, out_valid, bias)
    if not cuda_build.on_card(features):
        return sparse_conv_probe_plain(features.float(), rules,
                                       weights.float(), out_valid, bias,
                                       phases)
    return _run_forward(features, rules, weights, out_valid, bias, "probe",
                        phases, route)


def conv_dx(grad: torch.Tensor, rules_t: torch.Tensor,
            weights: torch.Tensor) -> torch.Tensor:
    """dx of the sparse conv: K1 on the transposed rulebook.

    grad f32 (B, V_out, Cout), already masked to the valid outputs;
    rules_t int32 (B, K, V_in) from ``sparse_conv.transpose_rules`` (V_out
    is its miss sentinel); weights bf16 (K, C, Cout). Returns f32
    (B, V_in, C): ``dx[i] = sum_k bf16(g[rules_t[k, i]]) @ W[K-1-k]^T``,
    which is ``sum_{k, j: rules[k, j] = i} g[j] @ W[k]^T``. The kernel's
    "C" is the forward's Cout and its "Cout" the forward's C."""
    g = grad.to(torch.bfloat16).contiguous()
    w_t = weights.flip(0).transpose(1, 2).contiguous()
    every = torch.ones(rules_t.shape[0], rules_t.shape[2], dtype=torch.bool,
                       device=g.device)
    check_operands(g, rules_t, w_t, every, None)
    if not cuda_build.on_card(g):
        return apply_conv_plain(g, rules_t, w_t, every, None, torch.float32)
    return _run_forward(g, rules_t, w_t, every, None, "dx")


def split_bf16(t: torch.Tensor):
    """The dW kernel's split of an f32 tensor: (hi, lo) as f32 tensors of
    bf16 values, hi = bf16(t) and lo = bf16(t - hi), so that
    |t - hi - lo| <= 2^-16 |t|."""
    hi = t.to(torch.bfloat16).float()
    return hi, (t - hi).to(torch.bfloat16).float()


def wgrad_plain(features: torch.Tensor, grad: torch.Tensor,
                rules: torch.Tensor) -> torch.Tensor:
    """Plain version of the dW kernel, with its rounding: per tap, the
    gathered rows (misses as zero rows) against the cotangent split into
    two bf16 parts (``split_bf16``), both products summed in f32. features
    (B, V_in, C), grad f32 (B, V_out, Cout), rules (B, K, V_out). Returns
    f32 (K, C, Cout)."""
    B, V_in, C = features.shape
    fpad = torch.cat([features.float(), features.new_zeros((B, 1, C),
                                                          dtype=torch.float32)],
                     dim=1)
    hi, lo = split_bf16(grad.float().reshape(-1, grad.shape[-1]))
    taps = []
    for k in range(rules.shape[1]):
        idx = rules[:, k].long()[..., None].expand(-1, -1, C)
        xt = torch.gather(fpad, 1, idx).reshape(-1, C).T
        taps.append(xt @ hi + xt @ lo)
    return torch.stack(taps)


def conv_wgrad(features: torch.Tensor, grad: torch.Tensor,
               rules: torch.Tensor) -> torch.Tensor:
    """dW of the sparse conv: x bf16, the f32 cotangent split into two bf16
    parts (``split_bf16``), f32 sums.

    features bf16 (B, V_in, C); grad f32 (B, V_out, Cout), masked to the
    valid outputs; rules int32 (B, K, V_out). Returns f32 (K, C, Cout). On
    a CUDA device this launches the kernel of ``csrc/sparse_conv_wgrad.cu``
    (or raises); on the CPU it runs ``wgrad_plain`` with the same split.
    C and Cout are zero-padded to widths in ``COUTS`` for the kernel."""
    if features.dtype != torch.bfloat16 or grad.dtype != torch.float32:
        raise TypeError("features must be bfloat16 and grad float32")
    if rules.dtype != torch.int32:
        raise TypeError("rules must be int32")
    for t in (grad, rules):
        if t.device != features.device:
            raise ValueError("all operands must be on one device")
    for t in (features, grad, rules):
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    if (features.dim() != 3 or rules.dim() != 3 or grad.dim() != 3
            or rules.shape[0] != features.shape[0]
            or grad.shape[:2] != (rules.shape[0], rules.shape[2])):
        raise ValueError(f"shape mismatch: features {tuple(features.shape)} "
                         f"grad {tuple(grad.shape)} rules "
                         f"{tuple(rules.shape)}")
    B, V_in, C = features.shape
    K, V_out = rules.shape[1], rules.shape[2]
    c_out = grad.shape[2]
    if not cuda_build.on_card(features):
        return wgrad_plain(features, grad, rules)
    if C > COUTS[-1] or c_out > COUTS[-1]:
        raise ValueError(f"dW kernel takes C, Cout <= {COUTS[-1]}; got "
                         f"C={C}, Cout={c_out}")
    cp = next(c for c in COUTS if c >= C)
    op = next(c for c in COUTS if c >= c_out)
    x = torch.nn.functional.pad(features, (0, cp - C)) if cp != C \
        else features
    g = torch.nn.functional.pad(grad, (0, op - c_out)) if op != c_out \
        else grad
    cuda_build.check_aligned(x, g)
    n_slices, per = wgrad_slices(B * V_out, K)
    hits = torch.empty((n_slices, K, 2, per), dtype=torch.int32,
                       device=x.device)
    partial = torch.empty((n_slices, K, cp, op), dtype=torch.float32,
                          device=x.device)
    dw = torch.empty((K, cp, op), dtype=torch.float32, device=x.device)
    fn = _load_wgrad()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    cuda_build.check_launch(fn(
        x.data_ptr(), g.data_ptr(), rules.data_ptr(), hits.data_ptr(),
        partial.data_ptr(), dw.data_ptr(), B, V_in, V_out, K, cp, op,
        n_slices, per, stream,
    ), "sparse_conv_wgrad")
    _launches.add("wgrad")
    return dw[:, :C, :c_out].contiguous() if (cp, op) != (C, c_out) else dw


class _SparseConvFn(torch.autograd.Function):
    """The JAX custom VJP of K1 (``sparse_conv_pallas.py:690-776``)."""

    @staticmethod
    def forward(ctx, features, weights, bias, rules, rules_t, out_valid):
        xb = features.to(torch.bfloat16).contiguous()
        wb = weights.to(torch.bfloat16).contiguous()
        out = sparse_conv(xb, rules, wb, out_valid, bias)
        ctx.save_for_backward(xb, wb, rules, rules_t, out_valid)
        ctx.dtypes = (features.dtype, weights.dtype)
        return out

    @staticmethod
    def backward(ctx, grad):
        xb, wb, rules, rules_t, out_valid = ctx.saved_tensors
        g = torch.where(out_valid[..., None], grad.float(), 0.0).contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = conv_dx(g, rules_t, wb).to(ctx.dtypes[0])
        if ctx.needs_input_grad[1]:
            dw = conv_wgrad(xb, g, rules).to(ctx.dtypes[1])
        if ctx.needs_input_grad[2]:
            db = g.sum((0, 1))
        return dx, dw, db, None, None, None


def sparse_conv_train(features: torch.Tensor, rules: torch.Tensor,
                      rules_t: torch.Tensor, weights: torch.Tensor,
                      out_valid: torch.Tensor,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable sparse conv on the kernels: features (B, V_in, C) and
    weights (K, C, Cout) in any float dtype (cast to bf16 inside), rules
    (B, K, V_out) and their transpose rules_t (B, K, V_in), out_valid
    (B, V_out), bias f32 (Cout,) or None. Returns f32 (B, V_out, Cout)."""
    return _SparseConvFn.apply(features, weights, bias, rules, rules_t,
                               out_valid)


def _round_bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16 values (kept in f32), with an identity gradient."""
    return t + (t.to(torch.bfloat16).float() - t).detach()


class _RoundGradBf16(torch.autograd.Function):
    """Identity whose backward rounds the cotangent to bf16 values."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def apply_conv_bf16_plain(features, rules, weights, out_valid, bias=None):
    """The plain version of ``sparse_conv_train``: autograd through
    ``apply_conv_plain`` with the kernels' rounding. Forward, dW and db see
    bf16-rounded features and weights against the f32 cotangent; dx comes
    from a second, value-free copy of the conv (``y2 - y2.detach()`` adds
    exact zeros) whose cotangent is rounded to bf16, as the dx kernel's is.
    Returns f32 (B, V_out, Cout)."""
    xb, wb = _round_bf16(features.float()), _round_bf16(weights.float())
    y = apply_conv_plain(xb.detach(), rules, wb, out_valid, bias,
                         torch.float32)
    if xb.requires_grad:
        y2 = _RoundGradBf16.apply(apply_conv_plain(
            xb, rules, wb.detach(), out_valid, None, torch.float32))
        y = y + (y2 - y2.detach())
    return y

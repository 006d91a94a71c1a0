// Sparse 3D convolution apply from z-run codes (K3), for Hopper.
//
// Replaces the TPU kernel focalformer3d_tpu/ops/sparse_conv_zrun.py:_zkernel.
// It computes the same conv as the sparse-conv kernel K1 (sparse_conv.cu),
// with K1's rounding (bf16 operands, f32 accumulation, bias added once
// outside the sum over taps, inactive sites zero):
//
//   out[b, j, :] = out_valid[b, j] ? bias + sum_k feats[b, rule_k(j), :] @ W[k]
//                                  : 0
//
// but reads its rules as one code per (output site, BEV tap r = dy*kx + dx)
// instead of one rule per (site, tap). CSR order is z-minor, so the present
// z taps of one site in one input column are consecutive CSR rows. A code is
//
//   code = (anchor << 3) | pattern      (0 when no tap is present)
//
// where bit dz of pattern says that tap dz (z = z0 + dz) is present and
// anchor is the CSR position of the first present one: tap dz reads row
// anchor + popcount(pattern & ((1 << dz) - 1)). So the pattern "z0 and
// z0 + 2 present, z0 + 1 absent" reads anchor and anchor + 1. The TPU
// kernel's 4-block shifted operand (e0..e3), window-relative anchors and
// spill lists exist because a TPU gathers rows badly; a card reads the rows.
//
// What bounds it on this card. By bytes and operations it is bound by
// memory, as K1 (Cout FLOPs per gathered byte, far below the H100's ~295):
// 0.1328 ms of bytes per eval scan (11 convs). Measured on an NVIDIA H100
// 80GB HBM3 at 700 W, by CUDA-graph replay: the first version of this
// kernel (WMMA, one block per 128-site tile) took 2.22 ms per scan, 17x
// the bound. It had K1's old structure, whose product and barriers, not
// its gather, took the time (K1's phase probe, tools/micro_mxu_probe.py):
// WMMA fragments loaded from unswizzled shared rows, two block-wide
// barriers and a gather through registers per BEV tap with nothing in
// flight under the product, 3C x Cout of W restaged from L2 for every tap
// of every tile. This version takes 1.14 ms per scan, 8.6x the bound: the
// 32-channel convs fell 2-3x, the two 16-channel ones (0.07, 0.06 ms) did
// not move. What holds it now is what holds K1: the barrier that ends
// every stage entry drains the tensor pipe, and a group has one entry's
// gather in flight under its product.
//
// What the design does about that: it is K1's kernel (sparse_conv_tile.cuh,
// mode kZrun), with the 3C-deep contraction per BEV tap kept.
// - Persistent blocks; the tile's R x 128 codes are copied by cp.async once
//   per tile, the next tile's under this tile's loop, and each thread votes
//   on the codes it copied: bit 3 r + dz of a 16-row strip's mask is set
//   where a site of the strip has z tap dz of BEV tap r. One block-wide
//   barrier a tile.
// - A stage entry is one BEV tap: a 128 x 3C gathered tile in the KB32
//   layout, filled by 16-byte cp.async from the decoded rows (zero fill
//   where the pattern lacks the tap or the row is past V_in), and the
//   3C x Cout slice of W. So a tile waits at R = 9 barriers, not K1's 27,
//   and a group (16-row strip on mma.sync, 64 rows on wgmma) gathers and
//   multiplies only the C-deep thirds its sites use, and skips BEV taps
//   none of them uses.
// - W is packed once by the wrapper (pack_zrun_weights: tap 3 r + dz holds
//   W[dz * R + r] in K1's shared-memory image), resident where all taps fit
//   beside three stages, else streamed one entry per stage.
// - Where two 3C stages do not fit beside W (C = 128 at Cout >= 32: a 3C
//   stage is 96 KB) a stage holds one z tap (one C-deep third) at a time,
//   as K1 holds one tap; sparse_conv_zrun_grid reports the choice.
// - The route, wgmma m64nCOUTk16 or mma.sync m16n8k16, is the wrapper's per
//   width; the epilogue (bias, out_valid, stores from registers) is K1's.

#include <stdint.h>

#include "sparse_conv_tile.cuh"

using namespace sparse_tile;

namespace {

// The z taps one stage holds: three where two such stages fit beside W.
int zrun_tps(int n_bev, int c, int cout) {
  return make_plan(n_bev, 3 * n_bev, c, cout, 3).smem > 0 ? 3 : 1;
}

Geometry zrun_geometry(int batch, int v_in, int v_out, int n_bev, int c,
                       int cout) {
  return {batch, v_in, v_out, n_bev, 3 * n_bev, c, cout,
          zrun_tps(n_bev, c, cout)};
}

}  // namespace

// C interface, loaded with ctypes. c must be a multiple of 16 (<= 128),
// cout one of 16, 32, 64, 128, n_bev <= 10; wp is W packed by the wrapper
// (pack_zrun_weights: 3 * n_bev taps, tap 3 r + dz); route 0 is wgmma, 1
// mma.sync; grid the number of persistent blocks (sparse_conv_zrun_grid).
// The caller checks shapes, dtypes, contiguity and alignment. Returns the
// cudaError_t of the launch.
extern "C" int sparse_conv_zrun_forward(const void* feats, const void* codes,
                                        const void* wp, const void* bias,
                                        const void* out_valid, void* out,
                                        int batch, int v_in, int v_out,
                                        int n_bev, int c, int cout, int route,
                                        int grid, void* stream) {
  return dispatch<kFull, kZrun>(
      feats, codes, wp, bias, out_valid, out,
      zrun_geometry(batch, v_in, v_out, n_bev, c, cout), route, grid, stream);
}

// The persistent grid of one conv; writes the plan's stages, residency,
// shared-memory bytes and z taps per stage to info[0..3] where info is not
// null. Returns the grid, or minus a cudaError_t.
extern "C" int sparse_conv_zrun_grid(int batch, int v_out, int n_bev, int c,
                                     int cout, int route, int* info) {
  return grid_for<kZrun>(zrun_geometry(batch, 0, v_out, n_bev, c, cout),
                         route, info);
}

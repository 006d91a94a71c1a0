// Sparse 3D convolution apply over an absolute rulebook (K1), for Hopper.
//
// Replaces the TPU kernel focalformer3d_tpu/ops/sparse_conv_pallas.py:_kernel
// (the windowed one-hot MXU gather + per-tile spill correction). It computes
// the function of the exact engine, sparse_conv.apply_conv, with K1's
// rounding (bf16 operands, f32 accumulation):
//
//   out[b, j, :] = out_valid[b, j] ? bias + sum_k feats[b, rules[b, k, j], :] @ W[k]
//                                  : 0
//
// with rules[b, k, j] == V_in meaning "no input on this tap". The card reads
// rows directly through the rulebook, so the TPU's windows, spill lists and
// overflow reroute have no counterpart here. No atomics: every output site
// is summed by one thread in one order, so two runs give the same bits.
//
// What bounds it on this card. By bytes and operations it is bound by
// memory (Cout FLOPs per gathered byte, far below the card's ~295), but the
// first version of this kernel did not spend its time there: measured on an
// H100 with the phase switches below, from C = 32 on the product took 79%
// (C 32) to 91% (C 64) of the kernel and the row gather 31% to 13%, with
// nothing overlapping. The product ran every 16-row strip of a 128-site
// tile through every tap that any site of the tile used (useful work at
// 2-6 TFLOP/s), restaged W[k] from L2 per tap and tile, read unswizzled
// rows with bank conflicts, and stood behind two block-wide barriers and
// one rule load per tap.
//
// What the design does about that:
// - Rules once. A block copies the K x 128 rules of its tile in one pass
//   (asynchronously, 128 bytes a warp and tap row, the next tile's under
//   this tile's tap loop) into shared memory and builds, with ballots, a
//   K-bit hit mask per 16-row strip (each thread votes on the rules it
//   copied, one warp reduction per strip); 64-row and tile masks are their
//   ORs. One block-wide barrier a tile, not K.
// - Skipping at the instruction's granularity. A group (the rows one
//   instruction covers: a 16-row strip on the mma.sync route, 64 rows on
//   the wgmma route) with no hit on tap k starts neither the gather nor the
//   product of that tap; the tap loop visits only the taps the tile uses.
// - W on the SM. The wrapper packs W once into the shared-memory image
//   (pack_weights: per tap, W[k]^T in the KB32 layout of mma_sm90.cuh).
//   Where all K taps fit beside the stages they are copied once per block,
//   and the block is persistent: the grid is what fits on the card at once
//   and each block loops over tiles t = blockIdx.x, + gridDim.x, ... of the
//   batch's tiles, so W is read once per resident block, not once per tile
//   and tap. Where they do not fit (64x64 and wider) W[k] streams through
//   the same ring as the gathered rows, only for taps the tile uses.
// - A pipelined gather. Two to four stages of the gathered tile, filled by
//   16-byte cp.async with zero fill for the misses: the rows of the next
//   used taps are in flight under the product of this one, with one barrier
//   per used tap. Where W is resident that barrier is the group's own (a
//   __syncwarp or a 128-thread named barrier) and each group walks only the
//   taps it uses; where W streams it is block-wide over the tile's taps.
// - No bank conflicts. Gathered rows and W land in the KB32 layout, whose
//   swizzle both the wgmma descriptor and ldmatrix read without conflict;
//   each thread computes the destination of its 16-byte chunks itself (lane
//   pairs write 32 contiguous bytes, a warp 512).
// - The product is wgmma.mma_async m64nCOUTk16 by two warpgroups or
//   mma.sync m16n8k16 by eight warps over the same tiles (ROUTE_WGMMA of the
//   template); the accumulators have one layout, so the epilogue (bias, the
//   out_valid mask, 8-byte stores straight from registers) is shared. The
//   wrapper chooses the route per width (route_for in
//   ops/sparse_conv_cuda.py, which states the numbers): wgmma from C = 64
//   on, where it multiplies 1.5-1.7x faster than mma.sync at K1's shapes
//   (kernel A: 210 against 144 TFLOP/s at 64x64, 292 against 175 at
//   128x128) and 64-row skipping leaves 0.98 of the (group, tap) pairs
//   against 0.96 for 16-row strips; mma.sync below, where both run at the
//   same rate (73 against 76 TFLOP/s at 32x32, 19 against 20 at 16x16) and
//   strips skip more (0.69 against 0.87 at L0 of a 200k-point scan).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, 27-tap submanifold convs of
// a radial 200k-point scan: 16x16 at 160 000 sites 0.064 ms, 32x32 at
// 245 760 sites 0.148 ms, 64x64 at 188 416 sites 0.218 ms, 128x128 at
// 77 824 sites 0.233 ms; 5-7x the byte bound (the WMMA version stood
// 17-19x above it: 64x64 on a random set of 187 392 sites took 1.08 ms,
// this kernel 0.19). What is left: every tap ends in a barrier
// that drains the tensor pipe, the widest widths hold one block per SM, and
// each feature row is read from L2 once per tap that hits it.
//
// Phase switches (the probe of focalformer3d_tpu_torch/tools/): the template
// parameter PHASES keeps the gather (kGather) and the product (kMma: W's
// copies and the tensor-core instructions) or drops either, to split the
// kernel's time as the TPU probes did with copies of their kernel
// (tools/micro_mxu_probe.py:_variant_kernel, micro_pallas_attr.py:
// variant_kernel, micro_batch_grid.py:_kernel_flat, micro_kernel_v2.py:
// _kernel_v2). With a pipeline "gather only" means that the copies are
// started and waited for and no product runs; "product only" multiplies
// stages zeroed once at the start of the block; with neither bit the rule
// pass, the masks, the barriers of the tap loop and the epilogue run. A
// mode without both bits computes out_valid ? bias : 0.
// sparse_conv_forward instantiates PHASES = kFull only, so production K1 is
// this same code; sparse_conv_probe takes the mode at run time.
//
// The kernel itself is sparse_conv_tile.cuh's, in mode kRules (one tap per
// stage); K3 (sparse_conv_zrun.cu) runs the same kernel on z-run codes.

#include <stdint.h>

#include "sparse_conv_tile.cuh"

using namespace sparse_tile;

namespace {

Geometry rules_geometry(int batch, int v_in, int v_out, int n_taps, int c,
                        int cout) {
  return {batch, v_in, v_out, n_taps, n_taps, c, cout, 1};
}

}  // namespace

// C interface, loaded with ctypes. c must be a multiple of 16 (<= 128),
// cout one of 16, 32, 64, 128, n_taps <= 32; wp is W packed by the wrapper
// (pack_weights); route 0 is wgmma, 1 mma.sync; grid is the number of
// persistent blocks (sparse_conv_grid gives what the card holds at once).
// The caller checks shapes, dtypes, contiguity and alignment. Returns the
// cudaError_t of the launch.
extern "C" int sparse_conv_forward(const void* feats, const void* rules,
                                   const void* wp, const void* bias,
                                   const void* out_valid, void* out, int batch,
                                   int v_in, int v_out, int n_taps, int c,
                                   int cout, int route, int grid,
                                   void* stream) {
  return dispatch<kFull, kRules>(
      feats, rules, wp, bias, out_valid, out,
      rules_geometry(batch, v_in, v_out, n_taps, c, cout), route, grid,
      stream);
}

// The same kernel with the phases of `phases` (bits kGather = 1, kMma = 2);
// phases 3 is sparse_conv_forward's instantiation itself.
extern "C" int sparse_conv_probe(const void* feats, const void* rules,
                                 const void* wp, const void* bias,
                                 const void* out_valid, void* out, int batch,
                                 int v_in, int v_out, int n_taps, int c,
                                 int cout, int route, int grid, int phases,
                                 void* stream) {
  const Geometry g = rules_geometry(batch, v_in, v_out, n_taps, c, cout);
  switch (phases) {
    case 0: return dispatch<0, kRules>(feats, rules, wp, bias, out_valid, out, g, route, grid, stream);
    case kGather: return dispatch<kGather, kRules>(feats, rules, wp, bias, out_valid, out, g, route, grid, stream);
    case kMma: return dispatch<kMma, kRules>(feats, rules, wp, bias, out_valid, out, g, route, grid, stream);
    case kFull: return dispatch<kFull, kRules>(feats, rules, wp, bias, out_valid, out, g, route, grid, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The persistent grid of one conv (grid_for of sparse_conv_tile.cuh):
// writes the plan's stages, residency and shared-memory bytes to
// info[0..2] (info holds 4 ints) where info is not null. Returns the grid,
// or minus a cudaError_t.
extern "C" int sparse_conv_grid(int batch, int v_out, int n_taps, int c,
                                int cout, int route, int* info) {
  return grid_for<kRules>(rules_geometry(batch, 0, v_out, n_taps, c, cout),
                          route, info);
}

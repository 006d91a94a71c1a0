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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

using namespace mma90;

namespace {

constexpr int kTile = 128;     // output sites per tile
constexpr int kThreads = 256;  // 8 warps = 2 warpgroups
constexpr int kMaxTaps = 32;   // one mask bit per tap
constexpr int kGather = 1;     // gather the tile's rows
constexpr int kMma = 2;        // copy W and run the tensor-core product
constexpr int kFull = kGather | kMma;
constexpr int kMaxSmem = 227 * 1024;

// Shared memory of one block: W (all taps, or one per stage), the stages of
// gathered rows, this tile's and the next tile's rules, the strips' partial
// masks.
struct Plan {
  int stages;    // 2 to 4
  int resident;  // 1: all taps of W stay in shared memory
  int smem;      // bytes; 0 if nothing fits
};

__host__ __device__ inline int w_tile_bytes(int c, int cout) {
  return c * cout * 2;
}
__host__ __device__ inline int a_stage_bytes(int c) { return kTile * c * 2; }

inline Plan make_plan(int n_taps, int c, int cout) {
  const int fixed = 2 * (n_taps * kTile * 4 + 16 * 4);
  const int w1 = w_tile_bytes(c, cout), a1 = a_stage_bytes(c);
  // W resident where it fits beside three stages; then the deepest
  // pipeline that still lets two blocks share an SM, else the deepest that
  // fits at all
  const int resident = n_taps * w1 + 3 * a1 + fixed <= kMaxSmem;
  const int base = resident ? n_taps * w1 + fixed : fixed;
  const int per_stage = resident ? a1 : w1 + a1;
  for (int s = 4; s >= 2; --s) {
    if (base + s * per_stage <= kMaxSmem / 2 - 1024) {
      return {s, resident, base + s * per_stage};
    }
  }
  for (int s = 3; s >= 2; --s) {
    if (base + s * per_stage <= kMaxSmem) {
      return {s, resident, base + s * per_stage};
    }
  }
  return {0, 0, 0};
}

template <int COUT, int PHASES, bool WG>
__global__ void __launch_bounds__(kThreads)
sparse_conv_kernel(const __nv_bfloat16* __restrict__ feats,  // (B, V_in, C)
                   const int32_t* __restrict__ rules,        // (B, K, V_out)
                   const __nv_bfloat16* __restrict__ wp,     // packed W
                   const float* __restrict__ bias,           // (COUT,) or null
                   const uint8_t* __restrict__ out_valid,    // (B, V_out)
                   float* __restrict__ out,                  // (B, V_out, COUT)
                   int batch, int v_in, int v_out, int n_taps, int c,
                   int stages, int resident) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int w1 = w_tile_bytes(c, COUT), a1 = a_stage_bytes(c);
  const int w_bytes = (resident ? n_taps : stages) * w1;
  const uint32_t w_addr = smem_u32(smem);
  const uint32_t a_addr = w_addr + w_bytes;
  int32_t* r_all = reinterpret_cast<int32_t*>(smem + w_bytes + stages * a1);
  uint32_t* mpart = reinterpret_cast<uint32_t*>(r_all + 2 * n_taps * kTile);
  // (two buffers of 16 partial masks: strip s of tap parity p at [8 p + s])

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wg = tid >> 7;
  const int kblocks = c / 16;
  // gather: thread t copies half gh of row t / 2 (a lane pair one 32-byte
  // K-block row); rows 16 w.. belong to warp w, rows 64 g.. to warpgroup g
  const int grow = tid >> 1;
  const int gh = tid & 1;

  if constexpr ((PHASES & kMma) != 0) {
    if (resident) {  // every tap of W, once per block
      for (int i = tid; i < n_taps * w1 / 16; i += kThreads) {
        cp_async16(w_addr + i * 16, wp + (size_t)i * 8);
      }
      cp_async_commit();  // waited for with the first tile's rules
    }
  }
  if constexpr ((PHASES & kGather) == 0) {
    // the product alone reads zeroed stages (barriers follow before it)
    for (int i = tid; i < stages * a1 / 16; i += kThreads) {
      reinterpret_cast<uint4*>(smem + w_bytes)[i] = make_uint4(0, 0, 0, 0);
    }
  }

  const int tiles_per_sample = (v_out + kTile - 1) / kTile;
  const int n_tiles = batch * tiles_per_sample;
  // the K x 128 rules of tile t, copied asynchronously (4 bytes each: a
  // rulebook row starts at any multiple of 4) into rules buffer `buf`;
  // thread i takes site i % 128 of the taps of parity i / 128
  auto fetch_rules = [&](int t, int buf) {
    if (t < n_tiles) {
      const int b = t / tiles_per_sample;
      const int s = (t - b * tiles_per_sample) * kTile + (tid & 127);
      const int32_t* src = rules + (size_t)b * n_taps * v_out + s;
      const uint32_t dst = smem_u32(r_all + buf * n_taps * kTile + (tid & 127));
      if (s < v_out) {  // sites past V_out are set to misses by the mask pass
        for (int k = tid >> 7; k < n_taps; k += 2) {
          cp_async4(dst + k * kTile * 4, src + (size_t)k * v_out);
        }
      }
    }
    cp_async_commit();
  };
  int buf = 0;
  fetch_rules(blockIdx.x, 0);
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, buf ^= 1) {
    const int b = t / tiles_per_sample;
    const int site0 = (t - b * tiles_per_sample) * kTile;
    const __nv_bfloat16* feats_b = feats + (size_t)b * v_in * c;
    int32_t* r_s = r_all + buf * n_taps * kTile;

    uint32_t* mp = mpart + buf * 16;

    cp_async_wait<0>();  // my share of this tile's rules (and of W) has landed
    // my two output sites' validity, read early and used in the epilogue
    const uint8_t* valid_b = out_valid + (size_t)b * v_out;
    const int s_out = site0 + 16 * warp + (lane >> 2);
    uint8_t valid0 = 0, valid1 = 0;
    if (s_out < v_out) valid0 = valid_b[s_out];
    if (s_out + 8 < v_out) valid1 = valid_b[s_out + 8];
    {
      // each thread votes on the rules it copied itself (site i % 128, the
      // taps of parity i / 128), so no barrier stands before the vote; a
      // warp covers two 16-row strips of one parity
      const int site = tid & 127;
      const bool inside = site0 + site < v_out;
      uint32_t m = 0;
      for (int k = tid >> 7; k < n_taps; k += 2) {
        int32_t* slot = r_s + k * kTile + site;
        if (!inside) {
          *slot = v_in;  // a site past V_out misses every tap
        } else if ((unsigned)*slot < (unsigned)v_in) {
          m |= 1u << k;
        }
      }
      const uint32_t lo = __reduce_or_sync(0xffffffffu, lane < 16 ? m : 0u);
      const uint32_t hi = __reduce_or_sync(0xffffffffu, lane < 16 ? 0u : m);
      if (lane == 0) {
        mp[2 * warp] = lo;  // strip 2 (w % 4) of parity w / 4
        mp[2 * warp + 1] = hi;
      }
    }
    if constexpr (WG) fence_proxy_async();  // W and zeroed stages, first tile
    // The tile's one block-wide barrier: the rules, masks (and W) of every
    // thread are visible, and every thread has left the previous tile, so
    // the other rules buffer and, where W streams, the ring are free. The
    // masks alternate between two buffers like the rules, so a fast warp's
    // next vote cannot overwrite masks a slow warp still has to read.
    __syncthreads();
    fetch_rules(t + gridDim.x, buf ^ 1);  // lands under this tile's tap loop

    uint32_t tmask = 0, gmask = 0;  // taps the tile / my group uses
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t mi = mp[i] | mp[8 + i];
      tmask |= mi;
      if (WG ? (i >> 2) == wg : i == warp) gmask |= mi;
    }

    float acc[COUT / 2];
#pragma unroll
    for (int i = 0; i < COUT / 2; ++i) acc[i] = 0.0f;

    // copies of tap k into stage st: my half row (zeros for a miss) where my
    // group uses the tap, and my share of W[k] where W streams
    auto copy_tap = [&](int k, int st) {
      if constexpr ((PHASES & kGather) != 0) {
        if ((gmask >> k) & 1) {
          const int r = r_s[k * kTile + grow];
          const bool hit = (unsigned)r < (unsigned)v_in;
          const __nv_bfloat16* src = feats_b + (size_t)(hit ? r : 0) * c + gh * 8;
          const uint32_t dst = a_addr + st * a1 + kb32_offset(kTile, grow, 0, gh);
          for (int j = 0; j < kblocks; ++j) {
            cp_async16(dst + j * kTile * 32, src + j * 16, hit ? 16 : 0);
          }
        }
      }
      if constexpr ((PHASES & kMma) != 0) {
        if (!resident) {
          const __nv_bfloat16* src = wp + (size_t)k * (w1 / 2);
          for (int i = tid; i < w1 / 16; i += kThreads) {
            cp_async16(w_addr + st * w1 + i * 16, src + i * 8);
          }
        }
      }
    };

    // Where W is resident a group shares nothing with the others inside the
    // tap loop (it gathers, multiplies and reuses only its own rows of the
    // stages), so each group walks its own taps behind its own barrier: a
    // warp's __syncwarp or a warpgroup's named barrier. Where W streams
    // through the ring the block walks the tile's taps together.
    const uint32_t lmask = resident ? gmask : tmask;
    auto sync = [&]() {
      if (!resident) {
        __syncthreads();
      } else if constexpr (WG) {
        named_barrier(1 + wg, 128);
      } else {
        __syncwarp();
      }
    };
    const int n_used = __popc(lmask);
    uint32_t to_copy = lmask, to_run = lmask;
    int st_copy = 0, st_run = 0;
    for (int p = 0; p < stages - 1; ++p) {
      if (to_copy) {
        copy_tap(__ffs(to_copy) - 1, st_copy);
        to_copy &= to_copy - 1;
      }
      cp_async_commit();
      st_copy = st_copy + 1 == stages ? 0 : st_copy + 1;
    }
    for (int i = 0; i < n_used; ++i) {
      // the copies of tap i are S - 2 groups back; after the barrier every
      // thread's have landed and every thread has left the product of tap
      // i - 1, whose stage the next copies overwrite
      switch (stages) {
        case 4: cp_async_wait<2>(); break;
        case 3: cp_async_wait<1>(); break;
        default: cp_async_wait<0>(); break;
      }
      if constexpr (WG) fence_proxy_async();  // wgmma reads what cp.async wrote
      sync();
      if (to_copy) {
        copy_tap(__ffs(to_copy) - 1, st_copy);
        to_copy &= to_copy - 1;
      }
      cp_async_commit();
      st_copy = st_copy + 1 == stages ? 0 : st_copy + 1;

      const int k = __ffs(to_run) - 1;
      to_run &= to_run - 1;
      if constexpr ((PHASES & kMma) != 0) {
        if ((gmask >> k) & 1) {
          const uint32_t a_tile = a_addr + st_run * a1;
          const uint32_t w_tile = w_addr + (resident ? k : st_run) * w1;
          if constexpr (WG) {
            wgmma_fence();
            for (int j = 0; j < kblocks; ++j) {
              wgmma_m64k16(acc, wgmma_desc(a_tile + (j * kTile + 64 * wg) * 32),
                           wgmma_desc(w_tile + j * COUT * 32));
            }
            wgmma_commit();
            wgmma_wait<0>();
          } else {
            for (int j = 0; j < kblocks; ++j) {
              warp_mma_k16<COUT>(acc, a_tile, kTile, 16 * warp, w_tile, COUT,
                                 0, j, lane);
            }
          }
        }
      }
      st_run = st_run + 1 == stages ? 0 : st_run + 1;
    }
    // bias, the out_valid mask and the store, from registers: also for a
    // tile on which every tap missed
    float* out_b = out + (size_t)b * v_out * COUT;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int s = s_out + 8 * half;
      if (s < v_out) {
        const bool valid = (half ? valid1 : valid0) != 0;
#pragma unroll
        for (int nb = 0; nb < COUT / 8; ++nb) {
          const int o = nb * 8 + 2 * (lane & 3);
          float2 v = make_float2(0.0f, 0.0f);
          if (valid) {
            v.x = acc[4 * nb + 2 * half];
            v.y = acc[4 * nb + 2 * half + 1];
            if (bias != nullptr) {
              v.x += bias[o];
              v.y += bias[o + 1];
            }
          }
          *reinterpret_cast<float2*>(out_b + (size_t)s * COUT + o) = v;
        }
      }
    }
  }
}

template <int COUT, int PHASES, bool WG>
cudaError_t launch(const void* feats, const int32_t* rules, const void* wp,
                   const float* bias, const uint8_t* out_valid, float* out,
                   int batch, int v_in, int v_out, int n_taps, int c, int grid,
                   cudaStream_t stream) {
  const Plan plan = make_plan(n_taps, c, COUT);
  if (plan.smem == 0) return cudaErrorInvalidValue;
  auto kernel = sparse_conv_kernel<COUT, PHASES, WG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, plan.smem, stream>>>(
      static_cast<const __nv_bfloat16*>(feats), rules,
      static_cast<const __nv_bfloat16*>(wp), bias, out_valid, out, batch,
      v_in, v_out, n_taps, c, plan.stages, plan.resident);
  return cudaGetLastError();
}

template <int PHASES, bool WG>
int dispatch(const void* feats, const void* rules, const void* wp,
             const void* bias, const void* out_valid, void* out, int batch,
             int v_in, int v_out, int n_taps, int c, int cout, int grid,
             void* stream) {
  if (v_out == 0 || batch == 0) return 0;
  if (n_taps < 1 || n_taps > kMaxTaps || c % 16 != 0 || grid < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int32_t* r = static_cast<const int32_t*>(rules);
  const float* bs = static_cast<const float*>(bias);
  const uint8_t* vl = static_cast<const uint8_t*>(out_valid);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cout) {
    case 16: return launch<16, PHASES, WG>(feats, r, wp, bs, vl, o, batch, v_in, v_out, n_taps, c, grid, st);
    case 32: return launch<32, PHASES, WG>(feats, r, wp, bs, vl, o, batch, v_in, v_out, n_taps, c, grid, st);
    case 64: return launch<64, PHASES, WG>(feats, r, wp, bs, vl, o, batch, v_in, v_out, n_taps, c, grid, st);
    case 128: return launch<128, PHASES, WG>(feats, r, wp, bs, vl, o, batch, v_in, v_out, n_taps, c, grid, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int PHASES>
int route_dispatch(const void* feats, const void* rules, const void* wp,
                   const void* bias, const void* out_valid, void* out,
                   int batch, int v_in, int v_out, int n_taps, int c, int cout,
                   int route, int grid, void* stream) {
  if (route == 0) return dispatch<PHASES, true>(feats, rules, wp, bias, out_valid, out, batch, v_in, v_out, n_taps, c, cout, grid, stream);
  if (route == 1) return dispatch<PHASES, false>(feats, rules, wp, bias, out_valid, out, batch, v_in, v_out, n_taps, c, cout, grid, stream);
  return (int)cudaErrorInvalidValue;
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
  return route_dispatch<kFull>(feats, rules, wp, bias, out_valid, out, batch,
                               v_in, v_out, n_taps, c, cout, route, grid,
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
  switch (phases) {
    case 0: return route_dispatch<0>(feats, rules, wp, bias, out_valid, out, batch, v_in, v_out, n_taps, c, cout, route, grid, stream);
    case kGather: return route_dispatch<kGather>(feats, rules, wp, bias, out_valid, out, batch, v_in, v_out, n_taps, c, cout, route, grid, stream);
    case kMma: return route_dispatch<kMma>(feats, rules, wp, bias, out_valid, out, batch, v_in, v_out, n_taps, c, cout, route, grid, stream);
    case kFull: return route_dispatch<kFull>(feats, rules, wp, bias, out_valid, out, batch, v_in, v_out, n_taps, c, cout, route, grid, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The persistent grid of one conv: the blocks the card holds at once
// (blocks per SM by the kernel's registers and shared memory, times the
// SMs), at most one per tile. Writes the plan's stages, residency and
// shared-memory bytes to info[0..2] where info is not null. Returns the
// grid, or minus a cudaError_t.
extern "C" int sparse_conv_grid(int batch, int v_out, int n_taps, int c,
                                int cout, int route, int* info) {
  const Plan plan = make_plan(n_taps, c, cout);
  if (plan.smem == 0) return -(int)cudaErrorInvalidValue;
  if (info != nullptr) {
    info[0] = plan.stages;
    info[1] = plan.resident;
    info[2] = plan.smem;
  }
  const void* kernel = nullptr;
  switch (cout * 2 + (route != 0)) {
    case 32: kernel = (const void*)sparse_conv_kernel<16, kFull, true>; break;
    case 33: kernel = (const void*)sparse_conv_kernel<16, kFull, false>; break;
    case 64: kernel = (const void*)sparse_conv_kernel<32, kFull, true>; break;
    case 65: kernel = (const void*)sparse_conv_kernel<32, kFull, false>; break;
    case 128: kernel = (const void*)sparse_conv_kernel<64, kFull, true>; break;
    case 129: kernel = (const void*)sparse_conv_kernel<64, kFull, false>; break;
    case 256: kernel = (const void*)sparse_conv_kernel<128, kFull, true>; break;
    case 257: kernel = (const void*)sparse_conv_kernel<128, kFull, false>; break;
    default: return -(int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
  if (err != cudaSuccess) return -(int)err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return -(int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return -(int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, plan.smem);
  if (err != cudaSuccess) return -(int)err;
  const int tiles = batch * ((v_out + kTile - 1) / kTile);
  const int held = sms * (per_sm > 0 ? per_sm : 1);
  return tiles < held ? (tiles > 0 ? tiles : 1) : held;
}

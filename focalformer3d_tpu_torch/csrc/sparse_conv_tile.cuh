// The tile kernel of the port's two sparse-conv applies on Hopper: K1
// (sparse_conv.cu, one absolute rule per output site and tap) and K3
// (sparse_conv_zrun.cu, one z-run code per output site and BEV tap). Both
// compute
//
//   out[b, j, :] = out_valid[b, j] ? bias + sum_t feats[b, row_t(j), :] @ W[t]
//                                  : 0
//
// with bf16 operands and f32 sums; they differ only in how a block reads
// row_t(j) and in how many taps one pipeline stage holds. The sources'
// headers say what bounds each kernel and what the design does about it;
// this file holds the code they share.
//
// Index modes (template parameter MODE):
// - kRules: the index is (B, K, V_out) rules, rules[b, t, j] the CSR row of
//   tap t or v_in for a miss; one tap per stage.
// - kZrun: the index is (B, R, V_out) codes, code = (anchor << 3) | pattern
//   for BEV tap r: z tap dz is present where bit dz of pattern is set and
//   reads CSR row anchor + popcount(pattern & ((1 << dz) - 1)). Tap t of
//   the kernel is 3 r + dz (W packed in that order). A stage holds `tps`
//   taps: the three z taps of one BEV tap (a 128 x 3C gathered tile and a
//   3C x Cout slice of W, one barrier per BEV tap) or, where two such
//   stages do not fit beside W, one z tap.
//
// Hit masks: bit t of a 16-row strip's mask is set where a site of the
// strip reads tap t (kRules: a rule below v_in; kZrun: bit dz of the
// pattern). A stage entry is a run of `tps` taps starting at t0; a group
// (16-row strip on the mma.sync route, 64-row group on wgmma) gathers and
// multiplies only the taps of an entry that its mask holds, so a strip
// with no site at z0 + 2 skips that third of a 3C contraction.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace sparse_tile {

using namespace mma90;

constexpr int kTile = 128;     // output sites per tile
constexpr int kThreads = 256;  // 8 warps = 2 warpgroups
constexpr int kMaxTaps = 32;   // one mask bit per tap
constexpr int kGather = 1;     // gather the tile's rows
constexpr int kMma = 2;        // copy W and run the tensor-core product
constexpr int kFull = kGather | kMma;
constexpr int kMaxSmem = 227 * 1024;
constexpr int kRules = 0;      // index: absolute rules per tap
constexpr int kZrun = 1;       // index: z-run codes per BEV tap

// Shared memory of one block: W (all taps, or one entry per stage), the
// stages of gathered rows, this tile's and the next tile's index rows, the
// strips' partial masks.
struct Plan {
  int stages;    // 2 to 4
  int resident;  // 1: all taps of W stay in shared memory
  int smem;      // bytes; 0 if nothing fits
};

// n_idx index rows per site (K rules or R codes), n_taps taps of W, tps
// taps per stage entry, c channels per tap.
inline Plan make_plan(int n_idx, int n_taps, int c, int cout, int tps) {
  const int fixed = 2 * (n_idx * kTile * 4 + 16 * 4);
  const int w_tap = c * cout * 2;
  const int w1 = tps * w_tap, a1 = kTile * tps * c * 2;
  // W resident where it fits beside three stages; then the deepest
  // pipeline that still lets two blocks share an SM, else the deepest that
  // fits at all
  const int resident = n_taps * w_tap + 3 * a1 + fixed <= kMaxSmem;
  const int base = resident ? n_taps * w_tap + fixed : fixed;
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

// The taps that open a stage entry among the taps of mask m: every tap
// where an entry is one tap, else bit 3 r where BEV tap r has any z tap.
__device__ __forceinline__ uint32_t entry_starts(uint32_t m, int tps) {
  return tps == 1 ? m : ((m | (m >> 1) | (m >> 2)) & 0x09249249u);
}

template <int COUT, int PHASES, bool WG, int MODE>
__global__ void __launch_bounds__(kThreads)
sparse_conv_kernel(const __nv_bfloat16* __restrict__ feats,  // (B, V_in, C)
                   const int32_t* __restrict__ index,        // (B, n_idx, V_out)
                   const __nv_bfloat16* __restrict__ wp,     // packed W
                   const float* __restrict__ bias,           // (COUT,) or null
                   const uint8_t* __restrict__ out_valid,    // (B, V_out)
                   float* __restrict__ out,                  // (B, V_out, COUT)
                   int batch, int v_in, int v_out, int n_idx, int n_taps,
                   int c, int tps_arg, int stages, int resident) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int tps = MODE == kZrun ? tps_arg : 1;
  const int w_tap = c * COUT * 2;
  const int w1 = tps * w_tap, a1 = kTile * tps * c * 2;
  const int w_bytes = resident ? n_taps * w_tap : stages * w1;
  const uint32_t w_addr = smem_u32(smem);
  const uint32_t a_addr = w_addr + w_bytes;
  int32_t* r_all = reinterpret_cast<int32_t*>(smem + w_bytes + stages * a1);
  uint32_t* mpart = reinterpret_cast<uint32_t*>(r_all + 2 * n_idx * kTile);
  // (two buffers of 16 partial masks: strip s of index parity p at [8 p + s])

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
      for (int i = tid; i < n_taps * w_tap / 16; i += kThreads) {
        cp_async16(w_addr + i * 16, wp + (size_t)i * 8);
      }
      cp_async_commit();  // waited for with the first tile's index rows
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
  // the n_idx x 128 index entries of tile t, copied asynchronously (4 bytes
  // each: an index row starts at any multiple of 4) into buffer `buf`;
  // thread i takes site i % 128 of the index rows of parity i / 128
  auto fetch_index = [&](int t, int buf) {
    if (t < n_tiles) {
      const int b = t / tiles_per_sample;
      const int s = (t - b * tiles_per_sample) * kTile + (tid & 127);
      const int32_t* src = index + (size_t)b * n_idx * v_out + s;
      const uint32_t dst = smem_u32(r_all + buf * n_idx * kTile + (tid & 127));
      if (s < v_out) {  // sites past V_out are set to misses by the vote
        for (int k = tid >> 7; k < n_idx; k += 2) {
          cp_async4(dst + k * kTile * 4, src + (size_t)k * v_out);
        }
      }
    }
    cp_async_commit();
  };
  int buf = 0;
  fetch_index(blockIdx.x, 0);
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, buf ^= 1) {
    const int b = t / tiles_per_sample;
    const int site0 = (t - b * tiles_per_sample) * kTile;
    const __nv_bfloat16* feats_b = feats + (size_t)b * v_in * c;
    int32_t* r_s = r_all + buf * n_idx * kTile;

    uint32_t* mp = mpart + buf * 16;

    cp_async_wait<0>();  // my share of this tile's index (and of W) landed
    // my two output sites' validity, read early and used in the epilogue
    const uint8_t* valid_b = out_valid + (size_t)b * v_out;
    const int s_out = site0 + 16 * warp + (lane >> 2);
    uint8_t valid0 = 0, valid1 = 0;
    if (s_out < v_out) valid0 = valid_b[s_out];
    if (s_out + 8 < v_out) valid1 = valid_b[s_out + 8];
    {
      // each thread votes on the index entries it copied itself (site
      // i % 128, the rows of parity i / 128), so no barrier stands before
      // the vote; a warp covers two 16-row strips of one parity
      const int site = tid & 127;
      const bool inside = site0 + site < v_out;
      uint32_t m = 0;
      for (int k = tid >> 7; k < n_idx; k += 2) {
        int32_t* slot = r_s + k * kTile + site;
        if constexpr (MODE == kRules) {
          if (!inside) {
            *slot = v_in;  // a site past V_out misses every tap
          } else if ((unsigned)*slot < (unsigned)v_in) {
            m |= 1u << k;
          }
        } else {
          if (!inside) *slot = 0;  // no z tap present
          m |= (uint32_t)(*slot & 7) << (3 * k);
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
    // The tile's one block-wide barrier: the index, masks (and W) of every
    // thread are visible, and every thread has left the previous tile, so
    // the other index buffer and, where W streams, the ring are free. The
    // masks alternate between two buffers like the index, so a fast warp's
    // next vote cannot overwrite masks a slow warp still has to read.
    __syncthreads();
    fetch_index(t + gridDim.x, buf ^ 1);  // lands under this tile's tap loop

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

    // copies of the entry starting at tap t0 into stage st: my half row
    // (zeros for a miss) of each of its taps my group uses, and my share of
    // the entry's W where W streams
    auto copy_entry = [&](int t0, int st) {
      if constexpr ((PHASES & kGather) != 0) {
        for (int i = 0; i < tps; ++i) {
          const int tap = t0 + i;
          if (((gmask >> tap) & 1) == 0) continue;
          int r;
          bool hit;
          if constexpr (MODE == kRules) {
            r = r_s[tap * kTile + grow];
            hit = (unsigned)r < (unsigned)v_in;
          } else {
            const int code = r_s[(tap / 3) * kTile + grow];
            const int pat = code & 7, dz = tap % 3;
            r = (code >> 3) + __popc(pat & ((1 << dz) - 1));
            hit = ((pat >> dz) & 1) && (unsigned)r < (unsigned)v_in;
          }
          const __nv_bfloat16* src = feats_b + (size_t)(hit ? r : 0) * c + gh * 8;
          const uint32_t dst = a_addr + st * a1
                               + kb32_offset(kTile, grow, i * kblocks, gh);
          for (int j = 0; j < kblocks; ++j) {
            cp_async16(dst + j * kTile * 32, src + j * 16, hit ? 16 : 0);
          }
        }
      }
      if constexpr ((PHASES & kMma) != 0) {
        if (!resident) {
          const __nv_bfloat16* src = wp + (size_t)t0 * (w_tap / 2);
          for (int i = tid; i < w1 / 16; i += kThreads) {
            cp_async16(w_addr + st * w1 + i * 16, src + i * 8);
          }
        }
      }
    };

    // Where W is resident a group shares nothing with the others inside the
    // entry loop (it gathers, multiplies and reuses only its own rows of the
    // stages), so each group walks its own entries behind its own barrier: a
    // warp's __syncwarp or a warpgroup's named barrier. Where W streams
    // through the ring the block walks the tile's entries together.
    const uint32_t lmask = entry_starts(resident ? gmask : tmask, tps);
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
        copy_entry(__ffs(to_copy) - 1, st_copy);
        to_copy &= to_copy - 1;
      }
      cp_async_commit();
      st_copy = st_copy + 1 == stages ? 0 : st_copy + 1;
    }
    for (int e = 0; e < n_used; ++e) {
      // the copies of entry e are S - 2 groups back; after the barrier
      // every thread's have landed and every thread has left the product of
      // entry e - 1, whose stage the next copies overwrite
      switch (stages) {
        case 4: cp_async_wait<2>(); break;
        case 3: cp_async_wait<1>(); break;
        default: cp_async_wait<0>(); break;
      }
      if constexpr (WG) fence_proxy_async();  // wgmma reads what cp.async wrote
      sync();
      if (to_copy) {
        copy_entry(__ffs(to_copy) - 1, st_copy);
        to_copy &= to_copy - 1;
      }
      cp_async_commit();
      st_copy = st_copy + 1 == stages ? 0 : st_copy + 1;

      const int t0 = __ffs(to_run) - 1;
      to_run &= to_run - 1;
      if constexpr ((PHASES & kMma) != 0) {
        if ((gmask >> t0) & (tps == 1 ? 1u : 7u)) {
          if constexpr (WG) wgmma_fence();
          for (int i = 0; i < tps; ++i) {
            if (((gmask >> (t0 + i)) & 1) == 0) continue;
            const uint32_t a_tile = a_addr + st_run * a1
                                    + i * kblocks * kTile * 32;
            const uint32_t w_tile =
                w_addr + (resident ? (t0 + i) * w_tap : st_run * w1 + i * w_tap);
            if constexpr (WG) {
              for (int j = 0; j < kblocks; ++j) {
                wgmma_m64k16(acc,
                             wgmma_desc(a_tile + (j * kTile + 64 * wg) * 32),
                             wgmma_desc(w_tile + j * COUT * 32));
              }
            } else {
              for (int j = 0; j < kblocks; ++j) {
                warp_mma_k16<COUT>(acc, a_tile, kTile, 16 * warp, w_tile,
                                   COUT, 0, j, lane);
              }
            }
          }
          if constexpr (WG) {
            wgmma_commit();
            wgmma_wait<0>();
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

// One launch's geometry: n_idx index rows per site, n_taps taps of W, tps
// taps per stage entry, c channels per tap (a multiple of 16).
struct Geometry {
  int batch, v_in, v_out, n_idx, n_taps, c, cout, tps;
};

template <int COUT, int PHASES, bool WG, int MODE>
cudaError_t launch(const void* feats, const void* index, const void* wp,
                   const void* bias, const void* out_valid, void* out,
                   const Geometry& g, int grid, cudaStream_t stream) {
  const Plan plan = make_plan(g.n_idx, g.n_taps, g.c, COUT, g.tps);
  if (plan.smem == 0) return cudaErrorInvalidValue;
  auto kernel = sparse_conv_kernel<COUT, PHASES, WG, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, plan.smem, stream>>>(
      static_cast<const __nv_bfloat16*>(feats),
      static_cast<const int32_t*>(index),
      static_cast<const __nv_bfloat16*>(wp), static_cast<const float*>(bias),
      static_cast<const uint8_t*>(out_valid), static_cast<float*>(out),
      g.batch, g.v_in, g.v_out, g.n_idx, g.n_taps, g.c, g.tps, plan.stages,
      plan.resident);
  return cudaGetLastError();
}

// Launch on route 0 (wgmma) or 1 (mma.sync) at width g.cout.
template <int PHASES, int MODE>
int dispatch(const void* feats, const void* index, const void* wp,
             const void* bias, const void* out_valid, void* out,
             const Geometry& g, int route, int grid, void* stream) {
  if (g.v_out == 0 || g.batch == 0) return 0;
  if (g.n_taps < 1 || g.n_taps > kMaxTaps || g.c % 16 != 0 || grid < 1
      || (route != 0 && route != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wgmma = route == 0;
  switch (g.cout * 2 + (wgmma ? 0 : 1)) {
    case 32: return launch<16, PHASES, true, MODE>(feats, index, wp, bias, out_valid, out, g, grid, st);
    case 33: return launch<16, PHASES, false, MODE>(feats, index, wp, bias, out_valid, out, g, grid, st);
    case 64: return launch<32, PHASES, true, MODE>(feats, index, wp, bias, out_valid, out, g, grid, st);
    case 65: return launch<32, PHASES, false, MODE>(feats, index, wp, bias, out_valid, out, g, grid, st);
    case 128: return launch<64, PHASES, true, MODE>(feats, index, wp, bias, out_valid, out, g, grid, st);
    case 129: return launch<64, PHASES, false, MODE>(feats, index, wp, bias, out_valid, out, g, grid, st);
    case 256: return launch<128, PHASES, true, MODE>(feats, index, wp, bias, out_valid, out, g, grid, st);
    case 257: return launch<128, PHASES, false, MODE>(feats, index, wp, bias, out_valid, out, g, grid, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The persistent grid of one launch: the blocks the card holds at once
// (blocks per SM by the kernel's registers and shared memory, times the
// SMs), at most one per tile. Writes the plan's stages, residency,
// shared-memory bytes and taps per stage to info[0..3] where info is not
// null. Returns the grid, or minus a cudaError_t.
template <int MODE>
int grid_for(const Geometry& g, int route, int* info) {
  const Plan plan = make_plan(g.n_idx, g.n_taps, g.c, g.cout, g.tps);
  if (plan.smem == 0) return -(int)cudaErrorInvalidValue;
  if (info != nullptr) {
    info[0] = plan.stages;
    info[1] = plan.resident;
    info[2] = plan.smem;
    info[3] = g.tps;
  }
  const void* kernel = nullptr;
  switch (g.cout * 2 + (route != 0)) {
    case 32: kernel = (const void*)sparse_conv_kernel<16, kFull, true, MODE>; break;
    case 33: kernel = (const void*)sparse_conv_kernel<16, kFull, false, MODE>; break;
    case 64: kernel = (const void*)sparse_conv_kernel<32, kFull, true, MODE>; break;
    case 65: kernel = (const void*)sparse_conv_kernel<32, kFull, false, MODE>; break;
    case 128: kernel = (const void*)sparse_conv_kernel<64, kFull, true, MODE>; break;
    case 129: kernel = (const void*)sparse_conv_kernel<64, kFull, false, MODE>; break;
    case 256: kernel = (const void*)sparse_conv_kernel<128, kFull, true, MODE>; break;
    case 257: kernel = (const void*)sparse_conv_kernel<128, kFull, false, MODE>; break;
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
  const int tiles = g.batch * ((g.v_out + kTile - 1) / kTile);
  const int held = sms * (per_sm > 0 ? per_sm : 1);
  return tiles < held ? (tiles > 0 ? tiles : 1) : held;
}

}  // namespace sparse_tile

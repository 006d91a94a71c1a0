// Weight gradient of the sparse 3D convolution (K1's dW), for Hopper.
//
// Replaces the TPU kernel focalformer3d_tpu/ops/sparse_conv_pallas.py:_kernel
// run in gather mode by the custom VJP (_conv_core_bwd), together with the
// dot outside it and the spill correction that follows. It computes
//
//   dW[k, c, o] = sum_{b, j : rules[b, k, j] != V_in}
//                     bf16(x[b, rules[b, k, j], c]) * g[b, j, o]
//
// with x rounded to bf16 (the kernel's table), g in f32 and f32 sums. The
// card reads the absolute rulebook directly, so the TPU's windows, packed
// lanes, sum over pack blocks and spill list have no counterpart here.
//
// Rounding: the cotangent is split, g = g_hi + g_lo + r with g_hi = bf16(g)
// and g_lo = bf16(g - g_hi), and dW = X^T g_hi + X^T g_lo, two bf16
// tensor-core products into one f32 sum. A product of two bf16 values is
// exact in f32, so against the f32 product only r is lost: |r| <= 2^-16 |g|
// (wgrad_plain in ops/sparse_conv_cuda.py computes the same split).
//
// What bounds it on this card. Per hit it reads one C-wide bf16 row of x
// and one Cout-wide f32 row of g and, with the split, does 4 * C * Cout
// FLOPs at the bf16 tensor-core rate (989 TFLOP/s): 11-43 FLOPs per byte
// at the training widths, below the card's ~295, so the bound is bytes,
// 0.64 ms per FocalFormer3D_L training step (16 launches, batch 2).
// Measured on an NVIDIA H100 80GB HBM3 at 700 W by CUDA-graph replay: the
// first version of this kernel (f32 FMAs on the CUDA cores with x widened
// to f32 in shared memory, 64-site chunks) took 12.3 ms per step; this one
// takes 4.8. What holds it is the chunk loop, not bytes or the product:
// without its g row copies it runs 10% faster, without any row copy 45%,
// and deeper pipelines (3 or 4 stages) were slower, as they cost blocks
// per SM. Each chunk waits one round trip for rows issued one chunk
// earlier, at four blocks per SM on the 64-channel geometries.
//
// What the design does about that: per tap the product is a GEMM with
// M = C, N = Cout and the tap's hits as the contraction, on mma.sync
// m16n8k16.
// - One block per (tap k, slice p of the flattened B x V_out site list).
// - The block first compacts its slice: each warp reads the rules of an
//   eighth of it, eight 32-site steps in flight at once, ballots them and
//   writes the x row and the site of each hit to its list in a scratch
//   buffer (8 bytes a hit, read back by the same block soon after, so from
//   L2). The product then walks chunks of 128 or 64 hits, not sites: every
//   chunk but the last is full however sparse the rulebook. (Chunks of 64
//   sites held 8-25 hits at the training geometries, and the block paid
//   each chunk's copy latency in turn.)
// - x rows are copied by 16-byte cp.async as bf16 into the KB32 layout of
//   mma_sm90.cuh (hits as rows), g rows as f32 into rows padded to
//   Cout + 4 floats (no bank conflict on the fragment reads below); the
//   last chunk is padded to a multiple of 16 hits with zero-filled rows.
//   Two stages: chunk j + 1's rows and chunk j + 2's hit indices land
//   under chunk j's product, with one block-wide barrier per chunk (a
//   third stage costs blocks per SM and was slower).
// - X^T arrives by ldmatrix.trans straight from the KB32 tile. Each thread
//   reads its four f32 values of a g fragment and splits them into the hi
//   and lo bf16 fragments in registers, so no bf16 copy of g is staged.
// - The C x Cout tile of dW[k] stays in registers (64 floats a thread at
//   128 x 128); where it has fewer than eight m16n8 tiles, warps also split
//   the hits, and their sums meet in a fixed order at the end.
// - Every block writes its partial dW[k] to scratch and a second kernel sums
//   the P partials of each entry in a fixed order: no atomics, so two runs
//   give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

using namespace mma90;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;  // chunk j multiplies while chunk j + 1 lands
constexpr int kAhead = 8;   // 32-site steps of rules a warp loads at once
constexpr int kSliceUnit = kWarps * 32;  // slices are a multiple of this

// The warps' split of the G tile-owning warp groups into GM along C and GN
// along Cout that loads the fewest fragments per product (MT + NT).
constexpr int pick_gm(int ms, int nb, int g) {
  int best = 1, cost = 1 << 30;
  for (int gm = 1; gm <= g; gm *= 2) {
    const int gn = g / gm;
    if (gm > ms || gn > nb) continue;
    if (ms / gm + nb / gn < cost) {
      cost = ms / gm + nb / gn;
      best = gm;
    }
  }
  return best;
}

// Hits per chunk: 128 where a stage of 128 rows (bf16 x, f32 g padded to
// Cout + 4) stays within 32 KB (half the barriers), else 64 (more blocks
// per SM).
constexpr int chunk_for(int c, int cout) {
  return 128 * (2 * c + 4 * (cout + 4)) <= 32 * 1024 ? 128 : 64;
}

template <int C, int COUT>
struct Tiling {
  static constexpr int MS = C / 16;    // 16-row strips of dW[k]
  static constexpr int NB = COUT / 8;  // 8-column blocks
  static constexpr int T = MS * NB;    // m16n8 tiles
  static constexpr int KS = T >= kWarps ? 1 : kWarps / T;  // warps per tile
  static constexpr int G = kWarps / KS;
  static constexpr int GM = pick_gm(MS, NB, G);
  static constexpr int GN = G / GM;
  static constexpr int MT = MS / GM;   // strips per warp
  static constexpr int NT = NB / GN;   // column blocks per warp
  static constexpr int GS = COUT + 4;  // floats per staged g row
  static constexpr int CH = chunk_for(C, COUT);
  static constexpr int XB = CH * C * 2;   // bytes of one x stage
  static constexpr int GB = CH * GS * 4;  // bytes of one g stage
  static constexpr int SMEM_STAGES =
      kStages * (XB + GB) + kStages * 2 * CH * 4 + kWarps * 4;
  static constexpr int SMEM_RED = KS * C * COUT * 4;
  static constexpr int SMEM = SMEM_STAGES > SMEM_RED ? SMEM_STAGES : SMEM_RED;
  static_assert(MT * GM == MS && NT * GN == NB, "tiling must cover dW[k]");
};

// The hi and lo bf16 pairs of two f32 values (the first in the low half).
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <int C, int COUT>
__global__ void __launch_bounds__(kThreads)
wgrad_kernel(const __nv_bfloat16* __restrict__ x,  // (B, V_in, C)
             const float* __restrict__ g,          // (B, V_out, COUT)
             const int32_t* __restrict__ rules,    // (B, K, V_out)
             int32_t* __restrict__ hits,           // (P, K, 2, slice) scratch
             float* __restrict__ partial,          // (P, K, C, COUT)
             int v_in, int v_out, int n_taps, int n_sites, int slice) {
  using T = Tiling<C, COUT>;
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr int S = kStages;
  constexpr int kChunk = T::CH;
  const uint32_t xs = smem_u32(smem);  // S KB32 stages of kChunk x C
  float* gs = reinterpret_cast<float*>(smem + S * T::XB);  // S of kChunk x GS
  int* xrow = reinterpret_cast<int*>(smem + S * (T::XB + T::GB));  // [S][kChunk]
  int* grow = xrow + S * kChunk;                                  // [S][kChunk]
  int* wcnt = grow + S * kChunk;  // [kWarps] hits of each warp's part

  const int k = blockIdx.y;
  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ks = warp % T::KS;  // my share of the hits
  const int grp = warp / T::KS;
  const int gm = grp % T::GM;   // my strips gm * MT ..
  const int gn = grp / T::GM;   // my column blocks gn * NT ..

  // 1. Compaction. Warp w takes the part q0 + w L .. q0 + (w + 1) L of the
  // slice (L = slice / 8 sites), reads its rules kAhead 32-site steps at a
  // time (all loads in flight before the first ballot) and writes the x row
  // (as a (B V_in) row) of each hit at [w L + i] of the block's scratch and
  // its site at [slice + w L + i], i its rank among the part's hits.
  const int part = slice / kWarps;
  int32_t* hl = hits + ((size_t)p * n_taps + k) * 2 * slice;
  const int qa = p * slice + warp * part;
  const int qe = min(qa + part, n_sites);
  int cnt = 0;
  {
    int b = (qa + lane) / v_out, j = qa + lane - b * v_out;
    for (int s = qa; s < qe; s += 32 * kAhead) {
      int raw[kAhead], bs[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        while (j >= v_out) {
          j -= v_out;
          ++b;
        }
        bs[u] = b;
        raw[u] = s + 32 * u + lane < qe
                     ? rules[((size_t)b * n_taps + k) * v_out + j] : v_in;
        j += 32;
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const bool hit = (unsigned)raw[u] < (unsigned)v_in;
        const unsigned bal = __ballot_sync(0xffffffffu, hit);
        if (hit) {
          const int pos = warp * part + cnt + __popc(bal & ((1u << lane) - 1u));
          hl[pos] = bs[u] * v_in + raw[u];
          hl[slice + pos] = s + 32 * u + lane;
        }
        cnt += __popc(bal);
      }
    }
  }
  if (lane == 0) wcnt[warp] = cnt;
  __threadfence_block();  // the lists are read back by other threads
  __syncthreads();
  // the block's hits are the warps' lists one after the other: hit h lies
  // in the list of the last warp w with pre[w] <= h
  int pre[kWarps], n = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    pre[w] = n;
    n += wcnt[w];
  }
  const int n_chunks = (n + kChunk - 1) / kChunk;

  float acc[T::MT][T::NT][4];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  // 2. The product over chunks of kChunk hits. The x rows and sites of
  // chunk ch into index buffer ch % S (threads 0 .. kChunk - 1 the rows,
  // the next kChunk the sites), not committed
  auto fetch_index = [&](int ch) {
    const int buf = ch % S;
    const int e = tid % kChunk;
    const int h = ch * kChunk + e;
    if (tid < 2 * kChunk && h < n) {
      int at = h;
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        if (h >= pre[w]) at = w * part + h - pre[w];
      }
      const bool site = tid >= kChunk;
      cp_async4(smem_u32((site ? grow : xrow) + buf * kChunk + e),
                hl + (site ? slice : 0) + at);
    }
  };
  // copies of chunk ch's rows into stage ch % S (indices in buffer
  // ch % S), zero rows up to a multiple of 16; commits
  auto issue = [&](int ch) {
    const int buf = ch % S;
    constexpr int PX = C / 8, PR = C / 8 + COUT / 4;  // 16-byte pieces a row
    const int rows = min(kChunk, n - ch * kChunk);
    const int n16 = (rows + 15) & ~15;
    for (int i = tid; i < n16 * PR; i += kThreads) {
      const int row = i / PR, pc = i - row * PR;
      const bool real = row < rows;
      if (pc < PX) {
        const __nv_bfloat16* src =
            x + (real ? (size_t)xrow[buf * kChunk + row] * C : 0) + pc * 8;
        cp_async16(xs + buf * T::XB + kb32_offset(kChunk, row, pc >> 1, pc & 1),
                   src, real ? 16 : 0);
      } else {
        const float* src =
            g + (real ? (size_t)grow[buf * kChunk + row] * COUT : 0)
            + (pc - PX) * 4;
        cp_async16(smem_u32(gs + buf * (T::GB / 4) + row * T::GS
                            + (pc - PX) * 4),
                   src, real ? 16 : 0);
      }
    }
    cp_async_commit();
  };
  // dW[k] += X^T (g_hi + g_lo) over chunk ch in stage ch % S, my 16-hit
  // steps ks, ks + KS, ...
  auto product = [&](int ch) {
    const int buf = ch % S;
    const int steps = (min(kChunk, n - ch * kChunk) + 15) >> 4;
    const uint32_t xa = xs + buf * T::XB;
    const float* gb = gs + buf * (T::GB / 4);
    for (int s = ks; s < steps; s += T::KS) {
      uint32_t a[T::MT][4];
#pragma unroll
      for (int i = 0; i < T::MT; ++i) {
        // tiles (hits 0-7, c 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15)
        // of strip gm * MT + i, transposed: mma.sync's a0..a3 of X^T
        ldmatrix_x4_trans(a[i], xa + frag_b_offset(kChunk, 16 * s,
                                                   gm * T::MT + i, lane));
      }
#pragma unroll
      for (int j = 0; j < T::NT; ++j) {
        // b0: hits 2 (t % 4) + {0, 1}, b1: the same + 8, column t / 4
        const float* gr = gb + (16 * s + 2 * (lane & 3)) * T::GS
                          + (gn * T::NT + j) * 8 + (lane >> 2);
        uint32_t hi0, lo0, hi1, lo1;
        split2(gr[0], gr[T::GS], hi0, lo0);
        split2(gr[8 * T::GS], gr[9 * T::GS], hi1, lo1);
#pragma unroll
        for (int i = 0; i < T::MT; ++i) {
          mma_m16n8k16(acc[i][j], a[i], hi0, hi1);
          mma_m16n8k16(acc[i][j], a[i], lo0, lo1);
        }
      }
    }
  };

  // Chunk j multiplies from stage j % 2 while chunk j + 1's rows and chunk
  // j + 2's indices land. The one barrier per chunk makes them visible and
  // frees the stage of chunk j - 1 and the index buffer of chunk j.
  fetch_index(0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  fetch_index(1);
  issue(0);
  for (int j = 0; j < n_chunks; ++j) {
    cp_async_wait<0>();
    __syncthreads();
    fetch_index(j + 2);
    issue(j + 1);
    product(j);
  }
  cp_async_wait<0>();  // (only copies past the last chunk: none)

  // the warps' sums meet in shared memory (the stages are free once every
  // warp has left its last product), then go out in a fixed order
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // [KS][C][COUT]
#pragma unroll
  for (int i = 0; i < T::MT; ++i) {
#pragma unroll
    for (int j = 0; j < T::NT; ++j) {
      const int c0 = (gm * T::MT + i) * 16 + (lane >> 2);
      const int o = (gn * T::NT + j) * 8 + 2 * (lane & 3);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        *reinterpret_cast<float2*>(red + (ks * C + c0 + 8 * half) * COUT + o) =
            make_float2(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
      }
    }
  }
  __syncthreads();
  float* out = partial + ((size_t)p * n_taps + k) * C * COUT;
  for (int e = tid; e < C * COUT; e += kThreads) {
    float s = red[e];
#pragma unroll
    for (int q = 1; q < T::KS; ++q) s += red[q * C * COUT + e];
    out[e] = s;
  }
}

// dW[e] = sum_{p < P} partial[p, e], in order of p (deterministic).
__global__ void reduce_partials(const float* __restrict__ partial,
                                float* __restrict__ dw, int n, int n_slices) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.0f;
  for (int p = 0; p < n_slices; ++p) s += partial[(int64_t)p * n + e];
  dw[e] = s;
}

template <int C, int COUT>
cudaError_t launch(const void* x, const float* g, const int32_t* rules,
                   int32_t* hits, float* partial, float* dw, int batch,
                   int v_in, int v_out, int n_taps, int n_slices, int slice,
                   cudaStream_t stream) {
  constexpr int smem = Tiling<C, COUT>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      wgrad_kernel<C, COUT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  wgrad_kernel<C, COUT><<<dim3(n_slices, n_taps), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), g, rules, hits, partial, v_in,
      v_out, n_taps, batch * v_out, slice);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = n_taps * C * COUT;
  reduce_partials<<<(n + 255) / 256, 256, 0, stream>>>(partial, dw, n,
                                                       n_slices);
  return cudaGetLastError();
}

template <int C>
cudaError_t by_cout(int cout, const void* x, const float* g,
                    const int32_t* r, int32_t* h, float* part, float* dw,
                    int batch, int v_in, int v_out, int n_taps, int n_slices,
                    int slice, cudaStream_t st) {
  switch (cout) {
    case 16: return launch<C, 16>(x, g, r, h, part, dw, batch, v_in, v_out, n_taps, n_slices, slice, st);
    case 32: return launch<C, 32>(x, g, r, h, part, dw, batch, v_in, v_out, n_taps, n_slices, slice, st);
    case 64: return launch<C, 64>(x, g, r, h, part, dw, batch, v_in, v_out, n_taps, n_slices, slice, st);
    case 128: return launch<C, 128>(x, g, r, h, part, dw, batch, v_in, v_out, n_taps, n_slices, slice, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Hits per chunk of the kernel at widths (c, cout), 0 for other widths.
extern "C" int sparse_conv_wgrad_chunk(int c, int cout) {
  auto width = [](int w) { return w >= 16 && w <= 128 && (w & (w - 1)) == 0; };
  return width(c) && width(cout) ? chunk_for(c, cout) : 0;
}

// C interface, loaded with ctypes. c and cout must each be one of 16, 32,
// 64, 128; block (k, p) compacts sites p * slice .. (p + 1) * slice of the
// flattened (B x V_out) site list for tap k, so slice must be a multiple of
// 256 and n_slices * slice must cover B * V_out; hits holds n_slices *
// n_taps * 2 * slice ints of scratch, partial n_slices * n_taps * c * cout
// floats and dw n_taps * c * cout. The caller checks shapes, dtypes,
// contiguity and alignment. Returns the cudaError_t of the launches.
extern "C" int sparse_conv_wgrad(const void* x, const void* g,
                                 const void* rules, void* hits,
                                 void* partial, void* dw, int batch,
                                 int v_in, int v_out, int n_taps, int c,
                                 int cout, int n_slices, int slice,
                                 void* stream) {
  const float* gf = static_cast<const float*>(g);
  const int32_t* r = static_cast<const int32_t*>(rules);
  int32_t* h = static_cast<int32_t*>(hits);
  float* part = static_cast<float*>(partial);
  float* d = static_cast<float*>(dw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch == 0 || v_out == 0) {  // no site: dW is zero
    return (int)cudaMemsetAsync(d, 0, sizeof(float) * n_taps * c * cout, st);
  }
  if (slice <= 0 || slice % kSliceUnit != 0 || n_slices < 1
      || n_slices > 65535 || (int64_t)n_slices * slice < (int64_t)batch * v_out) {
    return (int)cudaErrorInvalidValue;
  }
  switch (c) {
    case 16: return by_cout<16>(cout, x, gf, r, h, part, d, batch, v_in, v_out, n_taps, n_slices, slice, st);
    case 32: return by_cout<32>(cout, x, gf, r, h, part, d, batch, v_in, v_out, n_taps, n_slices, slice, st);
    case 64: return by_cout<64>(cout, x, gf, r, h, part, d, batch, v_in, v_out, n_taps, n_slices, slice, st);
    case 128: return by_cout<128>(cout, x, gf, r, h, part, d, batch, v_in, v_out, n_taps, n_slices, slice, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

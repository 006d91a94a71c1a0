// Weight gradient of the sparse 3D convolution (K1's dW), for Hopper.
//
// Replaces the TPU kernel focalformer3d_tpu/ops/sparse_conv_pallas.py:_kernel
// run in gather mode by the custom VJP (_conv_core_bwd), together with the
// dot outside it and the spill correction that follows. It computes
//
//   dW[k, c, o] = sum_{b, j : rules[b, k, j] != V_in}
//                     bf16(x[b, rules[b, k, j], c]) * g[b, j, o]
//
// with JAX's rounding: x rounded to bf16 (the kernel's table), g in f32,
// f32 accumulation. The card reads the absolute rulebook directly, so the
// TPU's windows, packed lanes, sum over pack blocks and spill list have no
// counterpart here.
//
// What bounds it on this card: per rule it reads one C-wide bf16 row of x
// and one Cout-wide f32 row of g and does 2 * C * Cout FLOPs; the f32 FMAs
// run on the CUDA cores (67 TFLOP/s), since the contract keeps g in f32 and
// a bf16 tensor-core product would round it. At C x Cout = 16 x 16 that is
// 16 FLOPs per byte of gathered input (memory-bound); at 64 x 128 it is 64
// (FMA-bound), so the bound moves from bytes to operations up the levels.
//
// What the design does about that: one block per (tap k, slice p of the
// sites). The block walks chunks p, p + P, p + 2P, ... of 64 sites of the
// flattened (B x V_out) site list; per chunk it compacts the sites whose
// rule on tap k hits (a block-wide ballot scan: misses cost no FLOPs and
// no loads) and stages their x rows (converted to f32) and g rows in shared
// memory. Each thread keeps an RC x RO register tile of dW[k] and runs
// RC + RO shared loads per RC * RO FMAs and per hit. Every block writes its
// partial dW[k] to scratch; a second kernel sums the P partials of each
// entry in a fixed order, so the result is deterministic (no atomics).
// Tensor cores, TMA and larger tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;  // sites per staged chunk

template <int C, int COUT>
struct Tile {
  static constexpr int OG = COUT < 32 ? COUT : 32;  // threads along o
  static constexpr int CG = kThreads / OG;          // threads along c
  static constexpr int RO = COUT / OG;              // o per thread
  static constexpr int RC = C / CG;                 // c per thread
  static_assert(RC >= 1 && C % CG == 0, "C too small for the tile");
};

template <int C, int COUT>
__global__ void __launch_bounds__(kThreads)
wgrad_kernel(const __nv_bfloat16* __restrict__ x,  // (B, V_in, C)
             const float* __restrict__ g,          // (B, V_out, COUT)
             const int32_t* __restrict__ rules,    // (B, K, V_out)
             float* __restrict__ partial,          // (P, K, C, COUT)
             int v_in, int v_out, int n_taps, int n_sites, int n_slices) {
  using T = Tile<C, COUT>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);           // kChunk x C
  float* gs = xs + kChunk * C;                          // kChunk x COUT
  int64_t* xrow = reinterpret_cast<int64_t*>(gs + kChunk * COUT);
  int64_t* grow = xrow + kChunk;
  int* warp_hits = reinterpret_cast<int*>(grow + kChunk);

  const int k = blockIdx.y;
  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int og = tid % T::OG;
  const int c0 = (tid / T::OG) * T::RC;

  float acc[T::RC][T::RO];
#pragma unroll
  for (int i = 0; i < T::RC; ++i)
#pragma unroll
    for (int j = 0; j < T::RO; ++j) acc[i][j] = 0.0f;

  const int n_chunks = (n_sites + kChunk - 1) / kChunk;
  for (int ch = p; ch < n_chunks; ch += n_slices) {
    // compact the chunk's hits on tap k (threads 0..kChunk-1 own a site)
    int hit = 0;
    int64_t xr = 0, gr = 0;
    if (tid < kChunk) {
      const int q = ch * kChunk + tid;
      if (q < n_sites) {
        const int b = q / v_out;
        const int j = q - b * v_out;
        const int r = rules[((int64_t)b * n_taps + k) * v_out + j];
        hit = (unsigned)r < (unsigned)v_in;
        xr = (int64_t)b * v_in + r;
        gr = q;
      }
    }
    const unsigned bal = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_hits[warp] = __popc(bal);
    __syncthreads();
    int base = 0, n_hits = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int n = warp_hits[w];
      base += w < warp ? n : 0;
      n_hits += n;
    }
    if (hit) {
      const int pos = base + __popc(bal & ((1u << lane) - 1u));
      xrow[pos] = xr;
      grow[pos] = gr;
    }
    __syncthreads();
    if (n_hits == 0) continue;  // uniform across the block

    // stage the hits' rows: x as f32 (16-byte loads of 8 bf16), g as float4
    constexpr int XV = C / 8;
    for (int i = tid; i < n_hits * XV; i += kThreads) {
      const int h = i / XV;
      const int v = i - h * XV;
      const uint4 raw = reinterpret_cast<const uint4*>(x + xrow[h] * C)[v];
      const __nv_bfloat162* pr = reinterpret_cast<const __nv_bfloat162*>(&raw);
      float* dst = xs + h * C + v * 8;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(pr[e]);
        dst[2 * e] = f.x;
        dst[2 * e + 1] = f.y;
      }
    }
    constexpr int GV = COUT / 4;
    for (int i = tid; i < n_hits * GV; i += kThreads) {
      const int h = i / GV;
      const int v = i - h * GV;
      reinterpret_cast<float4*>(gs + h * COUT)[v] =
          reinterpret_cast<const float4*>(g + grow[h] * COUT)[v];
    }
    __syncthreads();

    for (int h = 0; h < n_hits; ++h) {
      float xv[T::RC], gv[T::RO];
#pragma unroll
      for (int i = 0; i < T::RC; ++i) xv[i] = xs[h * C + c0 + i];
#pragma unroll
      for (int j = 0; j < T::RO; ++j) gv[j] = gs[h * COUT + og + j * T::OG];
#pragma unroll
      for (int i = 0; i < T::RC; ++i)
#pragma unroll
        for (int j = 0; j < T::RO; ++j) acc[i][j] = fmaf(xv[i], gv[j], acc[i][j]);
    }
    __syncthreads();  // the staging area is reused by the next chunk
  }

  float* out = partial + ((int64_t)p * n_taps + k) * C * COUT;
#pragma unroll
  for (int i = 0; i < T::RC; ++i)
#pragma unroll
    for (int j = 0; j < T::RO; ++j) out[(c0 + i) * COUT + og + j * T::OG] = acc[i][j];
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
                   float* partial, float* dw, int batch, int v_in, int v_out,
                   int n_taps, int n_slices, cudaStream_t stream) {
  const size_t smem = (size_t)kChunk * (C + COUT) * sizeof(float)
                      + 2 * kChunk * sizeof(int64_t) + kWarps * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      wgrad_kernel<C, COUT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int n_sites = batch * v_out;
  wgrad_kernel<C, COUT><<<dim3(n_slices, n_taps), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), g, rules, partial, v_in, v_out,
      n_taps, n_sites, n_slices);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = n_taps * C * COUT;
  reduce_partials<<<(n + 255) / 256, 256, 0, stream>>>(partial, dw, n,
                                                       n_slices);
  return cudaGetLastError();
}

template <int C>
cudaError_t by_cout(int cout, const void* x, const float* g,
                    const int32_t* r, float* part, float* dw, int batch,
                    int v_in, int v_out, int n_taps, int n_slices,
                    cudaStream_t st) {
  switch (cout) {
    case 16: return launch<C, 16>(x, g, r, part, dw, batch, v_in, v_out, n_taps, n_slices, st);
    case 32: return launch<C, 32>(x, g, r, part, dw, batch, v_in, v_out, n_taps, n_slices, st);
    case 64: return launch<C, 64>(x, g, r, part, dw, batch, v_in, v_out, n_taps, n_slices, st);
    case 128: return launch<C, 128>(x, g, r, part, dw, batch, v_in, v_out, n_taps, n_slices, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface, loaded with ctypes. c and cout must each be one of 16, 32,
// 64, 128; partial holds n_slices * n_taps * c * cout floats and dw
// n_taps * c * cout. The caller checks shapes, dtypes, contiguity and
// alignment. Returns the cudaError_t of the launches.
extern "C" int sparse_conv_wgrad(const void* x, const void* g,
                                 const void* rules, void* partial, void* dw,
                                 int batch, int v_in, int v_out, int n_taps,
                                 int c, int cout, int n_slices,
                                 void* stream) {
  const float* gf = static_cast<const float*>(g);
  const int32_t* r = static_cast<const int32_t*>(rules);
  float* part = static_cast<float*>(partial);
  float* d = static_cast<float*>(dw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 16: return by_cout<16>(cout, x, gf, r, part, d, batch, v_in, v_out, n_taps, n_slices, st);
    case 32: return by_cout<32>(cout, x, gf, r, part, d, batch, v_in, v_out, n_taps, n_slices, st);
    case 64: return by_cout<64>(cout, x, gf, r, part, d, batch, v_in, v_out, n_taps, n_slices, st);
    case 128: return by_cout<128>(cout, x, gf, r, part, d, batch, v_in, v_out, n_taps, n_slices, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

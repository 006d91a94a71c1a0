// Gather probes (kernel B) for Hopper: row gathers from a window held in
// shared memory, and row gathers from a table in device memory.
//
// gather_taps replaces the Pallas functions
// tools/micro_gather_kernel.py:_ohdot_kernel, _take_kernel and
// _takerow_kernel (P6). For each tile i and row t of the tile it computes
//
//   out[i, t, :] = bf16( sum_{k < K} f32(window[rel[i, t, k] / div, :]) )
//
// summed in tap order in f32 and rounded once; a row index outside
// [0, R) (or a negative rel) reads a zero row. The one-hot kernel indexes
// rel // pack (div = pack), the two take kernels rel (div = 1): for pack > 1
// they are different functions, so div is explicit. The TPU held the
// window in VMEM; here it is staged in shared memory (at most 512 x 128
// bf16 = 128 KB, above the 48 KB of static shared memory, so dynamic).
//
// gather_rows replaces tools/micro_gather2.py:kernel and kernel2 (P7),
// which compute one function, out[n] = x[idx[n]] (exact; an index outside
// [0, V) reads a zero row). The TPU held the 4 MB table in VMEM; here it
// is read from device memory, where it stays in the 50 MB L2 cache.
//
// What bounds them on this card: bytes. gather_taps writes T * L bf16 per
// tile and reads T * K int32 indices, against K * T * L f32 adds; its
// shared-memory reads (K rows of L bf16 per output row) are what it spends
// time on. gather_rows moves each row once in and once out.
//
// What the design does about that: gather_taps gives each tile one block;
// the window is copied into shared memory once per block with 16-byte
// loads, and each thread owns a 16-byte chunk of output rows (eight f32
// sums in registers over the K taps, one 16-byte store). gather_rows has one
// thread per 16-byte chunk of output, so a warp reads and writes whole
// rows; no shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_taps_kernel(const int32_t* __restrict__ rel,           // (n_tiles, T, K)
                   const __nv_bfloat16* __restrict__ window,  // (R, L)
                   __nv_bfloat16* __restrict__ out,           // (n_tiles, T, L)
                   int t_rows, int n_taps, int r_rows, int l, int div) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* win = reinterpret_cast<uint4*>(smem);
  const int chunks = l / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < r_rows * chunks; i += kThreads) {
    win[i] = reinterpret_cast<const uint4*>(window)[i];
  }
  __syncthreads();
  const int32_t* rel_t = rel + (size_t)blockIdx.x * t_rows * n_taps;
  uint4* out_t = reinterpret_cast<uint4*>(out + (size_t)blockIdx.x * t_rows * l);
  for (int i = threadIdx.x; i < t_rows * chunks; i += kThreads) {
    const int t = i / chunks;
    const int ch = i - t * chunks;
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.0f;
    for (int k = 0; k < n_taps; ++k) {
      const int r = rel_t[t * n_taps + k];
      const int row = r >= 0 ? r / div : -1;
      if ((unsigned)row < (unsigned)r_rows) {  // others read a zero row
        const uint4 v = win[row * chunks + ch];
        const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(e[j]);
          acc[2 * j] += f.x;
          acc[2 * j + 1] += f.y;
        }
      }
    }
    uint4 o;
    __nv_bfloat162* oe = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      oe[j] = __floats2bfloat162_rn(acc[2 * j], acc[2 * j + 1]);
    }
    out_t[i] = o;
  }
}

__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const __nv_bfloat16* __restrict__ x,  // (V, C)
                   const int32_t* __restrict__ idx,      // (N,)
                   __nv_bfloat16* __restrict__ out,      // (N, C)
                   int v, int n, int c) {
  const int chunks = c / 8;
  const long long total = (long long)n * chunks;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < total; i += stride) {
    const long long row = i / chunks;
    const int ch = (int)(i - row * chunks);
    const int r = idx[row];
    uint4 val = make_uint4(0, 0, 0, 0);
    if ((unsigned)r < (unsigned)v) {
      val = reinterpret_cast<const uint4*>(x + (size_t)r * c)[ch];
    }
    reinterpret_cast<uint4*>(out)[i] = val;
  }
}

}  // namespace

// C interfaces, loaded with ctypes; the caller checks shapes, dtypes,
// contiguity and 16-byte alignment. Return the cudaError_t of the launch.

// l a multiple of 8, R * l * 2 bytes of window within the card's 227 KB of
// shared memory per block, div >= 1.
extern "C" int micro_gather_taps(const void* rel, const void* window,
                                 void* out, int n_tiles, int t_rows,
                                 int n_taps, int r_rows, int l, int div,
                                 void* stream) {
  if (n_tiles == 0 || t_rows == 0) return 0;
  const int smem = r_rows * l * 2;
  cudaError_t err = cudaFuncSetAttribute(
      gather_taps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  gather_taps_kernel<<<n_tiles, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rel),
      static_cast<const __nv_bfloat16*>(window),
      static_cast<__nv_bfloat16*>(out), t_rows, n_taps, r_rows, l, div);
  return (int)cudaGetLastError();
}

// c a multiple of 8.
extern "C" int micro_gather_rows(const void* x, const void* idx, void* out,
                                 int v, int n, int c, void* stream) {
  if (n == 0) return 0;
  const long long total = (long long)n * (c / 8);
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // grid-stride beyond
  gather_rows_kernel<<<(unsigned)blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int32_t*>(idx),
      static_cast<__nv_bfloat16*>(out), v, n, c);
  return (int)cudaGetLastError();
}

// Dot-shape probe (kernel A) for Hopper: the tensor-core products that the
// TPU probes timed inside a Pallas grid.
//
// Replaces the Pallas functions tools/micro_mxu_probe.py:gk (P1a),
// tools/micro_dotshape.py:_kernel/_outer (P2) and
// tools/micro_dotshape2.py:_outer (P3). It computes
//
//   block i:  acc_i = sum_{r < reps} bf16(a[i mod n_a] + r) @ b
//   out = acc_{store_block}[:rows_out]
//
// with bf16 operands and f32 accumulation (a + r is rounded to bf16, as JAX
// rounds a bf16 add). On the TPU every grid step wrote the same output
// block in order, so the last step (P1a) or any step (P2, P3: every step
// recomputes the same value) was the one that stayed. Blocks of a CUDA
// grid run in no order, so the one block that stores is chosen at run time
// (store_block); every block still computes its whole product, since the
// compiler cannot know which one is kept.
//
// What bounds it on this card: the products. P2/P3 read one small (M, K)
// operand from L2 in every block, so 2 * M * K * N * reps FLOPs per block
// against a few KB of traffic; P1a reads 600 distinct (2304, 64) tiles
// (177 MB) for 22.6 GFLOP, bytes and FLOPs within a factor of three of each
// other at the card's peaks.
//
// What the design does about that: one block of 8 warps walks its output
// in 128 x 64 tiles; per (rep, 64-deep slice of K) it stages a + r and the
// slice of b in shared memory (16-byte loads) and each warp runs WMMA bf16
// 16x16x16 on its 16-row strip, keeping the tile's f32 accumulators in
// registers across reps and K. Pipelining and wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kRows = 128;  // output rows per tile, 16 per warp
constexpr int kCols = 64;   // output columns per tile, 4 fragments per warp
constexpr int kDepth = 64;  // K per staged slice
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// staging: bf16(a + r) for one K slice of the tile, then that slice of b;
// the storing block's epilogue reuses the same bytes for its f32 tile
constexpr int kStageBytes = (kRows * kDepth + kDepth * kCols) * 2;
constexpr int kEpilogueBytes = kRows * kCols * 4;
constexpr int kSmemBytes =
    kStageBytes > kEpilogueBytes ? kStageBytes : kEpilogueBytes;

__global__ void __launch_bounds__(kThreads)
dot_probe_kernel(const __nv_bfloat16* __restrict__ a,  // (n_a, M, K)
                 const __nv_bfloat16* __restrict__ b,  // (K, N)
                 float* __restrict__ out,              // (rows_out, N)
                 int n_a, int m, int k, int n, int reps, int rows_out,
                 int store_block) {
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* b_s = a_s + kRows * kDepth;
  float* c_s = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const __nv_bfloat16* a_blk = a + (size_t)(blockIdx.x % n_a) * m * k;
  const bool store = (int)blockIdx.x == store_block;
  const int row_tiles = (m + kRows - 1) / kRows;
  const int col_tiles = (n + kCols - 1) / kCols;

  for (int tile = 0; tile < row_tiles * col_tiles; ++tile) {
    const int m0 = (tile / col_tiles) * kRows;
    const int n0 = (tile % col_tiles) * kCols;
    const int ncols = min(kCols, n - n0);  // a multiple of 16
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kCols / 16];
#pragma unroll
    for (int f = 0; f < kCols / 16; ++f) wmma::fill_fragment(acc[f], 0.0f);

    for (int r = 0; r < reps; ++r) {
      const float add = (float)r;
      for (int k0 = 0; k0 < k; k0 += kDepth) {
        const int kk = min(kDepth, k - k0);  // a multiple of 16
        const int a_chunks = kk / 8;
        const int b_chunks = ncols / 8;
        __syncthreads();  // every warp has read the previous slice
        for (int i = tid; i < kRows * a_chunks; i += kThreads) {
          const int row = i / a_chunks;
          const int ch = i - row * a_chunks;
          uint4 v = make_uint4(0, 0, 0, 0);  // rows past M are zero
          if (m0 + row < m) {
            v = *reinterpret_cast<const uint4*>(
                a_blk + (size_t)(m0 + row) * k + k0 + ch * 8);
            __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              e[j] = __float2bfloat16(__bfloat162float(e[j]) + add);
            }
          }
          *reinterpret_cast<uint4*>(a_s + row * kDepth + ch * 8) = v;
        }
        for (int i = tid; i < kk * b_chunks; i += kThreads) {
          const int row = i / b_chunks;
          const int ch = i - row * b_chunks;
          *reinterpret_cast<uint4*>(b_s + row * kCols + ch * 8) =
              *reinterpret_cast<const uint4*>(
                  b + (size_t)(k0 + row) * n + n0 + ch * 8);
        }
        __syncthreads();
        if (m0 + warp * 16 < m) {
          for (int kc = 0; kc < kk / 16; ++kc) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> fa;
            wmma::load_matrix_sync(fa, a_s + warp * 16 * kDepth + kc * 16,
                                   kDepth);
#pragma unroll
            for (int f = 0; f < kCols / 16; ++f) {
              if (f * 16 < ncols) {
                wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                               wmma::row_major> fb;
                wmma::load_matrix_sync(fb, b_s + kc * 16 * kCols + f * 16,
                                       kCols);
                wmma::mma_sync(acc[f], fa, fb, acc[f]);
              }
            }
          }
        }
      }
    }

    if (store && m0 < rows_out) {  // uniform over the block
      __syncthreads();  // the staging area is free for the epilogue
#pragma unroll
      for (int f = 0; f < kCols / 16; ++f) {
        wmma::store_matrix_sync(c_s + warp * 16 * kCols + f * 16, acc[f],
                                kCols, wmma::mem_row_major);
      }
      __syncthreads();
      for (int i = tid; i < kRows * ncols; i += kThreads) {
        const int row = i / ncols;
        const int col = i - row * ncols;
        if (m0 + row < rows_out) {
          out[(size_t)(m0 + row) * n + n0 + col] = c_s[row * kCols + col];
        }
      }
    }
  }
}

}  // namespace

// C interface, loaded with ctypes. k and n must be multiples of 16,
// 0 < rows_out <= m, 0 <= store_block < n_blocks; the caller checks shapes,
// dtypes, contiguity and 16-byte alignment. Returns the cudaError_t of the
// launch.
extern "C" int micro_dot_probe(const void* a, const void* b, void* out,
                               int n_a, int m, int k, int n, int reps,
                               int n_blocks, int rows_out, int store_block,
                               void* stream) {
  if (n_blocks == 0) return 0;
  dot_probe_kernel<<<n_blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
      static_cast<float*>(out), n_a, m, k, n, reps, rows_out, store_block);
  return (int)cudaGetLastError();
}

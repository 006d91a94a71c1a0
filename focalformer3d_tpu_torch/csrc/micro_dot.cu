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
// other at the card's peaks. The first version of this kernel (WMMA
// 16x16x16, b restaged for every slice, two block-wide barriers per slice)
// reached 28-35 TFLOP/s of the card's 989.
//
// What the design does about that:
// - b is staged once per block and column tile, transposed into the K-major
//   KB32 layout of mma_sm90.cuh (K x NT x 2 bytes, NT the widest of 128, 64,
//   32, 16 columns that divides N and fits beside the stages), and stays
//   there over every rep, slice and row tile;
// - a + r has to pass through registers, so a 128-row by 64-deep slice is
//   loaded with 16-byte loads, added, rounded and stored into one of two
//   KB32 stages; the loads of slice s + 1 are started before the product of
//   slice s and stored after it, so they overlap it;
// - the product is one of two routes over the same shared tiles, chosen per
//   launch: wgmma.mma_async m64nNTk16 by two warpgroups (64 rows each, both
//   operands by descriptor, asynchronous, so the add of the next slice runs
//   under it), or mma.sync m16n8k16 + ldmatrix by eight warps (16 rows
//   each). Each 64-row half of a stage is written and read by one
//   warpgroup only, so one 128-thread named barrier per slice replaces the
//   two block-wide ones;
// - the storing block writes its accumulators straight from registers.
// Both routes stay because K1 (sparse_conv.cu) chooses its instruction per
// width from their rates at its shapes; the probes print both.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W: P1a 0.18 ms on wgmma (0.23
// on mma.sync) against 0.20 ms for torch.matmul over the same 600 products
// and 0.82 ms before; P2's shapes 253-293 TFLOP/s on wgmma and 149-169 on
// mma.sync where K <= 512 (128-142 and 112-124 at K = 1152 and 1536, whose
// b tile of 64 columns leaves one block per SM); at K1's widths K = N = 16,
// 32, 64, 128: 19, 73, 210, 292 on wgmma and 20, 76, 144, 175 on mma.sync;
// P3's floor for 16 or 75 blocks fell from 0.57 to 0.065 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

using namespace mma90;

namespace {

constexpr int kRows = 128;   // output rows per tile: 64 per warpgroup
constexpr int kDepth = 64;   // K per staged slice: 4 K-blocks of 16
constexpr int kThreads = 256;
constexpr int kStageBytes = kRows * kDepth * 2;
constexpr int kMaxSmem = 227 * 1024;

template <int NT, bool WG>
__global__ void __launch_bounds__(kThreads)
dot_probe_kernel(const __nv_bfloat16* __restrict__ a,  // (n_a, M, K)
                 const __nv_bfloat16* __restrict__ b,  // (K, N)
                 float* __restrict__ out,              // (rows_out, N)
                 int n_a, int m, int k, int n, int reps, int rows_out,
                 int store_block) {
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* b_s = smem + 2 * kStageBytes;  // (K / 16) x NT x 32 bytes
  const uint32_t a_addr = smem_u32(smem);
  const uint32_t b_addr = smem_u32(b_s);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wg = tid >> 7;
  // staging: thread t of a warpgroup fills half h of row t / 2 of its 64
  const int srow = 64 * wg + ((tid & 127) >> 1);
  const int sh = tid & 1;
  const __nv_bfloat16* a_blk = a + (size_t)(blockIdx.x % n_a) * m * k;
  const bool store = (int)blockIdx.x == store_block;
  const int row_tiles = (m + kRows - 1) / kRows;
  const int k_slices = (k + kDepth - 1) / kDepth;
  const int n_slices = reps * k_slices;

  for (int n0 = 0; n0 < n; n0 += NT) {
    __syncthreads();  // the previous column tile's b is no longer read
    for (int i = tid; i < k * (NT / 8); i += kThreads) {
      const int krow = i / (NT / 8);
      const int c8 = i - krow * (NT / 8);
      const uint4 v = *reinterpret_cast<const uint4*>(
          b + (size_t)krow * n + n0 + c8 * 8);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) {  // b[krow, n0 + c8 * 8 + j] -> row n of b^T
        *reinterpret_cast<__nv_bfloat16*>(
            b_s + kb32_offset(NT, c8 * 8 + j, krow >> 4, (krow >> 3) & 1)
            + (krow & 7) * 2) = e[j];
      }
    }
    fence_proxy_async();
    __syncthreads();

    for (int rt = 0; rt < row_tiles; ++rt) {
      const int m0 = rt * kRows;
      const bool live = WG ? (m0 + 64 * wg < m) : (m0 + 16 * warp < m);
      const bool row_ok = m0 + srow < m;  // rows past M are zero
      const __nv_bfloat16* a_row = a_blk + (size_t)(m0 + srow) * k + sh * 8;
      float acc[NT / 2];
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) acc[i] = 0.0f;
      uint4 v[kDepth / 16];

      // slice s = (rep r, K slice): load its four K-blocks of my half row
      auto load = [&](int s) {
        const int k0 = (s % k_slices) * kDepth;
#pragma unroll
        for (int q = 0; q < kDepth / 16; ++q) {
          v[q] = make_uint4(0, 0, 0, 0);
          if (row_ok && k0 + 16 * q < k) {
            v[q] = *reinterpret_cast<const uint4*>(a_row + k0 + 16 * q);
          }
        }
      };
      // add r, round to bf16, store into stage s % 2
      auto stash = [&](int s) {
        const float add = (float)(s / k_slices);
        unsigned char* stage = smem + (s & 1) * kStageBytes;
#pragma unroll
        for (int q = 0; q < kDepth / 16; ++q) {
          __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v[q]);
          if (row_ok) {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              e[j] = __float2bfloat16(__bfloat162float(e[j]) + add);
            }
          }
          *reinterpret_cast<uint4*>(stage + kb32_offset(kRows, srow, q, sh)) =
              v[q];
        }
      };

      load(0);
      stash(0);
      fence_proxy_async();
      named_barrier(1 + wg, 128);
      for (int s = 0; s < n_slices; ++s) {
        if (s + 1 < n_slices) load(s + 1);
        const int k0 = (s % k_slices) * kDepth;
        const int steps = min(kDepth, k - k0) / 16;
        const uint32_t a_tile = a_addr + (s & 1) * kStageBytes;
        const uint32_t b_tile = b_addr + (k0 / 16) * NT * 32;
        if (live) {
          if constexpr (WG) {
            wgmma_fence();
            for (int j = 0; j < steps; ++j) {
              wgmma_m64k16(acc, wgmma_desc(a_tile + (j * kRows + 64 * wg) * 32),
                           wgmma_desc(b_tile + j * NT * 32));
            }
            wgmma_commit();
          } else {
            for (int j = 0; j < steps; ++j) {
              warp_mma_k16<NT>(acc, a_tile, kRows, 16 * warp, b_tile, NT, 0, j,
                               lane);
            }
          }
        }
        if (s + 1 < n_slices) stash(s + 1);  // under the asynchronous wgmma
        if constexpr (WG) {
          if (live) wgmma_wait<0>();
        }
        fence_proxy_async();
        named_barrier(1 + wg, 128);  // stage (s + 1) % 2 written, s % 2 read
      }

      if (store && m0 < rows_out) {
        const int row = m0 + 16 * warp + (lane >> 2);
#pragma unroll
        for (int nb = 0; nb < NT / 8; ++nb) {
          const int col = n0 + nb * 8 + 2 * (lane & 3);
          if (row < rows_out) {
            *reinterpret_cast<float2*>(out + (size_t)row * n + col) =
                make_float2(acc[4 * nb], acc[4 * nb + 1]);
          }
          if (row + 8 < rows_out) {
            *reinterpret_cast<float2*>(out + (size_t)(row + 8) * n + col) =
                make_float2(acc[4 * nb + 2], acc[4 * nb + 3]);
          }
        }
      }
    }
  }
}

template <int NT, bool WG>
cudaError_t launch(const void* a, const void* b, void* out, int n_a, int m,
                   int k, int n, int reps, int n_blocks, int rows_out,
                   int store_block, cudaStream_t stream) {
  const int smem = 2 * kStageBytes + k * NT * 2;
  cudaError_t err = cudaFuncSetAttribute(
      dot_probe_kernel<NT, WG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  dot_probe_kernel<NT, WG><<<n_blocks, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b), static_cast<float*>(out), n_a, m,
      k, n, reps, rows_out, store_block);
  return cudaGetLastError();
}

template <bool WG>
cudaError_t dispatch(const void* a, const void* b, void* out, int n_a, int m,
                     int k, int n, int reps, int n_blocks, int rows_out,
                     int store_block, cudaStream_t stream) {
  // the widest column tile that divides N and whose b fits beside the stages
  auto fits = [&](int nt) {
    return n % nt == 0 && 2 * kStageBytes + k * nt * 2 <= kMaxSmem;
  };
  if (fits(128)) return launch<128, WG>(a, b, out, n_a, m, k, n, reps, n_blocks, rows_out, store_block, stream);
  if (fits(64)) return launch<64, WG>(a, b, out, n_a, m, k, n, reps, n_blocks, rows_out, store_block, stream);
  if (fits(32)) return launch<32, WG>(a, b, out, n_a, m, k, n, reps, n_blocks, rows_out, store_block, stream);
  if (fits(16)) return launch<16, WG>(a, b, out, n_a, m, k, n, reps, n_blocks, rows_out, store_block, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// C interface, loaded with ctypes. k and n must be multiples of 16 with
// k * 32 bytes of b beside the 32 KB of stages within 227 KB, 0 < rows_out
// <= m, 0 <= store_block < n_blocks; route 0 is wgmma, 1 mma.sync; the
// caller checks shapes, dtypes, contiguity and 16-byte alignment. Returns
// the cudaError_t of the launch.
extern "C" int micro_dot_probe(const void* a, const void* b, void* out,
                               int n_a, int m, int k, int n, int reps,
                               int n_blocks, int rows_out, int store_block,
                               int route, void* stream) {
  if (n_blocks == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 0) return (int)dispatch<true>(a, b, out, n_a, m, k, n, reps, n_blocks, rows_out, store_block, st);
  if (route == 1) return (int)dispatch<false>(a, b, out, n_a, m, k, n, reps, n_blocks, rows_out, store_block, st);
  return (int)cudaErrorInvalidValue;
}

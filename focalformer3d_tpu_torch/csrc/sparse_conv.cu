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
// overflow reroute have no counterpart here.
//
// What bounds it on this card: each output site gathers K rows of C bf16
// values (K * V_out * C * 2 bytes, scattered 32..128-byte rows) against
// 2 * K * V_out * C * Cout FLOPs, i.e. Cout FLOPs per gathered byte. At
// the main path's widths (Cout <= 64) that is far below the ~295 FLOP/byte
// at which an H100's bf16 tensor cores and not its memory become the
// limit: the kernel is bound by the row gather (mostly L2 hits, since a
// level's bf16 table of at most 245760 x 32 rows is 15 MB).
//
// What the design does about that: one block owns a tile of 128 output
// sites of one sample and loops over the K taps. Per tap it stages the
// tile's gathered rows (16-byte vector loads; misses become zero rows) and
// W[k] in shared memory, skips the tap when no site of the tile has an
// input (a block-wide vote), and runs the product on the tensor cores
// (WMMA bf16 16x16x16, f32 accumulators held in registers across all taps).
// Bias, the out_valid mask and the store happen once, in the epilogue.
// TMA, wgmma and multi-stage pipelining of the gather are later work.
//
// Phase switches (the probe of focalformer3d_tpu_torch/tools/): the template
// parameter PHASES keeps the gather (kGather: staging the gathered rows)
// and the product (kMma: staging W[k] and the tensor-core MMAs) or drops
// either, to split the kernel's time as the TPU probes did with copies of
// their kernel (tools/micro_mxu_probe.py:_variant_kernel,
// micro_pallas_attr.py:variant_kernel, micro_batch_grid.py:_kernel_flat,
// micro_kernel_v2.py:_kernel_v2). Without kGather the product reads a
// staging tile zeroed once; with neither bit only the rule loads, the tap
// vote and the epilogue run. A mode without both bits computes
// out_valid ? bias : 0. sparse_conv_forward instantiates PHASES = kFull
// only, so production K1 is this same code; sparse_conv_probe takes the
// mode at run time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kTile = 128;      // output sites per block
constexpr int kWarps = 8;       // one 16-row strip of the tile per warp
constexpr int kThreads = kWarps * 32;
constexpr int kGather = 1;  // stage the tile's gathered rows
constexpr int kMma = 2;     // stage W[k] and run the tensor-core product
constexpr int kFull = kGather | kMma;

template <int COUT, int PHASES>
__global__ void __launch_bounds__(kThreads)
sparse_conv_kernel(const __nv_bfloat16* __restrict__ feats,  // (B, V_in, C)
                   const int32_t* __restrict__ rules,        // (B, K, V_out)
                   const __nv_bfloat16* __restrict__ w,      // (K, C, COUT)
                   const float* __restrict__ bias,           // (COUT,) or null
                   const uint8_t* __restrict__ out_valid,    // (B, V_out)
                   float* __restrict__ out,                  // (B, V_out, COUT)
                   int v_in, int v_out, int n_taps, int c) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem);  // kTile x c
  __nv_bfloat16* b_s = a_s + kTile * c;                         // c x COUT
  int32_t* r_s = reinterpret_cast<int32_t*>(b_s + c * COUT);    // kTile
  float* c_s = reinterpret_cast<float*>(smem);  // epilogue, kTile x COUT

  const int b = blockIdx.y;
  const int site0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int chunks = c / 8;  // 16-byte chunks per feature row

  const int32_t* rules_b = rules + (size_t)b * n_taps * v_out;
  const __nv_bfloat16* feats_b = feats + (size_t)b * v_in * c;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[COUT / 16];
#pragma unroll
  for (int n = 0; n < COUT / 16; ++n) wmma::fill_fragment(acc[n], 0.0f);
  if constexpr ((PHASES & kGather) == 0) {
    // the product alone reads a zeroed tile (barriers follow before it)
    for (int i = tid; i < kTile * chunks; i += kThreads) {
      reinterpret_cast<uint4*>(a_s)[i] = make_uint4(0, 0, 0, 0);
    }
  }

  for (int k = 0; k < n_taps; ++k) {
    int hit = 0;
    if (tid < kTile) {
      const int s = site0 + tid;
      const int r = s < v_out ? rules_b[(size_t)k * v_out + s] : v_in;
      r_s[tid] = r;
      hit = (unsigned)r < (unsigned)v_in;
    }
    if (!__syncthreads_or(hit)) continue;  // no site of the tile uses tap k

    if constexpr ((PHASES & kGather) != 0) {
      for (int i = tid; i < kTile * chunks; i += kThreads) {
        const int row = i / chunks;
        const int r = r_s[row];
        uint4 v = make_uint4(0, 0, 0, 0);
        if ((unsigned)r < (unsigned)v_in) {  // misses read as zero rows
          v = reinterpret_cast<const uint4*>(feats_b + (size_t)r * c)[i - row * chunks];
        }
        reinterpret_cast<uint4*>(a_s)[i] = v;
      }
    }
    if constexpr ((PHASES & kMma) != 0) {
      const uint4* w_k = reinterpret_cast<const uint4*>(w + (size_t)k * c * COUT);
      for (int i = tid; i < c * COUT / 8; i += kThreads) {
        reinterpret_cast<uint4*>(b_s)[i] = w_k[i];
      }
    }
    __syncthreads();

    if constexpr ((PHASES & kMma) != 0) {
      for (int kc = 0; kc < c / 16; ++kc) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::load_matrix_sync(a, a_s + warp * 16 * c + kc * 16, c);
#pragma unroll
        for (int n = 0; n < COUT / 16; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
          wmma::load_matrix_sync(bf, b_s + kc * 16 * COUT + n * 16, COUT);
          wmma::mma_sync(acc[n], a, bf, acc[n]);
        }
      }
    }
    __syncthreads();
  }

  // every warp has passed the last barrier, so the staging area is free
#pragma unroll
  for (int n = 0; n < COUT / 16; ++n) {
    wmma::store_matrix_sync(c_s + warp * 16 * COUT + n * 16, acc[n], COUT,
                            wmma::mem_row_major);
  }
  __syncthreads();
  const uint8_t* valid_b = out_valid + (size_t)b * v_out;
  float* out_b = out + (size_t)b * v_out * COUT;
  for (int i = tid; i < kTile * COUT; i += kThreads) {
    const int row = i / COUT;
    const int o = i - row * COUT;
    const int s = site0 + row;
    if (s < v_out) {
      float v = 0.0f;
      if (valid_b[s]) v = c_s[i] + (bias != nullptr ? bias[o] : 0.0f);
      out_b[(size_t)s * COUT + o] = v;
    }
  }
}

template <int COUT, int PHASES>
cudaError_t launch(const void* feats, const int32_t* rules, const void* w,
                   const float* bias, const uint8_t* out_valid, float* out,
                   int batch, int v_in, int v_out, int n_taps, int c,
                   cudaStream_t stream) {
  const size_t stage = (size_t)kTile * c * 2 + (size_t)c * COUT * 2 + kTile * 4;
  const size_t epilogue = (size_t)kTile * COUT * 4;
  const size_t smem = stage > epilogue ? stage : epilogue;
  cudaError_t err = cudaFuncSetAttribute(
      sparse_conv_kernel<COUT, PHASES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((v_out + kTile - 1) / kTile, batch);
  sparse_conv_kernel<COUT, PHASES><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(feats), rules,
      static_cast<const __nv_bfloat16*>(w), bias, out_valid, out, v_in, v_out,
      n_taps, c);
  return cudaGetLastError();
}

template <int PHASES>
int dispatch(const void* feats, const void* rules, const void* w,
             const void* bias, const void* out_valid, void* out, int batch,
             int v_in, int v_out, int n_taps, int c, int cout,
             void* stream) {
  if (v_out == 0 || batch == 0) return 0;
  const int32_t* r = static_cast<const int32_t*>(rules);
  const float* bs = static_cast<const float*>(bias);
  const uint8_t* vl = static_cast<const uint8_t*>(out_valid);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cout) {
    case 16: return launch<16, PHASES>(feats, r, w, bs, vl, o, batch, v_in, v_out, n_taps, c, st);
    case 32: return launch<32, PHASES>(feats, r, w, bs, vl, o, batch, v_in, v_out, n_taps, c, st);
    case 64: return launch<64, PHASES>(feats, r, w, bs, vl, o, batch, v_in, v_out, n_taps, c, st);
    case 128: return launch<128, PHASES>(feats, r, w, bs, vl, o, batch, v_in, v_out, n_taps, c, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface, loaded with ctypes. c must be a multiple of 16 (<= 256) and
// cout one of 16, 32, 64, 128; the caller checks shapes, dtypes,
// contiguity and alignment. Returns the cudaError_t of the launch.
extern "C" int sparse_conv_forward(const void* feats, const void* rules,
                                   const void* w, const void* bias,
                                   const void* out_valid, void* out, int batch,
                                   int v_in, int v_out, int n_taps, int c,
                                   int cout, void* stream) {
  return dispatch<kFull>(feats, rules, w, bias, out_valid, out, batch, v_in,
                         v_out, n_taps, c, cout, stream);
}

// The same kernel with the phases of `phases` (bits kGather = 1, kMma = 2);
// phases 3 is sparse_conv_forward's instantiation itself.
extern "C" int sparse_conv_probe(const void* feats, const void* rules,
                                 const void* w, const void* bias,
                                 const void* out_valid, void* out, int batch,
                                 int v_in, int v_out, int n_taps, int c,
                                 int cout, int phases, void* stream) {
  switch (phases) {
    case 0: return dispatch<0>(feats, rules, w, bias, out_valid, out, batch, v_in, v_out, n_taps, c, cout, stream);
    case kGather: return dispatch<kGather>(feats, rules, w, bias, out_valid, out, batch, v_in, v_out, n_taps, c, cout, stream);
    case kMma: return dispatch<kMma>(feats, rules, w, bias, out_valid, out, batch, v_in, v_out, n_taps, c, cout, stream);
    case kFull: return dispatch<kFull>(feats, rules, w, bias, out_valid, out, batch, v_in, v_out, n_taps, c, cout, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

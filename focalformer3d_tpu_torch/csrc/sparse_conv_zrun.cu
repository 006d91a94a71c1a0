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
// What bounds it on this card: as K1, the row gather (Cout FLOPs per
// gathered byte, far below the H100's ~295 FLOP/byte bf16 balance point).
// What the design does about it: one block owns 128 output sites of one
// sample and loops over the ky*kx BEV taps. Per BEV tap it stages, for every
// site, its up to three rows side by side (a 3C-wide A row; a full run is
// one contiguous 3C * 2-byte read) and the three taps' weights stacked
// (3C x Cout), so one tensor-core product with contraction 3C covers the
// three z taps (WMMA bf16 16x16x16, f32 accumulators in registers across all
// taps). A BEV tap that no site of the block uses is skipped by a
// block-wide vote. Bias, the out_valid mask and the store are the epilogue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kTile = 128;  // output sites per block
constexpr int kWarps = 8;   // one 16-row strip of the tile per warp
constexpr int kThreads = kWarps * 32;
constexpr int kZ = 3;       // z taps per code

template <int COUT>
__global__ void __launch_bounds__(kThreads)
zrun_conv_kernel(const __nv_bfloat16* __restrict__ feats,  // (B, V_in, C)
                 const int32_t* __restrict__ codes,        // (B, R, V_out)
                 const __nv_bfloat16* __restrict__ w,      // (3R, C, COUT)
                 const float* __restrict__ bias,           // (COUT,) or null
                 const uint8_t* __restrict__ out_valid,    // (B, V_out)
                 float* __restrict__ out,                  // (B, V_out, COUT)
                 int v_in, int v_out, int n_bev, int c) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ck = kZ * c;  // contraction per BEV tap
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem);  // kTile x ck
  __nv_bfloat16* b_s = a_s + kTile * ck;                        // ck x COUT
  int32_t* code_s = reinterpret_cast<int32_t*>(b_s + ck * COUT);  // kTile
  float* c_s = reinterpret_cast<float*>(smem);  // epilogue, kTile x COUT

  const int b = blockIdx.y;
  const int site0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int chunks = c / 8;        // 16-byte chunks per feature row
  const int row_chunks = kZ * chunks;
  const int w_chunks = c * COUT / 8;  // 16-byte chunks per tap's weights

  const int32_t* codes_b = codes + (size_t)b * n_bev * v_out;
  const uint4* feats_b =
      reinterpret_cast<const uint4*>(feats + (size_t)b * v_in * c);
  const uint4* w4 = reinterpret_cast<const uint4*>(w);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[COUT / 16];
#pragma unroll
  for (int n = 0; n < COUT / 16; ++n) wmma::fill_fragment(acc[n], 0.0f);

  for (int r = 0; r < n_bev; ++r) {
    int hit = 0;
    if (tid < kTile) {
      const int s = site0 + tid;
      const int code = s < v_out ? codes_b[(size_t)r * v_out + s] : 0;
      code_s[tid] = code;
      hit = (code & 7) != 0;
    }
    if (!__syncthreads_or(hit)) continue;  // no site of the tile uses tap r

    // A row of site i: [x(tap dz=0) | x(dz=1) | x(dz=2)], zero where absent
    for (int i = tid; i < kTile * row_chunks; i += kThreads) {
      const int row = i / row_chunks;
      const int j = i - row * row_chunks;
      const int dz = j / chunks;
      const int code = code_s[row];
      const int pat = code & 7;
      uint4 v = make_uint4(0, 0, 0, 0);
      if ((pat >> dz) & 1) {
        const int src = (code >> 3) + __popc(pat & ((1 << dz) - 1));
        if ((unsigned)src < (unsigned)v_in) {
          v = feats_b[(size_t)src * chunks + (j - dz * chunks)];
        }
      }
      reinterpret_cast<uint4*>(a_s)[i] = v;
    }
    // B rows [dz*c, (dz+1)*c) hold W[dz * R + r]
    for (int i = tid; i < kZ * w_chunks; i += kThreads) {
      const int dz = i / w_chunks;
      reinterpret_cast<uint4*>(b_s)[i] =
          w4[(size_t)(dz * n_bev + r) * w_chunks + (i - dz * w_chunks)];
    }
    __syncthreads();

    for (int kc = 0; kc < ck / 16; ++kc) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, a_s + warp * 16 * ck + kc * 16, ck);
#pragma unroll
      for (int n = 0; n < COUT / 16; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
        wmma::load_matrix_sync(bf, b_s + kc * 16 * COUT + n * 16, COUT);
        wmma::mma_sync(acc[n], a, bf, acc[n]);
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

template <int COUT>
cudaError_t launch(const void* feats, const int32_t* codes, const void* w,
                   const float* bias, const uint8_t* out_valid, float* out,
                   int batch, int v_in, int v_out, int n_bev, int c,
                   cudaStream_t stream) {
  const size_t ck = (size_t)kZ * c;
  const size_t stage = kTile * ck * 2 + ck * COUT * 2 + kTile * 4;
  const size_t epilogue = (size_t)kTile * COUT * 4;
  const size_t smem = stage > epilogue ? stage : epilogue;
  cudaError_t err = cudaFuncSetAttribute(
      zrun_conv_kernel<COUT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((v_out + kTile - 1) / kTile, batch);
  zrun_conv_kernel<COUT><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(feats), codes,
      static_cast<const __nv_bfloat16*>(w), bias, out_valid, out, v_in, v_out,
      n_bev, c);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. c must be a multiple of 16 (<= 128) and
// cout one of 16, 32, 64, 128; w holds 3 * n_bev taps, dz-major. The caller
// checks shapes, dtypes, contiguity and alignment. Returns the cudaError_t
// of the launch.
extern "C" int sparse_conv_zrun_forward(const void* feats, const void* codes,
                                        const void* w, const void* bias,
                                        const void* out_valid, void* out,
                                        int batch, int v_in, int v_out,
                                        int n_bev, int c, int cout,
                                        void* stream) {
  if (v_out == 0 || batch == 0) return 0;
  const int32_t* cd = static_cast<const int32_t*>(codes);
  const float* bs = static_cast<const float*>(bias);
  const uint8_t* vl = static_cast<const uint8_t*>(out_valid);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cout) {
    case 16: return launch<16>(feats, cd, w, bs, vl, o, batch, v_in, v_out, n_bev, c, st);
    case 32: return launch<32>(feats, cd, w, bs, vl, o, batch, v_in, v_out, n_bev, c, st);
    case 64: return launch<64>(feats, cd, w, bs, vl, o, batch, v_in, v_out, n_bev, c, st);
    case 128: return launch<128>(feats, cd, w, bs, vl, o, batch, v_in, v_out, n_bev, c, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// k x k local-window attention on NHWC maps (the bevfusion neck's P_IML),
// logits, softmax and weighted sum in one kernel:
//
//   out[p] = sum_d softmax_d(<q[p], k[p + d]>) * v[p + d]
//
// over the k x k offsets d (row-major, dy then dx), out-of-image neighbours
// left out of the softmax.
//
// It replaces no TPU kernel: the JAX package computes this op with XLA ops
// (focalformer3d_tpu/ops/local_attn.py). It was added because the port's
// plain version, 81 shifted views of torch ops at k = 9, issued ~415 launches
// and a blocking host-to-device copy a call from the host, and the card sat
// idle behind them; its per-offset products also wrote a full map each, some
// 6.7 GB of traffic a call where the function needs q, k and v read once and
// out written once.
//
// What bounds it on this card: at the fusion layers' shape (1 x 180 x 180 x
// 128, bf16, k 9) the operations, 4 C k^2 a position (1.34 GFLOP), ~20 us on
// CUDA cores' float32 FMA, against 33.2 MB of operands, 9.9 us at 3.35 TB/s.
// The maps (8.3 MB each) stay in the 50 MB L2.
//
// What the design does about that. A block takes an 8 x 8 tile of output
// positions with all C channels. It copies the tile's q and the k halo
// (tile + k/2 each side) into shared memory, 16-byte cp.async chunks along C,
// out-of-image chunks zero-filled. Warp w computes the logits of offset row
// dy = w: each lane holds four neighbouring positions of one tile row and,
// for a slice of the channels, all k dx of each, so one k chunk read from
// shared memory feeds up to four positions (the band of a 1D correlation);
// the two channel halves of a lane pair are summed by one shuffle. Logits,
// softmax and the weighted sum are float32 throughout; the output is rounded
// once, at the store. The softmax takes a warp a position and skips the
// out-of-image neighbours by their coordinates (the plain version's -1e9
// logit, whose weight is 0 in float32; the centre is always valid), so no
// mask is built and nothing comes from the host. The v halo is copied into
// the k halo's place while the softmax runs. In the weighted sum a thread
// owns four positions and one 16-byte chunk of channels and walks the v
// halo row by row. A position's chunks are 16 bytes apart from one another
// and a halo row one chunk more than its positions, so the lanes of a
// quarter-warp fall in distinct banks at C = 128. Where asked, the softmax
// weights are also written, float32 (B, H, W, k^2), for the backward.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 8;  // output positions a block takes along H and W
constexpr int kMaxSmem = 232448;

template <typename T>
struct Chunk;  // a 16-byte chunk of channels, widened to float

template <>
struct Chunk<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static uint32_t pair(float a, float b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(pair(f[0], f[1]), pair(f[2], f[3]), pair(f[4], f[5]),
                      pair(f[6], f[7]));
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Shared memory in 16-byte chunks: a position holds nc chunks and one of
// padding, a row of the halo or of the q tile one chunk more than its
// positions.
struct Layout {
  int nc;        // chunks a position's channels take
  int pos;       // chunks from one position to the next
  int halo_row;  // chunks from one halo row to the next
  int q_row;     // chunks from one q tile row to the next
  int halo;      // chunks of the halo
  int q;         // chunks of the q tile
};

__host__ __device__ inline Layout layout(int nc, int ks) {
  Layout l;
  l.nc = nc;
  l.pos = nc + 1;
  l.halo_row = (kTile + ks - 1) * l.pos + 1;
  l.q_row = kTile * l.pos + 1;
  l.halo = (kTile + ks - 1) * l.halo_row;
  l.q = kTile * l.q_row;
  return l;
}

inline int smem_bytes(int nc, int ks) {
  const Layout l = layout(nc, ks);
  return (l.halo + l.q) * 16 + kTile * kTile * ks * ks * 4;
}

// Copies the (rows x cols) window of a map whose top-left position is
// (y0, x0), at `row` chunks a row, into shared memory; chunks outside the
// map are zero.
template <int NT, typename T>
__device__ __forceinline__ void stage(uint4* dst, const T* src, int rows,
                                      int cols, int row, const Layout& l,
                                      int y0, int x0, int h, int w) {
  constexpr int V = Chunk<T>::N;
  const int n = rows * cols * l.nc;
  for (int e = threadIdx.x; e < n; e += NT) {
    const int c = e % l.nc;
    const int yx = e / l.nc;
    const int hy = yx / cols, hx = yx - hy * cols;
    const int y = y0 + hy, x = x0 + hx;
    const bool in = y >= 0 && y < h && x >= 0 && x < w;
    const T* s = in ? src + ((size_t)y * w + x) * l.nc * V + c * V : src;
    cp_async16(dst + hy * row + hx * l.pos + c, s, in ? 16 : 0);
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(32 * K, 2)
local_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out,
                  float* __restrict__ weights,  // (B, H, W, K*K) or null
                  int h, int w, int nc) {
  constexpr int NT = 32 * K;
  constexpr int R = K / 2;
  constexpr int KK = K * K;
  constexpr int HX = kTile + K - 1;
  constexpr int V = Chunk<T>::N;
  extern __shared__ uint4 smem[];
  const Layout l = layout(nc, K);
  uint4* halo = smem;
  uint4* qs = smem + l.halo;
  float* s = reinterpret_cast<float*>(qs + l.q);  // (64, KK) logits, weights
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  const size_t map = (size_t)b * h * w * nc * V;
  q += map;
  k += map;
  v += map;
  out += map;

  stage<NT>(qs, q, kTile, kTile, l.q_row, l, y0, x0, h, w);
  stage<NT>(halo, k, kTile + K - 1, HX, l.halo_row, l, y0 - R, x0 - R, h, w);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const int lane = threadIdx.x & 31;
  {  // logits: warp dy; lane (half, row, group of four columns)
    const int dy = threadIdx.x >> 5;
    const int half = lane >> 4, r = (lane >> 1) & 7, g = lane & 1;
    float acc[4][K];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int dx = 0; dx < K; ++dx) acc[i][dx] = 0.f;
    const uint4* qrow = qs + r * l.q_row + 4 * g * l.pos;
    const uint4* krow = halo + (r + dy) * l.halo_row + 4 * g * l.pos;
#pragma unroll 1
    for (int c = half; c < nc; c += 2) {
      float qv[4][V];
#pragma unroll
      for (int i = 0; i < 4; ++i) Chunk<T>::load(qrow[i * l.pos + c], qv[i]);
#pragma unroll
      for (int j = 0; j < K + 3; ++j) {
        float kv[V];
        Chunk<T>::load(krow[j * l.pos + c], kv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int dx = j - i;
          if (dx < 0 || dx >= K) continue;
#pragma unroll
          for (int e = 0; e < V; ++e)
            acc[i][dx] = fmaf(qv[i][e], kv[e], acc[i][dx]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int dx = 0; dx < K; ++dx) {
        acc[i][dx] += __shfl_xor_sync(0xffffffffu, acc[i][dx], 16);
        if ((i >> 1) == half)
          s[(r * kTile + 4 * g + i) * KK + dy * K + dx] = acc[i][dx];
      }
  }
  __syncthreads();  // every k chunk read, every logit written

  stage<NT>(halo, v, kTile + K - 1, HX, l.halo_row, l, y0 - R, x0 - R, h, w);
  cp_async_commit();

  // softmax over the in-image neighbours, a warp a position
  for (int p = threadIdx.x >> 5; p < kTile * kTile; p += K) {
    const int y = y0 + p / kTile, x = x0 + p % kTile;
    const bool inside = y < h && x < w;
    float* row = s + p * KK;
    constexpr int kRounds = (KK + 31) / 32;
    float lg[kRounds];
    bool ok[kRounds];
    float m = -INFINITY;
#pragma unroll
    for (int t = 0; t < kRounds; ++t) {
      const int d = lane + 32 * t;
      const int yy = y + d / K - R, xx = x + d % K - R;
      ok[t] = inside && d < KK && yy >= 0 && yy < h && xx >= 0 && xx < w;
      lg[t] = ok[t] ? row[d] : -INFINITY;
      m = fmaxf(m, lg[t]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < kRounds; ++t) {
      lg[t] = ok[t] ? expf(lg[t] - m) : 0.f;
      sum += lg[t];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const bool keep = weights != nullptr && inside;
#pragma unroll
    for (int t = 0; t < kRounds; ++t) {
      const int d = lane + 32 * t;
      if (d >= KK) continue;
      const float wt = ok[t] ? lg[t] / sum : 0.f;
      row[d] = wt;
      if (keep) weights[(((size_t)b * h + y) * w + x) * KK + d] = wt;
    }
  }
  cp_async_wait_all();
  __syncthreads();  // the v halo and every weight in place

  // weighted sum: a thread (row, group of four columns, channel chunk)
  for (int it = threadIdx.x; it < kTile * 2 * nc; it += NT) {
    const int c = it % nc;
    const int rg = it / nc;
    const int r = rg >> 1, g = rg & 1;
    float acc[4][V];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < V; ++e) acc[i][e] = 0.f;
    const float* wp = s + (r * kTile + 4 * g) * KK;
#pragma unroll 1
    for (int dy = 0; dy < K; ++dy) {
      const uint4* vrow = halo + (r + dy) * l.halo_row + 4 * g * l.pos + c;
#pragma unroll
      for (int j = 0; j < K + 3; ++j) {
        float vv[V];
        Chunk<T>::load(vrow[j * l.pos], vv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int dx = j - i;
          if (dx < 0 || dx >= K) continue;
          const float wt = wp[i * KK + dy * K + dx];
#pragma unroll
          for (int e = 0; e < V; ++e) acc[i][e] = fmaf(wt, vv[e], acc[i][e]);
        }
      }
    }
    const int y = y0 + r;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int x = x0 + 4 * g + i;
      if (y < h && x < w)
        reinterpret_cast<uint4*>(out + ((size_t)y * w + x) * nc * V)[c] =
            Chunk<T>::pack(acc[i]);
    }
  }
}

template <typename T, int K>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* weights, int batch, int h, int w, int nc,
                   cudaStream_t stream) {
  const int smem = smem_bytes(nc, K);
  cudaError_t err = cudaFuncSetAttribute(
      local_attn_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, batch);
  local_attn_kernel<T, K><<<grid, 32 * K, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), weights, h, w, nc);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     float* weights, int batch, int h, int w, int nc, int ks,
                     cudaStream_t stream) {
  switch (ks) {
    case 3: return launch<T, 3>(q, k, v, out, weights, batch, h, w, nc, stream);
    case 5: return launch<T, 5>(q, k, v, out, weights, batch, h, w, nc, stream);
    case 7: return launch<T, 7>(q, k, v, out, weights, batch, h, w, nc, stream);
    case 9: return launch<T, 9>(q, k, v, out, weights, batch, h, w, nc, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface, loaded with ctypes. q, k, v and out are contiguous (batch, h,
// w, c) maps of one dtype (0 float32, 1 bfloat16), 16-byte aligned, c a
// whole number of 16-byte chunks; weights is null or a float32 (batch, h, w,
// ks * ks) map. ks is 3, 5, 7 or 9, and the block's shared memory (the
// wrapper's smem_bytes) at most 227 KB. Returns the cudaError_t of the
// launch.
extern "C" int local_attn_forward(const void* q, const void* k, const void* v,
                                  void* out, void* weights, int batch, int h,
                                  int w, int c, int ks, int dtype,
                                  void* stream) {
  if (batch == 0 || h == 0 || w == 0) return 0;
  const int chunk = dtype == 0 ? 4 : 8;
  if (dtype < 0 || dtype > 1 || c <= 0 || c % chunk != 0 ||
      smem_bytes(c / chunk, ks) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* wt = static_cast<float*>(weights);
  if (dtype == 0)
    return (int)dispatch<float>(q, k, v, out, wt, batch, h, w, c / chunk, ks,
                                st);
  return (int)dispatch<__nv_bfloat16>(q, k, v, out, wt, batch, h, w,
                                      c / chunk, ks, st);
}

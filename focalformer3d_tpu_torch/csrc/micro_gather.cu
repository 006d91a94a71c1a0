// Gather probes (kernel B) for Hopper: sums of rows gathered from a small
// window, and row gathers from a table in device memory.
//
// gather_taps replaces the Pallas functions
// tools/micro_gather_kernel.py:_ohdot_kernel, _take_kernel and
// _takerow_kernel (P6). For each row n of rel (n_tiles * T rows of K taps;
// the tiles play no part in the function) it computes
//
//   out[n, :] = bf16( sum_{k < K} f32(window[rel[n, k] / div, :]) )
//
// summed in tap order in f32 and rounded once; a row index outside [0, R)
// (or a negative rel) reads a zero row. The one-hot kernel indexes
// rel // pack (div = pack), the two take kernels rel (div = 1): for pack > 1
// they are different functions, so div is explicit.
//
// gather_rows replaces tools/micro_gather2.py:kernel and kernel2 (P7),
// which compute one function, out[n] = x[idx[n]] (exact; an index outside
// [0, V) reads a zero row). The TPU held the 4 MB table in VMEM; here it
// is read from device memory, where it stays in the 50 MB L2 cache.
//
// What bounds them on this card. gather_taps must read K int32 indices and
// write L bf16 values per row (P6: 47.7 MB, 0.0143 ms at 3.35 TB/s), but
// each 16-byte chunk of output also takes, per tap, one 16-byte read of
// the window, eight bf16 -> f32 conversions and eight f32 adds: about 20
// instructions, which at the card's full issue rate take 0.032 ms at P6's
// shapes, 2.3x the byte bound. Instructions bound it. gather_rows moves
// each row once in and once out; where the table is larger than the L2
// cache (P7's 64 MB tables) every gathered row comes from device memory,
// so its floor is a copy of the output, not the byte bound.
//
// What the design does about that:
//
// gather_taps runs persistent blocks (512 threads; 1024 where one block
// fills an SM's shared memory) over stages of `stage_rows` rows of rel.
// Route kSmem stages the window in shared memory once per block (not once
// per tile), behind it one zero row that every miss reads, so the tap loop
// has no branch; route kGlobal reads window rows from device memory
// (ld.global.nc: the window sits in L2 and, with little shared memory
// taken, in L1), for windows that do not fit beside the stages. A stage's
// indices arrive by coalesced cp.async into one of two buffers, the next
// stage's while this one sums; once landed they are turned in place into
// byte offsets of window rows (div by a multiply-high, the bounds test),
// once per index rather than once per 16-byte chunk that reads it. Each
// thread owns 16-byte output chunks (a half-warp per row at L = 128), reads
// eight taps' offsets, then issues their eight row reads, so the reads of
// one row do not wait on one another; the eight f32 sums stay in tap order
// in registers and the row is stored once, with a streaming hint. What is
// left per tap is the arithmetic itself.
//
// gather_rows route kLanes (rows under 256 B) gives each row a group of G
// lanes sized to the row (a warp moves 32 / G rows at once; rows of 512 B
// or more take a whole warp, which loops over the row). A warp reads the
// indices of its rows with one coalesced load and hands each to its group
// with __shfl_sync; all arithmetic is 32-bit but one row address per row,
// with no division. Each lane keeps four 16-byte loads in flight (four
// rows) before their stores; the table is read with ld.global.nc and the
// output written with st.global.cs, so the output streams past L2 and
// leaves a table that fits there in place. The grid is persistent. Route
// kBulk (rows of 256 B and more) gives each row one lane: a bulk copy of
// the row into shared memory, completed on the lane's mbarrier, then a
// bulk copy out; one instruction moves a wide row. rows_route in
// ops/micro_gather.py gives the measured times behind the choice.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

using mma90::cp_async16;
using mma90::cp_async4;
using mma90::cp_async_commit;
using mma90::cp_async_wait;
using mma90::smem_u32;

constexpr int kTapsThreads = 512;
constexpr int kTapsUnroll = 8;  // taps whose row reads are in flight at once
constexpr int kRowsThreads = 256;
constexpr int kRowsUnroll = 4;  // rows a lane has in flight
constexpr int kSmemLimit = 232448;
constexpr int kSmem = 0;
constexpr int kGlobal = 1;
constexpr int kLanes = 0;
constexpr int kBulk = 1;

// n / d for 0 <= n < 2^31 and d >= 1 by a multiply-high (Granlund and
// Montgomery): l = ceil(log2 d), m = floor(2^32 (2^l - d) / d) + 1, made by
// ops/micro_gather.py:fast_div_magic.
struct FastDiv {
  uint32_t m;
  int l;
};

__device__ __forceinline__ int fast_div(int n, FastDiv d) {
  const uint32_t u = static_cast<uint32_t>(n);
  return static_cast<int>((__umulhi(d.m, u) + u) >> d.l);
}

__device__ __forceinline__ void add_bf16x8(float (&acc)[8], const uint4& v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {  // bf16 -> f32 is the top half of a word
    acc[2 * j] += __uint_as_float(w[j] << 16);
    acc[2 * j + 1] += __uint_as_float(w[j] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 to_bf16x8(const float (&acc)[8]) {
  uint4 o;
  __nv_bfloat162* oe = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    oe[j] = __floats2bfloat162_rn(acc[2 * j], acc[2 * j + 1]);
  }
  return o;
}

// Shared bytes of one gather_taps block: on route kSmem the window and a
// zero row, then two stages of stage_rows * K int32 (each rounded up to 16
// bytes). ops/micro_gather.py:taps_plan computes the same.
__host__ __device__ __forceinline__ int taps_stage_ints(int stage_rows,
                                                        int n_taps) {
  return (stage_rows * n_taps + 3) / 4 * 4;
}

__host__ __device__ __forceinline__ int taps_window_bytes(int route,
                                                          int r_rows, int l) {
  return route == kSmem ? (r_rows + 1) * l * 2 : 0;
}

// The rel rows [r0, r0 + nr) into a stage buffer: 16-byte copies where the
// source is 16-byte aligned (vec16), the tail and all else 4 bytes at a time.
__device__ __forceinline__ void load_stage(int32_t* dst, const int32_t* src,
                                           int n, bool vec16) {
  const uint32_t d = smem_u32(dst);
  int done = 0;
  if (vec16) {
    const int n4 = n / 4;
    for (int i = threadIdx.x; i < n4; i += blockDim.x) {
      cp_async16(d + 16u * i, src + 4 * i);
    }
    done = n4 * 4;
  }
  for (int i = done + threadIdx.x; i < n; i += blockDim.x) {
    cp_async4(d + 4u * i, src + i);
  }
}

template <int kRoute>
__global__ void __launch_bounds__(2 * kTapsThreads, 1)
gather_taps_kernel(const int32_t* __restrict__ rel,           // (n_rows, K)
                   const __nv_bfloat16* __restrict__ window,  // (R, L)
                   __nv_bfloat16* __restrict__ out,           // (n_rows, L)
                   int n_rows, int n_taps, int r_rows, int l, FastDiv div,
                   FastDiv cpr_div, int stage_rows, int vec16) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row_bytes = l * 2;
  const int cpr = l / 8;  // 16-byte chunks per row
  const int win_bytes = taps_window_bytes(kRoute, r_rows, l);
  const int stage_ints = taps_stage_ints(stage_rows, n_taps);
  int32_t* stages = reinterpret_cast<int32_t*>(smem + win_bytes);
  const int n_stages = (n_rows + stage_rows - 1) / stage_rows;
  // a miss: the zero row behind the window (kSmem), or no read (kGlobal)
  const int miss = kRoute == kSmem ? r_rows * row_bytes : -1;

  if (kRoute == kSmem) {  // the window, once per block, with stage 0
    const uint32_t w = smem_u32(smem);
    for (int i = threadIdx.x; i < r_rows * cpr; i += blockDim.x) {
      cp_async16(w + 16u * i, reinterpret_cast<const uint4*>(window) + i);
    }
    for (int i = threadIdx.x; i < cpr; i += blockDim.x) {
      reinterpret_cast<uint4*>(smem + r_rows * row_bytes)[i] =
          make_uint4(0, 0, 0, 0);
    }
  }
  int s = blockIdx.x;
  if (s < n_stages) {
    const int nr = min(stage_rows, n_rows - s * stage_rows);
    load_stage(stages, rel + (size_t)s * stage_rows * n_taps, nr * n_taps,
               vec16);
  }
  cp_async_commit();

  for (int it = 0; s < n_stages; s += gridDim.x, ++it) {
    int32_t* st = stages + (it & 1) * stage_ints;
    cp_async_wait<0>();
    __syncthreads();  // this stage landed; the other buffer is free
    const int next = s + gridDim.x;
    if (next < n_stages) {
      const int nr = min(stage_rows, n_rows - next * stage_rows);
      load_stage(stages + ((it + 1) & 1) * stage_ints,
                 rel + (size_t)next * stage_rows * n_taps, nr * n_taps,
                 vec16);
    }
    cp_async_commit();

    const int r0 = s * stage_rows;
    const int nr = min(stage_rows, n_rows - r0);
    for (int i = threadIdx.x; i < nr * n_taps; i += blockDim.x) {
      const int r = st[i];
      const int row = r >= 0 ? fast_div(r, div) : r_rows;
      st[i] = row < r_rows ? row * row_bytes : miss;
    }
    __syncthreads();

    for (int i = threadIdx.x; i < nr * cpr; i += blockDim.x) {
      const int t = fast_div(i, cpr_div);
      const int ch16 = (i - t * cpr) * 16;
      const int32_t* offs = st + t * n_taps;
      const unsigned char* base =
          (kRoute == kSmem ? smem
                           : reinterpret_cast<const unsigned char*>(window)) +
          ch16;
      float acc[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = 0.0f;
      int k = 0;
      for (; k + kTapsUnroll <= n_taps; k += kTapsUnroll) {
        int o[kTapsUnroll];
        uint4 v[kTapsUnroll];
#pragma unroll
        for (int u = 0; u < kTapsUnroll; ++u) o[u] = offs[k + u];
#pragma unroll
        for (int u = 0; u < kTapsUnroll; ++u) {
          if (kRoute == kSmem) {
            v[u] = *reinterpret_cast<const uint4*>(base + o[u]);
          } else {
            v[u] = o[u] >= 0 ? __ldg(reinterpret_cast<const uint4*>(
                                   base + o[u]))
                             : make_uint4(0, 0, 0, 0);
          }
        }
#pragma unroll
        for (int u = 0; u < kTapsUnroll; ++u) add_bf16x8(acc, v[u]);
      }
      for (; k < n_taps; ++k) {
        const int o = offs[k];
        uint4 v;
        if (kRoute == kSmem) {
          v = *reinterpret_cast<const uint4*>(base + o);
        } else {
          v = o >= 0 ? __ldg(reinterpret_cast<const uint4*>(base + o))
                     : make_uint4(0, 0, 0, 0);
        }
        add_bf16x8(acc, v);
      }
      __stcs(reinterpret_cast<uint4*>(out + (size_t)(r0 + t) * l) +
                 (i - t * cpr),
             to_bf16x8(acc));
    }
  }
}

// Route kLanes: groups of G lanes, one row each; a warp moves 32 / G rows a
// step and kRowsUnroll steps at once.
template <int G>
__global__ void __launch_bounds__(kRowsThreads)
gather_rows_kernel(const uint4* __restrict__ x,        // (V, chunks)
                   const int32_t* __restrict__ idx,    // (N,)
                   uint4* __restrict__ out,            // (N, chunks)
                   int v, int n, int chunks) {
  constexpr int kSub = 32 / G;                   // rows per warp step
  constexpr int kRows = kRowsUnroll * kSub;      // rows per warp iteration
  constexpr int kWords = (kRows + 31) / 32;      // index loads per lane
  const int lane = threadIdx.x & 31;
  const int sub = lane / G;
  const int gl = lane % G;
  const unsigned warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const unsigned n_warps = (gridDim.x * blockDim.x) >> 5;
  for (unsigned base = warp * kRows; base < (unsigned)n;
       base += n_warps * kRows) {
    int word[kWords];
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      const unsigned k = base + j * 32 + lane;
      word[j] = k < (unsigned)n ? __ldcs(idx + k) : -1;
    }
    const uint4* src[kRowsUnroll];
    uint4* dst[kRowsUnroll];
    bool hit[kRowsUnroll], live[kRowsUnroll];
#pragma unroll
    for (int u = 0; u < kRowsUnroll; ++u) {
      // row u * kSub + sub of the iteration: word u / G, lane (u * kSub) % 32
      // + sub, for every power of two G
      const int r = __shfl_sync(0xffffffffu, word[u / G],
                                (u * kSub) % 32 + sub);
      const unsigned row = base + u * kSub + sub;
      hit[u] = (unsigned)r < (unsigned)v;
      live[u] = row < (unsigned)n;
      src[u] = x + (size_t)(hit[u] ? r : 0) * chunks;
      dst[u] = out + (size_t)(live[u] ? row : 0) * chunks;
    }
#pragma unroll 2
    for (int c = gl; c < chunks; c += G) {
      uint4 val[kRowsUnroll];
#pragma unroll
      for (int u = 0; u < kRowsUnroll; ++u) {
        val[u] = hit[u] ? __ldg(src[u] + c) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kRowsUnroll; ++u) {
        if (live[u]) __stcs(dst[u] + c, val[u]);
      }
    }
  }
}

// Route kBulk: a block of one warp, one row per lane; the lane copies its
// row into shared memory with one bulk copy completed on its own mbarrier,
// then out with another. A miss is written as zeros by the lane.
__global__ void __launch_bounds__(32)
gather_rows_bulk_kernel(const unsigned char* __restrict__ x,
                        const int32_t* __restrict__ idx,
                        unsigned char* __restrict__ out, int v, int n,
                        int row_bytes, int rows_per_block) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x;
  const int row = blockIdx.x * rows_per_block + lane;
  if (lane >= rows_per_block || row >= n) return;
  const int r = idx[row];
  unsigned char* dst = out + (size_t)row * row_bytes;
  if ((unsigned)r >= (unsigned)v) {
    for (int i = 0; i < row_bytes; i += 16) {
      __stcs(reinterpret_cast<uint4*>(dst + i), make_uint4(0, 0, 0, 0));
    }
    return;
  }
  const uint32_t bar = smem_u32(smem + 8 * lane);
  const uint32_t buf = smem_u32(smem + 256 + lane * row_bytes);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(row_bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(buf), "l"(x + (size_t)r * row_bytes), "r"(row_bytes), "r"(bar)
      : "memory");
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], 0;\n"
      "@!p bra WAIT;\n"
      "}\n" :: "r"(bar) : "memory");
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(dst), "r"(buf), "r"(row_bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// Persistent blocks: the SMs times the blocks of `kernel` that fit on one,
// at most `useful`.
template <typename Kernel>
int persistent_grid(Kernel kernel, int threads, int smem, long long useful,
                    int* grid) {
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  long long g = (long long)sm_count() * per_sm;
  *grid = (int)(g < useful ? g : useful);
  return 0;
}

template <int kRoute>
int launch_taps(const int32_t* rel, const __nv_bfloat16* window,
                __nv_bfloat16* out, int n_rows, int n_taps, int r_rows,
                int l, FastDiv div, FastDiv cpr_div, int stage_rows,
                int vec16, cudaStream_t stream) {
  auto kernel = gather_taps_kernel<kRoute>;
  const int smem = taps_window_bytes(kRoute, r_rows, l)
                   + 2 * 4 * taps_stage_ints(stage_rows, n_taps);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // where the shared memory lets one block on an SM, that block takes
  // twice the threads: the same window copy, twice the warps
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kTapsThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = per_sm == 1 ? 2 * kTapsThreads : kTapsThreads;
  int grid = 0;
  const int n_stages = (n_rows + stage_rows - 1) / stage_rows;
  int e = persistent_grid(kernel, threads, smem, n_stages, &grid);
  if (e) return e;
  kernel<<<grid, threads, smem, stream>>>(
      rel, window, out, n_rows, n_taps, r_rows, l, div, cpr_div, stage_rows,
      vec16);
  return (int)cudaGetLastError();
}

template <int G>
int launch_rows(const void* x, const int32_t* idx, void* out, int v, int n,
                int chunks, cudaStream_t stream) {
  auto kernel = gather_rows_kernel<G>;
  constexpr int kRowsPerBlock = kRowsUnroll * (32 / G) * (kRowsThreads / 32);
  int grid = 0;
  int e = persistent_grid(kernel, kRowsThreads, 0,
                          ((long long)n + kRowsPerBlock - 1) / kRowsPerBlock,
                          &grid);
  if (e) return e;
  kernel<<<grid, kRowsThreads, 0, stream>>>(
      static_cast<const uint4*>(x), idx, static_cast<uint4*>(out), v, n,
      chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// C interfaces, loaded with ctypes; the caller checks shapes, dtypes,
// contiguity and 16-byte alignment of the window and the table, and picks
// the route and its sizes (ops/micro_gather.py: taps_plan, rows_plan).
// Return the cudaError_t of the launch.

// n_rows = n_tiles * T rows of n_taps int32 in rel; l a multiple of 8;
// (div_m, div_l) and (cpr_m, cpr_l) the magic numbers of div and of l / 8;
// route 0 (window in shared memory) or 1 (window rows from device memory);
// vec16: rel's address and stage_rows * n_taps are multiples of 16 bytes
// and 4 values.
extern "C" int micro_gather_taps(const void* rel, const void* window,
                                 void* out, int n_rows, int n_taps,
                                 int r_rows, int l, unsigned div_m, int div_l,
                                 unsigned cpr_m, int cpr_l, int route,
                                 int stage_rows, int vec16, void* stream) {
  if (n_rows == 0) return 0;
  if (n_taps < 1 || stage_rows < 1 || l % 8 ||
      (route != kSmem && route != kGlobal)) {
    return (int)cudaErrorInvalidValue;
  }
  auto fn = route == kSmem ? &launch_taps<kSmem> : &launch_taps<kGlobal>;
  return fn(static_cast<const int32_t*>(rel),
            static_cast<const __nv_bfloat16*>(window),
            static_cast<__nv_bfloat16*>(out), n_rows, n_taps, r_rows, l,
            FastDiv{div_m, div_l}, FastDiv{cpr_m, cpr_l}, stage_rows, vec16,
            static_cast<cudaStream_t>(stream));
}

// c a multiple of 8; route 0 (lane groups of `lanes`, a power of two up to
// 32 with lanes >= c / 8 below 32) or 1 (bulk copies, `bulk_rows` <= 32
// rows a block).
extern "C" int micro_gather_rows(const void* x, const void* idx, void* out,
                                 int v, int n, int c, int route, int lanes,
                                 int bulk_rows, void* stream) {
  if (n == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  const int chunks = c / 8;
  if (route == kBulk) {
    if (bulk_rows < 1 || bulk_rows > 32) return (int)cudaErrorInvalidValue;
    const int smem = 256 + bulk_rows * c * 2;
    if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        gather_rows_bulk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    const int grid = (n + bulk_rows - 1) / bulk_rows;
    gather_rows_bulk_kernel<<<grid, 32, smem, st>>>(
        static_cast<const unsigned char*>(x), ix,
        static_cast<unsigned char*>(out), v, n, c * 2, bulk_rows);
    return (int)cudaGetLastError();
  }
  if (route != kLanes || (lanes < 32 && lanes < chunks)) {
    return (int)cudaErrorInvalidValue;
  }
  switch (lanes) {
    case 1: return launch_rows<1>(x, ix, out, v, n, chunks, st);
    case 2: return launch_rows<2>(x, ix, out, v, n, chunks, st);
    case 4: return launch_rows<4>(x, ix, out, v, n, chunks, st);
    case 8: return launch_rows<8>(x, ix, out, v, n, chunks, st);
    case 16: return launch_rows<16>(x, ix, out, v, n, chunks, st);
    case 32: return launch_rows<32>(x, ix, out, v, n, chunks, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

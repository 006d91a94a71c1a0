// Rulebook builder (K2) for Hopper: the absolute (K, V_out) rulebook of one
// sparse-conv geometry, from the input level's column meta and the packed
// output sites; and, below it, the coordinate engines' index build (column
// tables and a strided conv's output set).
//
// Replaces the TPU kernel focalformer3d_tpu/ops/plan_builder.py:_plan_kernel.
// It computes what that kernel computes, without the TPU workaround: per
// (output site, tap) it fetches the tap column's meta row
// [zbits lo, zbits hi, row_start, count], tests the z bit and writes
// row_start + popcount rank. Misses (off the grid, empty column, clear bit,
// padded site) get in_capacity, as plan_builder.decode_rules gives them, and
// so do positions past in_capacity (voxels a capacity-bound downsample
// dropped), as sparse_conv.build_conv_rules clips them. The
// TPU kernel's byte-chunk packing, one-hot MXU selection, 2048-column
// windows, column-window-miss and feature-window-overflow codes exist
// because a TPU gathers rows badly; a card fetches a 16-byte meta row
// directly, so the output is the rulebook the sparse-conv kernel (K1) reads.
//
// What bounds it on this card: per (site, BEV tap) one 16-byte meta row
// gather (the tables of a level are at most 33 MB, mostly L2-resident) and
// kz 4-byte rule stores; the arithmetic is a few integer ops and __popcll
// per tap. It is memory bound, by the scattered meta reads and the
// K * V_out * 4 bytes of rulebook it writes.
//
// What the design does about that: one thread per (site, BEV tap) loads the
// meta row once (one 16-byte vector load) and serves all kz z-taps from it.
// Threads of a block take consecutive sites of one tap, so the colz reads and
// the rulebook stores are coalesced, and neighbouring sites (CSR order)
// fetch neighbouring columns.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Geometry {
  int kz, ky, kx;
  int sz, sy, sx;
  int pz, py, px;
  int d, h, w;  // input grid
  int out_w;    // output grid width (decodes the packed sites)
};

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
plan_rules_kernel(const int4* __restrict__ meta,    // (B, n_col + 1) rows
                  const int32_t* __restrict__ colz,  // (B, V_out)
                  int32_t* __restrict__ rules,       // (B, K, V_out)
                  Geometry g, int v_out, int in_capacity) {
  const int site = blockIdx.x * kThreads + threadIdx.x;
  if (site >= v_out) return;
  const int tap = blockIdx.y;  // dy * kx + dx
  const int b = blockIdx.z;
  const int n_bev = g.ky * g.kx;
  const int n_col = g.h * g.w;
  int32_t* out = rules + ((size_t)b * g.kz * n_bev + tap) * v_out + site;

  const int cz = colz[(size_t)b * v_out + site];
  int ok = cz >= 0;
  uint64_t bits = 0;
  int start = 0;
  int z0 = 0;
  if (ok) {
    const int col = cz >> 6;
    const int y = col / g.out_w;
    const int x = col - y * g.out_w;
    const int yi = y * g.sy - g.py + tap / g.kx;
    const int xi = x * g.sx - g.px + tap % g.kx;
    ok = yi >= 0 && yi < g.h && xi >= 0 && xi < g.w;
    if (ok) {
      const int4 m = meta[(size_t)b * (n_col + 1) + yi * g.w + xi];
      bits = (uint64_t)(uint32_t)m.x | ((uint64_t)(uint32_t)m.y << 32);
      start = m.z;
    }
    z0 = (cz & 63) * g.sz - g.pz;
  }
  for (int dz = 0; dz < g.kz; ++dz) {
    const int zi = z0 + dz;
    int pos = in_capacity;
    if (ok && zi >= 0 && zi < g.d && ((bits >> zi) & 1ull)) {
      pos = min(start + __popcll(bits & ((1ull << zi) - 1ull)), in_capacity);
    }
    out[(size_t)dz * n_bev * v_out] = pos;
  }
}


// ---------------------------------------------------------------------------
// The index build of the coordinate engines: a level's column table and a
// strided conv's active output set. Replaces no TPU kernel: the JAX engines
// build these with XLA ops, and so did the port (sparse_conv.build_table_csr
// and build_downsample, some 1 000 int64 torch ops a scan, which stay as the
// plain versions). Bit for bit what those functions give:
//
//   table:      meta[col] = [zbits lo, zbits hi, row_start, count] of the
//               valid voxels, row_start the exclusive cumsum of count, and
//               the overflow row [0, 0, total, 0];
//   downsample: the output column's z-bits (the OR over its ky*kx input
//               columns of their kz-window, sz-strided z-bits), its meta as
//               above, and the output sites in CSR order, (zo, yo, xo) at
//               row_start + rank, rows past out_capacity dropped; out_valid
//               the first min(total, out_capacity) rows, the other rows
//               (0, 0, 0); overflow = max(total - out_capacity, 0).
//
// What bounds it: bytes. A table writes 16 B per column (33 MB at 1440^2)
// and reads the column words twice; a downsample reads ky*kx input words
// per output column (L2-resident) and writes a quarter of that meta. The
// arithmetic is a few integer ops and a popcount per column.
//
// Three kernels and a memset, each with the batch in blockIdx.z:
//   1. column_bits: the valid voxels' z-bits OR-ed into a zeroed 64-bit
//      word per input column (atomicOr; voxels are unique, so this is what
//      the plain version's scatter-add gives). The input bits come from the
//      valid coordinates, never from a stored meta: past a capacity a
//      downsampled level's meta still holds the voxels it dropped.
//   2. column_count: one thread per output column (kColsPerThread of them,
//      strided by the block so that loads coalesce) forms its z-word (for a
//      downsample, from its input columns' words; for a table, the word
//      itself) and popcounts it; each block writes its tile's sum.
//   3. column_write: each block sums the tile sums before its own (no
//      look-back chain: at most ~1 200 of them, read from L2), scans its
//      tile's counts in kColsPerThread block-wide steps, writes its meta
//      rows as 16-byte stores and, for a downsample, each occupied column's
//      sites, its share of out_valid and of the zeroed tail.
// ---------------------------------------------------------------------------

struct DownGeometry {
  int kz, ky, kx;
  int sz, sy, sx;
  int pz, py, px;
  int d, h, w;     // input grid
  int od, oh, ow;  // output grid
};

constexpr int kScanThreads = 256;
constexpr int kWarps = kScanThreads / 32;
constexpr int kColsPerThread = 8;
constexpr int kTile = kScanThreads * kColsPerThread;  // columns a block

__global__ void __launch_bounds__(kScanThreads)
column_bits_kernel(const int32_t* __restrict__ coords,  // (B, V, 3) zyx
                   const uint8_t* __restrict__ valid,   // (B, V)
                   unsigned long long* __restrict__ bits,  // (B, H*W)
                   int v, int h, int w) {
  const int i = blockIdx.x * kScanThreads + threadIdx.x;
  if (i >= v) return;
  const size_t s = (size_t)blockIdx.z * v + i;
  if (!valid[s]) return;
  const long long col = (long long)coords[3 * s + 1] * w + coords[3 * s + 2];
  const long long n_col = (long long)h * w;
  if (col < 0 || col >= n_col) return;  // off the grid: not a table's voxel
  // z is in [0, d) for a table's voxel; the clamp is the plain version's
  const int z = min(max(coords[3 * s], 0), 63);
  atomicOr(bits + (size_t)blockIdx.z * n_col + col, 1ull << z);
}

// Sum over the block, returned to every thread. smem holds kWarps ints.
__device__ __forceinline__ int block_sum(int v, int* smem) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();  // the previous call's readers are done with smem
  if ((threadIdx.x & 31) == 0) smem[threadIdx.x >> 5] = v;
  __syncthreads();
  int total = 0;
  for (int i = 0; i < kWarps; ++i) total += smem[i];
  return total;
}

// Exclusive scan over the block in thread order; every thread also gets
// the block's total. smem holds kWarps ints.
__device__ __forceinline__ int block_scan(int v, int* smem, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += n;
  }
  __syncthreads();
  if (lane == 31) smem[warp] = incl;
  __syncthreads();
  int before = 0, all = 0;
  for (int i = 0; i < kWarps; ++i) {
    const int s = smem[i];
    before += i < warp ? s : 0;
    all += s;
  }
  *total = all;
  return before + incl - v;
}

// The z-word of output column col: the OR of its in-grid input columns'
// words, then bit zo set iff some set input bit zi = zo*sz - pz + dz,
// dz in [0, kz). (The z map commutes with the OR.)
__device__ __forceinline__ unsigned long long downsample_word(
    const unsigned long long* __restrict__ in, const DownGeometry& g,
    int col) {
  const int yo = col / g.ow;
  const int xo = col - yo * g.ow;
  unsigned long long u = 0;
  for (int dy = 0; dy < g.ky; ++dy) {
    const int yi = yo * g.sy - g.py + dy;
    if (yi < 0 || yi >= g.h) continue;
    for (int dx = 0; dx < g.kx; ++dx) {
      const int xi = xo * g.sx - g.px + dx;
      if (xi >= 0 && xi < g.w) u |= __ldg(in + (size_t)yi * g.w + xi);
    }
  }
  unsigned long long out = 0;
  const int od = min(g.od, 64);
  while (u) {
    const int zi = __ffsll((long long)u) - 1;
    u &= u - 1;
    for (int dz = 0; dz < g.kz; ++dz) {
      const int n = zi + g.pz - dz;  // zo * sz
      if (n >= 0 && n % g.sz == 0 && n / g.sz < od) out |= 1ull << (n / g.sz);
    }
  }
  return out;
}

// words == nullptr: a table (the column's word is its input word).
__global__ void __launch_bounds__(kScanThreads)
column_count_kernel(const unsigned long long* __restrict__ bits,
                    unsigned long long* __restrict__ words,
                    int* __restrict__ tile_sums, DownGeometry g, int n_out,
                    int n_tiles) {
  __shared__ int smem[kWarps];
  const int b = blockIdx.z;
  const unsigned long long* in = bits + (size_t)b * g.h * g.w;
  int count = 0;
  for (int k = 0; k < kColsPerThread; ++k) {
    const int col = blockIdx.x * kTile + k * kScanThreads + threadIdx.x;
    if (col < n_out) {
      unsigned long long word;
      if (words != nullptr) {
        word = downsample_word(in, g, col);
        words[(size_t)b * n_out + col] = word;
      } else {
        word = in[col];
      }
      count += __popcll(word);
    }
  }
  count = block_sum(count, smem);
  if (threadIdx.x == 0) tile_sums[(size_t)b * n_tiles + blockIdx.x] = count;
}

// out_coords == nullptr: a table (meta alone).
__global__ void __launch_bounds__(kScanThreads)
column_write_kernel(const unsigned long long* __restrict__ words,  // (B, n)
                    const int* __restrict__ tile_sums,  // (B, n_tiles)
                    int4* __restrict__ meta,             // (B, n + 1)
                    int32_t* __restrict__ out_coords,    // (B, cap, 3)
                    uint8_t* __restrict__ out_valid,     // (B, cap)
                    long long* __restrict__ overflow,    // (B,)
                    int n_out, int n_tiles, int ow, int capacity) {
  __shared__ int smem[kWarps];
  const int b = blockIdx.z;
  const int t = blockIdx.x;
  const int* sums = tile_sums + (size_t)b * n_tiles;
  int before = 0, all = 0;
  for (int j = threadIdx.x; j < n_tiles; j += kScanThreads) {
    const int s = sums[j];
    before += j < t ? s : 0;
    all += s;
  }
  int running = block_sum(before, smem);
  const int total = block_sum(all, smem);
  const unsigned long long* wb = words + (size_t)b * n_out;
  int4* mb = meta + (size_t)b * (n_out + 1);
  int32_t* cb = out_coords == nullptr ? nullptr
                                      : out_coords + (size_t)b * capacity * 3;
  for (int k = 0; k < kColsPerThread; ++k) {
    const int col = t * kTile + k * kScanThreads + threadIdx.x;
    unsigned long long word = col < n_out ? wb[col] : 0ull;
    const int count = __popcll(word);
    int step;
    const int start = running + block_scan(count, smem, &step);
    running += step;
    if (col >= n_out) continue;
    mb[col] = make_int4((int)(uint32_t)word, (int)(uint32_t)(word >> 32),
                        start, count);
    if (out_coords == nullptr) continue;
    const int yo = col / ow;
    const int xo = col - yo * ow;
    for (int row = start; word != 0ull && row < capacity; ++row) {
      const int z = __ffsll((long long)word) - 1;
      word &= word - 1;
      int32_t* o = cb + (size_t)row * 3;
      o[0] = z;
      o[1] = yo;
      o[2] = xo;
    }
  }
  if (t == n_tiles - 1 && threadIdx.x == 0) {
    mb[n_out] = make_int4(0, 0, total, 0);
  }
  if (out_coords == nullptr) return;
  // this tile's share of the capacity's rows: valid flags, zeroed tail
  const int live = min(total, capacity);
  const int per = (capacity + n_tiles - 1) / n_tiles;
  const int hi = min(capacity, (t + 1) * per);
  for (int i = t * per + threadIdx.x; i < hi; i += kScanThreads) {
    out_valid[(size_t)b * capacity + i] = i < live;
    if (i >= live) {
      int32_t* o = cb + (size_t)i * 3;
      o[0] = 0;
      o[1] = 0;
      o[2] = 0;
    }
  }
  if (t == 0 && threadIdx.x == 0) {
    overflow[b] = total > capacity ? (long long)(total - capacity) : 0ll;
  }
}

int n_tiles_of(int n) { return (n + kTile - 1) / kTile; }

// memset of the column words, then column_bits.
cudaError_t launch_bits(const void* coords, const void* valid, void* bits,
                        int batch, int v, int h, int w, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(
      bits, 0, (size_t)batch * h * w * sizeof(unsigned long long), stream);
  if (err != cudaSuccess || v == 0) return err;
  dim3 grid((v + kScanThreads - 1) / kScanThreads, 1, batch);
  column_bits_kernel<<<grid, kScanThreads, 0, stream>>>(
      static_cast<const int32_t*>(coords), static_cast<const uint8_t*>(valid),
      static_cast<unsigned long long*>(bits), v, h, w);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. geom holds the 13 ints of Geometry in
// order (host memory). The caller checks shapes, dtypes, contiguity and the
// 16-byte alignment of meta. Returns the cudaError_t of the launch.
extern "C" int plan_rules_forward(const void* meta, const void* colz,
                                  void* rules, const int* geom, int batch,
                                  int v_out, int in_capacity, void* stream) {
  if (v_out == 0 || batch == 0) return 0;
  Geometry g;
  g.kz = geom[0]; g.ky = geom[1]; g.kx = geom[2];
  g.sz = geom[3]; g.sy = geom[4]; g.sx = geom[5];
  g.pz = geom[6]; g.py = geom[7]; g.px = geom[8];
  g.d = geom[9]; g.h = geom[10]; g.w = geom[11];
  g.out_w = geom[12];
  dim3 grid((v_out + kThreads - 1) / kThreads, g.ky * g.kx, batch);
  plan_rules_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(meta), static_cast<const int32_t*>(colz),
      static_cast<int32_t*>(rules), g, v_out, in_capacity);
  return (int)cudaGetLastError();
}

// Column table of a batch of CSR voxel sets (sparse_conv.build_table_csr).
// shape = (d, h, w) in host memory; bits is (batch, h*w) 64-bit scratch,
// tile_sums (batch, n_tiles) int scratch, meta (batch, h*w + 1, 4) int32
// (16-byte aligned). n_tiles must be ceil(h*w / kTile): the wrapper's
// count of the scans' tiles, checked against the kernels'. The caller checks
// shapes, dtypes and contiguity. Returns the first cudaError_t.
extern "C" int index_table_forward(const void* coords, const void* valid,
                                   void* bits, void* tile_sums, void* meta,
                                   const int* shape, int batch, int v,
                                   int n_tiles, void* stream) {
  const int h = shape[1], w = shape[2];
  const int n = h * w;
  if (n_tiles != n_tiles_of(n)) return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_bits(coords, valid, bits, batch, v, h, w, s);
  if (err != cudaSuccess) return (int)err;
  DownGeometry g{};
  g.h = h;
  g.w = w;
  dim3 grid(n_tiles, 1, batch);
  column_count_kernel<<<grid, kScanThreads, 0, s>>>(
      static_cast<const unsigned long long*>(bits), nullptr,
      static_cast<int*>(tile_sums), g, n, n_tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  column_write_kernel<<<grid, kScanThreads, 0, s>>>(
      static_cast<const unsigned long long*>(bits),
      static_cast<const int*>(tile_sums), static_cast<int4*>(meta), nullptr,
      nullptr, nullptr, n, n_tiles, w, 0);
  return (int)cudaGetLastError();
}

// Active output set of a strided conv over a batch of CSR voxel sets
// (sparse_conv.build_downsample). geom holds the 15 ints of DownGeometry in
// order (host memory). Scratch: bits (batch, h*w) and words (batch,
// oh*ow) 64-bit, tile_sums (batch, n_tiles) int, n_tiles = ceil(oh*ow /
// kTile). Outputs: meta (batch, oh*ow + 1, 4) int32 (16-byte aligned),
// out_coords (batch, capacity, 3) int32, out_valid (batch, capacity) bool,
// overflow (batch,) int64. Returns the first cudaError_t.
extern "C" int index_downsample_forward(
    const void* coords, const void* valid, void* bits, void* words,
    void* tile_sums, void* meta, void* out_coords, void* out_valid,
    void* overflow, const int* geom, int batch, int v, int capacity,
    int n_tiles, void* stream) {
  DownGeometry g;
  g.kz = geom[0]; g.ky = geom[1]; g.kx = geom[2];
  g.sz = geom[3]; g.sy = geom[4]; g.sx = geom[5];
  g.pz = geom[6]; g.py = geom[7]; g.px = geom[8];
  g.d = geom[9]; g.h = geom[10]; g.w = geom[11];
  g.od = geom[12]; g.oh = geom[13]; g.ow = geom[14];
  const int n = g.oh * g.ow;
  if (n_tiles != n_tiles_of(n)) return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_bits(coords, valid, bits, batch, v, g.h, g.w, s);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_tiles, 1, batch);
  column_count_kernel<<<grid, kScanThreads, 0, s>>>(
      static_cast<const unsigned long long*>(bits),
      static_cast<unsigned long long*>(words), static_cast<int*>(tile_sums),
      g, n, n_tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  column_write_kernel<<<grid, kScanThreads, 0, s>>>(
      static_cast<const unsigned long long*>(words),
      static_cast<const int*>(tile_sums), static_cast<int4*>(meta),
      static_cast<int32_t*>(out_coords), static_cast<uint8_t*>(out_valid),
      static_cast<long long*>(overflow), n, n_tiles, g.ow, capacity);
  return (int)cudaGetLastError();
}

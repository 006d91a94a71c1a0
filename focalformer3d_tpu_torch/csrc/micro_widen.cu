// Meta widening probe (kernel C) for Hopper.
//
// Replaces the Pallas function tools/micro_meta9.py:_widen_kernel (P9),
// the stencil kernel behind widen_pallas. With mp the column meta (n_col+1
// rows of 4 int32) between W + 1 zero rows in front and 2W + 2 behind, it
// computes, exactly,
//
//   out[r, 4t:4t+4] = mp[r + dy*W + dx],  t = 3*dy + dx,  r < n_col + W + 1
//
// the meta of the nine BEV neighbours of every column in one 144-byte row
// (the JAX package's widen_meta9 at a level's grid). The padding is not
// built: a read outside the meta is a zero row.
//
// What bounds it on this card: bytes. It reads the meta (16 bytes a
// column) and writes nine times as much; no arithmetic beyond addresses.
// At L0 the output (299 MB) is six times the 50 MB L2, so the stores go on
// to device memory and set the pace.
//
// What the design does about that: a block takes a tile of `tile_rows`
// output rows, which is one contiguous span of tile_rows x 144 bytes, and
// its 288 threads (nine warps) give each thread one 16-byte chunk of 32
// rows at a time: thread k writes tap k % 9 of row k / 9. A warp's store
// then covers 512 contiguous bytes (four whole 128-byte lines, since 32
// rows are 4608 = 9 x 512 bytes); a thread per row would store nine
// chunks 144 bytes apart, each warp store half-filling 32 sectors. A
// thread's tap, and so its offset into the meta, is the same for every
// row it writes: the loop has no division. Each chunk is read from the
// meta through L1 (a warp's 32 reads fall on three runs of about five
// neighbouring meta rows, one per dy; the three dy runs of a row lie 2W
// rows apart, close enough for the L2 to serve the second and third).
// Each thread issues the loads of kBatch passes before their stores, and
// stores with the streaming hint (st.global.cs): the output is written
// once and read by no later pass. widen_plan in ops/micro_widen.py picks
// the tile and gives the times behind it.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 288;  // nine warps: one pass is 32 rows x 9 taps
constexpr int kPassRows = kThreads / 9;
constexpr int kBatch = 4;  // passes whose loads are in flight at once

__global__ void __launch_bounds__(kThreads)
widen_meta9_kernel(const int4* __restrict__ meta,  // (n_meta, 4) int32
                   int4* __restrict__ out,         // (n_rows, 36) int32
                   int n_meta, int w, int n_rows, int tile_rows) {
  const int k = threadIdx.x;
  const int row = k / 9;  // of the pass
  const int t = k - 9 * row;
  const int off = (t / 3 - 1) * w + t % 3 - 1;  // row r reads meta r + off
  const int r0 = blockIdx.x * tile_rows;
  const int r_end = min(r0 + tile_rows, n_rows);
  int4* dst = out + (size_t)r0 * 9 + k;
  for (int p = r0 + row; p < r_end; p += kBatch * kPassRows) {
    int4 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int r = p + u * kPassRows;
      const int m = r + off;
      v[u] = make_int4(0, 0, 0, 0);
      if (r < r_end && (unsigned)m < (unsigned)n_meta) v[u] = __ldg(meta + m);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int r = p + u * kPassRows;
      if (r < r_end) __stcs(dst + (size_t)(r - r0 - row) * 9, v[u]);
    }
  }
}

}  // namespace

// C interface, loaded with ctypes: meta (n_meta, 4) int32, n_meta = n_col +
// 1, out (n_meta + w, 36) int32, both 16-byte aligned and contiguous (the
// caller checks); tile_rows a multiple of 32 and grid tiles that cover the
// n_meta + w rows (ops/micro_widen.py:widen_plan). Returns the cudaError_t
// of the launch.
extern "C" int micro_widen_meta9(const void* meta, void* out, int n_meta,
                                 int w, int tile_rows, int grid,
                                 void* stream) {
  const int n_rows = n_meta + w;
  if (n_rows <= 0) return 0;
  if (tile_rows <= 0 || tile_rows % kPassRows
      || (long long)grid * tile_rows < n_rows)
    return (int)cudaErrorInvalidValue;
  widen_meta9_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(meta), static_cast<int4*>(out), n_meta, w,
      n_rows, tile_rows);
  return (int)cudaGetLastError();
}

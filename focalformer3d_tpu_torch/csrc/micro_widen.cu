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
// What bounds it on this card: bytes; it reads the meta (16 bytes a column)
// and writes nine times as much. No arithmetic beyond addresses.
//
// What the design does about that: one thread per output row, nine 16-byte
// loads (neighbouring threads read neighbouring meta rows, which L1 and L2
// serve to the nine taps) and nine 16-byte stores of one contiguous row.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
widen_meta9_kernel(const int4* __restrict__ meta,  // (n_meta, 4) int32
                   int4* __restrict__ out,         // (n_rows, 36) int32
                   int n_meta, int w, int n_rows) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_rows) return;
  int4* o = out + (size_t)r * 9;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const int m = r + (t / 3) * w + (t % 3) - (w + 1);  // row of the meta
    int4 v = make_int4(0, 0, 0, 0);
    if ((unsigned)m < (unsigned)n_meta) v = meta[m];
    o[t] = v;
  }
}

}  // namespace

// C interface, loaded with ctypes: meta (n_meta, 4) int32, n_meta = n_col +
// 1, out (n_meta + w, 36) int32, both 16-byte aligned and contiguous (the
// caller checks). Returns the cudaError_t of the launch.
extern "C" int micro_widen_meta9(const void* meta, void* out, int n_meta,
                                 int w, void* stream) {
  const int n_rows = n_meta + w;
  if (n_rows <= 0) return 0;
  widen_meta9_kernel<<<(n_rows + kThreads - 1) / kThreads, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(meta), static_cast<int4*>(out), n_meta, w,
      n_rows);
  return (int)cudaGetLastError();
}

// Rulebook builder (K2) for Hopper: the absolute (K, V_out) rulebook of one
// sparse-conv geometry, from the input level's column meta and the packed
// output sites.
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

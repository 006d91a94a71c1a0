// Building blocks shared by the port's tensor-core kernels (K1 and K3 in
// sparse_conv_tile.cuh, dW in sparse_conv_wgrad.cu, kernel A in
// micro_dot.cu) on Hopper (sm_90a): 16-byte
// asynchronous copies with zero fill, the shared-memory tile layout both
// instruction routes read, ldmatrix + mma.sync m16n8k16, and the wgmma
// descriptor and m64nNk16 instructions, all bf16 operands with f32 sums.
//
// The tile layout ("KB32"): a tile of R rows by C bf16 channels is stored as
// C / 16 K-blocks of R rows x 32 bytes (one wgmma / mma.sync depth of 16
// values); inside a K-block row r starts at r * 32 and its two 16-byte
// halves are swapped where bit 2 of r is set. That is the wgmma
// descriptor's 32-byte swizzle for a K-major operand (pattern of 8 rows =
// 256 bytes, so every K-block and every 8-row group must start on a
// multiple of 256 bytes), and it makes the eight 16-byte rows of every 8x8
// ldmatrix tile fall in eight different 16-byte bank groups: neither route
// has a bank conflict, for any C that is a multiple of 16. Both operands
// are K-major: the left one as (rows, C), the right one transposed, as
// (N, C).
//
// Accumulators: thread t of a warp holds, for each 8-column block nb, four
// floats d[4 * nb + i]: rows (t / 4) and (t / 4) + 8 of the warp's 16-row
// strip (i >= 2 is the second row), columns nb * 8 + 2 * (t % 4) + (i & 1).
// A warpgroup's wgmma gives warp w (of 4) rows 16 w .. 16 w + 15 of its 64
// in the same arrangement, so both routes share their epilogues.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of the 16-byte chunk (row, K-block j, half h) in a KB32 tile
// of `rows` rows.
__host__ __device__ __forceinline__ uint32_t kb32_offset(int rows, int row,
                                                         int j, int h) {
  return static_cast<uint32_t>(j * rows + row) * 32u
         + static_cast<uint32_t>((h ^ ((row >> 2) & 1)) << 4);
}

// 16 bytes from global to shared memory, asynchronously; src_bytes 0 reads
// nothing and fills the 16 bytes with zeros (src must still be an address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

// 4 bytes from global to shared memory, asynchronously.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Makes shared-memory writes of this thread (stores, cp.async) visible to
// the asynchronous proxy through which wgmma reads its operands.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier over `threads` threads (a multiple of 32) with hardware id `id`
// (1..15; 0 is __syncthreads).
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// ---- mma.sync route -------------------------------------------------------

// Four 8x8 bf16 tiles; lane l gives the address of row (l % 8) of tile l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}

// The same four tiles transposed: thread t receives elements (2 (t % 4) + i,
// t / 4), i = 0, 1, of each tile as stored, so a tile stored (k rows, m or n
// columns) arrives as mma.sync's (m, k) or (k, n) fragment.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}

// The address lane `lane` gives ldmatrix_x4 for the left operand's 16 x 16
// fragment (rows row0 .. row0 + 15 of K-block j): tiles in the order
// (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7, k 8-15), (rows 8-15,
// k 8-15), which is mma.sync's a0..a3.
__device__ __forceinline__ uint32_t frag_a_offset(int rows, int row0, int j,
                                                  int lane) {
  const int t = lane >> 3;
  return kb32_offset(rows, row0 + ((t & 1) << 3) + (lane & 7), j, t >> 1);
}

// The same for the transposed right operand's columns n0 .. n0 + 15: tiles
// (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15), which
// is b0, b1 of column block n0 / 8 and b0, b1 of the next.
__device__ __forceinline__ uint32_t frag_b_offset(int rows, int n0, int j,
                                                  int lane) {
  const int t = lane >> 3;
  return kb32_offset(rows, n0 + ((t >> 1) << 3) + (lane & 7), j, t & 1);
}

__device__ __forceinline__ void mma_m16n8k16(float* d, const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One depth-16 step of a warp's 16-row strip: d (16 x N) += A (16 x 16) @ B.
// a_tile / b_tile are the shared addresses of the KB32 tiles.
template <int N>
__device__ __forceinline__ void warp_mma_k16(float (&d)[N / 2],
                                             uint32_t a_tile, int a_rows,
                                             int row0, uint32_t b_tile,
                                             int b_rows, int n0, int j,
                                             int lane) {
  uint32_t a[4];
  ldmatrix_x4(a, a_tile + frag_a_offset(a_rows, row0, j, lane));
#pragma unroll
  for (int p = 0; p < N / 16; ++p) {
    uint32_t b[4];
    ldmatrix_x4(b, b_tile + frag_b_offset(b_rows, n0 + p * 16, j, lane));
    mma_m16n8k16(&d[8 * p], a, b[0], b[1]);
    mma_m16n8k16(&d[8 * p + 4], a, b[2], b[3]);
  }
}

// ---- wgmma route ----------------------------------------------------------

// Descriptor of a K-major KB32 operand whose first row is at shared address
// `addr` (a multiple of 256): start address >> 4 in bits 0-13, leading byte
// offset (unused for a swizzled K-major operand, set to 1) in bits 16-29,
// stride byte offset = 256 bytes between 8-row groups (>> 4) in bits 32-45,
// swizzle mode 3 (32 bytes) in bits 62-63.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4)
         | (static_cast<uint64_t>(1) << 16)
         | (static_cast<uint64_t>(256 >> 4) << 32)
         | (static_cast<uint64_t>(3) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// d (64 x N, f32) += A (64 x 16) @ B (16 x N), both from shared memory; one
// overload per N = 16, 32, 64, 128 (N / 2 accumulator registers a thread).
__device__ __forceinline__ void wgmma_m64k16(float (&d)[8], uint64_t desc_a,
                                             uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64k16(float (&d)[16], uint64_t desc_a,
                                             uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64k16(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64k16(float (&d)[64], uint64_t desc_a,
                                             uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

}  // namespace mma90

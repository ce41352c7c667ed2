// Tensor-core building blocks of the port's bf16 kernels (K4's persistent
// pre-transformer, K6's residual units): 16-byte asynchronous copies into
// shared memory, ldmatrix, and the warp-level bf16 MMA m16n8k16 with fp32
// accumulation.
//
// Fragment layout of mma.sync.m16n8k16.row.col (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major)  a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)  a3 (g+8, 2t+8..)
//   B (16 x 8, k-major)     b0 (k 2t..2t+1, n g)              b1 (k 2t+8.., n g)
//   C (16 x 8, fp32)        c0 c1 (g, 2t..2t+1)               c2 c3 (g+8, 2t..2t+1)
// qt_ldsm_a loads A from a row-major bf16 tile; qt_ldsm_b loads B for two
// adjacent n8 tiles from a [k][n] row-major tile (ldmatrix .trans). Both
// take the tile's top-left element and its row stride in elements; the
// stride times 2 bytes must be a multiple of 16.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t qt_saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, bypassing L1; bytes beyond `src_bytes` (0 or
// 16) are zero-filled, so a masked chunk reads nothing.
__device__ __forceinline__ void qt_cp16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               ::"r"(qt_saddr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void qt_cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void qt_cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void qt_ldsm_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int ld) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* p = tile + (lane & 15) * ld + (lane >> 4) * 8;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(qt_saddr(p)));
}

// b[0..1]: the n8 tile at columns [0, 8); b[2..3]: the one at [8, 16).
__device__ __forceinline__ void qt_ldsm_b(uint32_t (&b)[4], const __nv_bfloat16* tile, int ld) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* p = tile + (lane & 15) * ld + (lane >> 4) * 8;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(qt_saddr(p)));
}

// A [k][16] bf16 weight slice (16 columns, 32 bytes a row, no padding)
// keeps the two 16-byte halves of row k swapped when bit 2 of k is set,
// which keeps ldmatrix free of bank conflicts: where half `half` (0 or 1)
// of row k lives.
__device__ __forceinline__ int qt_b16_at(int k, int half) {
  return k * 16 + ((half ^ ((k >> 2) & 1)) * 8);
}

// B for its two n8 tiles at rows [k0, k0 + 16), k0 % 16 == 0.
__device__ __forceinline__ void qt_ldsm_b16(uint32_t (&b)[4], const __nv_bfloat16* slice,
                                            int k0) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* p = slice + qt_b16_at(k0 + (lane & 15), lane >> 4);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(qt_saddr(p)));
}

__device__ __forceinline__ void qt_mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// fp32 -> the nearest bf16 (ties to even), as torch's .to(bfloat16).
__device__ __forceinline__ __nv_bfloat16 qt_bf16(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ float qt_round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

}  // namespace

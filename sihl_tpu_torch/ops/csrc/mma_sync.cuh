// bf16 mma.sync, ldmatrix and cp.async helpers for sm_90a, shared by the
// tensor-core kernels of stem.cu (K4's bf16 body), stem_variants.cu (P3) and
// dynconv.cu (K5f's bf16 body).
// Each source that includes this builds into its own library.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes from global to shared memory; src_bytes = 0 writes zeros and reads
// nothing (src must still be a valid address).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a b for a 16 x 16 bf16 A fragment, a 16 x 8 bf16 B fragment, f32 d.
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b for a 16 x 8 bf16 A fragment, an 8 x 8 bf16 B fragment, f32 d.
__device__ __forceinline__ void mma_bf16_k8(float d[4], const uint32_t a[2], uint32_t b) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(b));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a tile whose rows are
// 8 chunks (128 bytes) long, the chunk at (chunk ^ (row & 7)).
__device__ __forceinline__ uint32_t swz(int row, int chunk) { return (uint32_t)(row * 8 + (chunk ^ (row & 7))) * 16u; }

// Two bf16 (4 bytes) at column col of row row of a swizzled 64-wide tile.
__device__ __forceinline__ void stage_pair(char* tile, int row, int col, uint32_t v) {
  *reinterpret_cast<uint32_t*>(tile + swz(row, col >> 3) + (col & 7) * 2) = v;
}

}  // namespace

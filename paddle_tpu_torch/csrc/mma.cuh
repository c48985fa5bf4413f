// Warp-level tensor-core building blocks shared by the mma.sync kernels
// (decode attention, ragged paged attention, quant matmul): cp.async
// staging, ldmatrix, and the m16n8k16 product with fp32 accumulate.
//
// Fragments of mma.sync m16n8k16 (lane l, r = l / 4, c = l % 4): the
// m16n8 accumulator holds rows r and r + 8 at columns 2c and 2c + 1 (d0,
// d1 row r; d2, d3 row r + 8); the A operand holds rows r and r + 8 at k
// 2c, 2c + 1 and 2c + 8, 2c + 9 (a0 row r, a1 row r + 8, a2 row r at
// k + 8, a3 row r + 8 at k + 8); the B operand holds column r at k 2c,
// 2c + 1 (b0) and 2c + 8, 2c + 9 (b1).
#pragma once

#include "hopper.cuh"

namespace ptt {

// 16 bytes global -> shared, bypassing L1; zeros when !ok
__device__ inline void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile(
      "cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(ok ? 16 : 0)
      : "memory");
}
__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ inline void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ inline void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a b for an m16n8k16 tile, fp32 accumulate: a as 4 T pairs, b as 2
template <typename T>
__device__ void mma16816(float* d, const uint32_t* a, const uint32_t* b);
template <>
__device__ inline void mma16816<__nv_bfloat16>(float* d, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
template <>
__device__ inline void mma16816<__half>(float* d, const uint32_t* a,
                                        const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// After every thread of the block has written its part of a partial
// result: true in the one block, of `count` sharing `*counter`, that
// arrives last (it then reads the others' partials and resets the counter
// for the next launch). Every thread of the block must call it.
__device__ inline bool arrive_last(int* counter, int count, int* flag) {
  __threadfence();  // this block's partial is visible before it arrives
  __syncthreads();
  if (threadIdx.x == 0) *flag = atomicAdd(counter, 1) == count - 1;
  __syncthreads();
  const bool last = *flag;
  if (last) __threadfence();
  return last;
}

}  // namespace ptt

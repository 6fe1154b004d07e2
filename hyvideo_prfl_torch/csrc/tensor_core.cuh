// Tensor-core and async-copy helpers shared by the int8 probes
// (int8_probe.cu: cp.async into shared memory, ldmatrix, mma.sync m16n8k16
// bf16 -> fp32 and m16n8k32 int8 -> int32) and the flash-attention kernels
// (the 128-byte swizzle and bf16 packing; ldmatrix for flash_fwd.cu's q'
// pass).
//
// Shared-memory tiles hold rows of 128 B (64 bf16 or 128 int8),
// XOR-swizzled in 16 B chunks so that ldmatrix's eight row addresses of one
// 8x8 matrix fall in distinct banks, as TMA's 128-byte swizzle lays them.
#pragma once

#include "common.cuh"

namespace hyv {

// byte offset of 16 B chunk `chunk` of row `row` in a tile of 128 B rows
__device__ __forceinline__ uint32_t swz128(int row, int chunk) {
  return (uint32_t)(row * 128 + ((chunk ^ (row & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;  // 0 source bytes -> the 16 B are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// c += a (16x16, row) * b (16x8, col); bf16 in, fp32 accumulate
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a (16x32, row) * b (32x8, col); int8 in, int32 accumulate. The byte
// layout of the a and b fragments is the m16n8k16 bf16 one (a 16-row x
// 32-byte slice, b 8 rows of 32 bytes), so the same ldmatrix addressing
// loads them, and c has the fp32 accumulator's register layout.
__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

}  // namespace hyv

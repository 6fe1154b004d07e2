// Tensor-core and async-copy helpers shared by the flash-attention kernels
// (flash_fwd.cu, flash_bwd.cu): cp.async into shared memory, ldmatrix, and
// mma.sync m16n8k16 bf16 -> fp32.
//
// Shared-memory tiles hold bf16 rows of 128 features (256 B) or 64 (128 B),
// XOR-swizzled in 16 B chunks so that ldmatrix's eight row addresses of one
// 8x8 matrix fall in distinct banks.
#pragma once

#include "common.cuh"

namespace hyv {

// byte offset of 16 B chunk `chunk` of row `row` in a tile of 256 B rows
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return (uint32_t)(row * 256 + ((chunk ^ (row & 7)) << 4));
}

// the same for a tile of 128 B rows (64 bf16)
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
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                          uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
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

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The A operand of one m16n8k16 product (16 rows x 16 reduction columns)
// from the fp32 accumulator fragments of two neighbouring n-tiles of 8
// columns: an accumulator becomes the next product's input without a trip
// through shared memory.
__device__ __forceinline__ void acc_to_a(const float* lo, const float* hi, uint32_t* a) {
  a[0] = pack_bf16x2(lo[0], lo[1]);
  a[1] = pack_bf16x2(lo[2], lo[3]);
  a[2] = pack_bf16x2(hi[0], hi[1]);
  a[3] = pack_bf16x2(hi[2], hi[3]);
}

}  // namespace hyv

// Shared-memory tile helpers of the flash-attention kernels: the 128-byte
// swizzle, bf16 packing, and ldmatrix for flash_fwd.cu's q' pass.
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

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

}  // namespace hyv

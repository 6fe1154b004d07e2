// The row layouts of the normalisation kernels K6-K9 (qknorm_rope*.cu,
// ln_scale_shift*.cu): which threads hold a feature row, and their row sums.
//
// A narrow row is one warp's: a block of 4 warps works on 4 rows at once
// and a row sum is a warp shuffle. A wide row is a whole block's (8 warps):
// each warp shuffles its part of the sum and the block adds the 8 partials
// through shared memory, in a fixed order, so every thread gets the same
// value. Thread t of a row's group holds the row's 16 B chunks
// t + kRowThreads * i; the chunk count is a runtime bound that each kernel
// keeps under a compile-time ceiling of chunks per thread.
#pragma once

#include "common.cuh"

namespace hyv {

constexpr int kWideWarps = 8;  // warps per wide row

template <int W>  // warps per row: 1 (narrow) or kWideWarps (wide)
struct RowLayout {
  static constexpr int kRowThreads = 32 * W;
  static constexpr int kRows = W == 1 ? 4 : 1;  // rows a block holds at once
  static constexpr int kThreads = kRowThreads * kRows;
  // two slots of W float2 partials; consecutive sums alternate slots, so a
  // sum's writes never meet the previous sum's reads (a barrier lies
  // between any two sums that share a slot)
  static constexpr int kRedFloats = W == 1 ? 1 : 4 * W;

  static __device__ __forceinline__ int thread_in_row() { return threadIdx.x % kRowThreads; }
  static __device__ __forceinline__ int row_in_block() { return threadIdx.x / kRowThreads; }

  // the sum of v over the row's threads, in every one of them; every
  // thread of a wide block must call it (it holds a __syncthreads)
  static __device__ __forceinline__ float row_sum(float v, float* red, int& par) {
    v = warp_sum(v);
    if constexpr (W == 1) {
      return v;
    } else {
      float* slot = red + par * 2 * W;
      par ^= 1;
      if ((threadIdx.x & 31) == 0) slot[threadIdx.x >> 5] = v;
      __syncthreads();
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < W; ++w) s += slot[w];
      return s;
    }
  }

  // two row sums at the cost of one barrier
  static __device__ __forceinline__ float2 row_sum2(float a, float b, float* red, int& par) {
    a = warp_sum(a);
    b = warp_sum(b);
    if constexpr (W == 1) {
      return make_float2(a, b);
    } else {
      float2* slot = reinterpret_cast<float2*>(red + par * 2 * W);
      par ^= 1;
      if ((threadIdx.x & 31) == 0) slot[threadIdx.x >> 5] = make_float2(a, b);
      __syncthreads();
      float2 s = make_float2(0.f, 0.f);
#pragma unroll
      for (int w = 0; w < W; ++w) {
        s.x += slot[w].x;
        s.y += slot[w].y;
      }
      return s;
    }
  }
};

}  // namespace hyv

// R: the standalone rolled rope, out = x * C + roll(x, D/2) * S, head_dim 128.
//
// Replaces hyvideo_prfl_tpu/ops/rope_pallas.py _rope_kernel (:32; pallas_call
// at :54, launched by _rope_call; the custom VJP at :69-88 runs the same
// kernel on the cotangent with S_bwd = roll(S, D/2)). The un-normed DiT
// self-attention rotates its token-major q and k with it, forward and
// backward.
//
//   x [B, L, N, 128] bf16 or fp32; C = [cos | cos], S = [-sin | sin], [L, 128]
//   fp32; out[d] = x[d] C[d] + x[(d + 64) % 128] S[d], in fp32, written in
//   x's type.
//
// The products and the sum round separately (no fused multiply-add), as
// the unfused PyTorch reference and the TPU kernel round them, so the
// kernel equals its plain version bit for bit.
//
// Bound on the H100: bytes. Per element it reads x and writes out (2 + 2
// bytes in bf16) against 3 flops; the tables ([L, 128] fp32 each) are read
// once per (batch, token) row group of N heads, from L2.
//
// Design: one thread per pair of 16 B chunks that rotate into each other
// (features [8c, 8c + 8) and [8c + 64, 8c + 72) in bf16; 4 per chunk in
// fp32), so every byte of x is read once and the roll costs no shuffle and
// no shared memory: the thread already holds both halves. Neighbouring
// threads take neighbouring chunks of a row, then the next row: 16 B loads
// and stores on consecutive addresses. The table chunks come through the
// read-only cache; the N head rows of one token reuse them.
#include "common.cuh"

namespace {

constexpr int kD = 128;
constexpr int kThreads = 256;

template <typename T>
struct Chunk;  // 16 B of x as fp32

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* f) {
    hyv::unpack8(*reinterpret_cast<const uint4*>(p), f);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* f) {
    *reinterpret_cast<uint4*>(p) = hyv::pack8(f);
  }
};

template <>
struct Chunk<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void load(const float* p, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
rope_kernel(const T* __restrict__ x, const float* __restrict__ c, const float* __restrict__ s,
            T* __restrict__ out, long long rows, int L, int N) {
  constexpr int E = Chunk<T>::kN;
  constexpr int kPairs = kD / 2 / E;  // chunk pairs per row
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= rows * kPairs) return;
  const long long row = i / kPairs;
  const int d0 = (int)(i - row * kPairs) * E, d1 = d0 + kD / 2;
  const long long l = (row / N) % L;
  float a[E], b[E], ca[E], cb[E], sa[E], sb[E];
  Chunk<T>::load(x + row * kD + d0, a);
  Chunk<T>::load(x + row * kD + d1, b);
  const float4* cr = reinterpret_cast<const float4*>(c + l * kD);
  const float4* sr = reinterpret_cast<const float4*>(s + l * kD);
#pragma unroll
  for (int j = 0; j < E / 4; ++j) {
    const float4 c0 = __ldg(cr + d0 / 4 + j), c1 = __ldg(cr + d1 / 4 + j);
    const float4 s0 = __ldg(sr + d0 / 4 + j), s1 = __ldg(sr + d1 / 4 + j);
    ca[4 * j] = c0.x; ca[4 * j + 1] = c0.y; ca[4 * j + 2] = c0.z; ca[4 * j + 3] = c0.w;
    cb[4 * j] = c1.x; cb[4 * j + 1] = c1.y; cb[4 * j + 2] = c1.z; cb[4 * j + 3] = c1.w;
    sa[4 * j] = s0.x; sa[4 * j + 1] = s0.y; sa[4 * j + 2] = s0.z; sa[4 * j + 3] = s0.w;
    sb[4 * j] = s1.x; sb[4 * j + 1] = s1.y; sb[4 * j + 2] = s1.z; sb[4 * j + 3] = s1.w;
  }
  float ya[E], yb[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    // the first half's partner is x[d + 64], the second half's x[d - 64]
    ya[e] = __fadd_rn(__fmul_rn(a[e], ca[e]), __fmul_rn(b[e], sa[e]));
    yb[e] = __fadd_rn(__fmul_rn(b[e], cb[e]), __fmul_rn(a[e], sb[e]));
  }
  Chunk<T>::store(out + row * kD + d0, ya);
  Chunk<T>::store(out + row * kD + d1, yb);
}

template <typename T>
cudaError_t launch(const void* x, const void* c, const void* s, void* out, long long rows,
                   int L, int N, cudaStream_t st) {
  const long long threads = rows * (kD / 2 / Chunk<T>::kN);
  const dim3 grid((unsigned)((threads + kThreads - 1) / kThreads));
  rope_kernel<T><<<grid, kThreads, 0, st>>>((const T*)x, (const float*)c, (const float*)s,
                                            (T*)out, rows, L, N);
  return cudaGetLastError();
}

}  // namespace

// x, out [B, L, N, 128] contiguous, bf16 (is_bf16) or fp32, rows = B * L * N;
// c, s [L, 128] fp32 contiguous. All 16 B aligned.
extern "C" int hyv_rope(const void* x, const void* c, const void* s, void* out,
                        long long rows, int L, int N, int is_bf16, void* stream) {
  if (L <= 0 || N <= 0 || rows % ((long long)L * N) != 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(is_bf16 ? launch<__nv_bfloat16>(x, c, s, out, rows, L, N, st)
                       : launch<float>(x, c, s, out, rows, L, N, st));
}

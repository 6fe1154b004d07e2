// K7: backward of the fused qk-RMSNorm (+ rolled-half RoPE).
//
// Replaces hyvideo_prfl_tpu/ops/qknorm_rope.py _bwd_kernel (:106;
// pallas_call at :178, launched by _bwd_call :173), both modes. Per token
// row of M = N * 128 features, with g the cotangent of the head-major
// output [B, N, L, 128] (the layout the flash backward returns for q and k):
//
//   du = g * C + roll(g, 64) * roll(S, 64)        (du = g without rope)
//   r  = rsqrt(mean(x^2) + eps)
//   dx = r * du * w - x * r^3 * mean(du * w * x)   -> bf16 [B, L, M]
//   dw = sum_rows du * bf16(x * r)                  (the forward's rounding)
//
// Bound on the H100: bytes. It reads x and g (2 B each per element) and
// writes dx (2 B), plus the [L, 128] fp32 tables, which rows of the batch
// share through L2; the dw partials add 4 B x M per 32-row tile.
//
// Design: the K6 row layout, one warp per token row, a lane holding the
// 16 B chunks lane + 32 i of x (8 features each), so x is read once and the
// two row sums are warp shuffles. A lane's chunks all sit at chunk lane % 16
// of their heads, so the rope partner 64 features away is on lane ^ 8: one
// shuffle of g. g is gathered from the head-major layout in 256 B runs per
// head. A block of 4 warps owns 32 rows; the dw sums accumulate per warp
// in shared memory (a lane owns its columns), and the block writes one [M]
// partial per tile, which the caller sums in a fixed order (no atomics, so
// dw is deterministic). Rows past L are masked out of the partials.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 8;
constexpr int kTileRows = kWarps * kRowsPerWarp;

__device__ __forceinline__ void load8f(const float* p, float* f) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

template <int C, bool kRope>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_rope_bwd_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
                        const float* __restrict__ ctab, const float* __restrict__ stab,
                        const __nv_bfloat16* __restrict__ g, __nv_bfloat16* __restrict__ dx,
                        float* __restrict__ dw_part, int L, int N, float eps) {
  constexpr int M = C * 256;  // C chunks of 8 per lane, 32 lanes
  extern __shared__ float4 red[];  // [kWarps][M / 4]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile = blockIdx.x, b = blockIdx.y, n_tiles = gridDim.x;
  float4* my_dw = red + warp * (M / 4);
#pragma unroll
  for (int i = 0; i < C; ++i) {
    my_dw[2 * (lane + 32 * i)] = make_float4(0.f, 0.f, 0.f, 0.f);
    my_dw[2 * (lane + 32 * i) + 1] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int d0 = (lane & 15) * 8;  // feature offset inside the head

  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int l = tile * kTileRows + warp * kRowsPerWarp + r;
    if (l >= L) break;  // warp-uniform: the ragged last tile
    const long long row = (long long)b * L + l;
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * M);
    uint4 raw[C];
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      raw[i] = __ldcs(xr + lane + 32 * i);
      float f[8];
      hyv::unpack8(raw[i], f);
#pragma unroll
      for (int e = 0; e < 8; ++e) ss += f[e] * f[e];
    }
    const float rr = 1.0f / sqrtf(hyv::warp_sum(ss) * (1.0f / M) + eps);

    float cs[8], sp[8];
    if constexpr (kRope) {
      load8f(ctab + (long long)l * 128 + d0, cs);
      load8f(stab + (long long)l * 128 + (d0 ^ 64), sp);  // roll(S, 64) at d0
    }
    float du[C][8];
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int chunk = lane + 32 * i;
      const int h = chunk >> 4;
      const uint4 graw =
          __ldcs(reinterpret_cast<const uint4*>(g + (((long long)b * N + h) * L + l) * 128 + d0));
      float gv[8], xf[8], wv[8];
      hyv::unpack8(graw, gv);
      if constexpr (kRope) {
        uint4 other;  // roll(g, 64): the same head's chunk 8 away, on lane ^ 8
        other.x = __shfl_xor_sync(0xffffffffu, graw.x, 8);
        other.y = __shfl_xor_sync(0xffffffffu, graw.y, 8);
        other.z = __shfl_xor_sync(0xffffffffu, graw.z, 8);
        other.w = __shfl_xor_sync(0xffffffffu, graw.w, 8);
        float pv[8];
        hyv::unpack8(other, pv);
#pragma unroll
        for (int e = 0; e < 8; ++e) du[i][e] = gv[e] * cs[e] + pv[e] * sp[e];
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) du[i][e] = gv[e];
      }
      hyv::unpack8(raw[i], xf);
      load8f(w + chunk * 8, wv);
      float4& lo = my_dw[2 * chunk];
      float4& hi = my_dw[2 * chunk + 1];
      float t[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        dot += du[i][e] * wv[e] * xf[e];
        t[e] = du[i][e] * hyv::bf16_round(__fmul_rn(xf[e], rr));
      }
      lo.x += t[0]; lo.y += t[1]; lo.z += t[2]; lo.w += t[3];
      hi.x += t[4]; hi.y += t[5]; hi.z += t[6]; hi.w += t[7];
    }
    const float r3dot = (rr * rr * rr) * (hyv::warp_sum(dot) * (1.0f / M));
    uint4* dxr = reinterpret_cast<uint4*>(dx + row * M);
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int chunk = lane + 32 * i;
      float xf[8], wv[8], o[8];
      hyv::unpack8(raw[i], xf);
      load8f(w + chunk * 8, wv);
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = rr * (du[i][e] * wv[e]) - xf[e] * r3dot;
      dxr[chunk] = hyv::pack8(o);
    }
  }

  __syncthreads();
  const float* redf = reinterpret_cast<const float*>(red);
  float* out = dw_part + ((long long)b * n_tiles + tile) * M;
  for (int c = threadIdx.x; c < M; c += kWarps * 32) {
    float a = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) a += redf[wi * M + c];
    out[c] = a;
  }
}

template <int C, bool kRope>
cudaError_t launch_r(const void* x, const void* w, const void* c, const void* s, const void* g,
                     void* dx, void* dw, int B, int L, int N, float eps, cudaStream_t st) {
  const dim3 grid((L + kTileRows - 1) / kTileRows, B);
  const int smem = kWarps * C * 256 * (int)sizeof(float);
  auto kernel = rmsnorm_rope_bwd_kernel<C, kRope>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kWarps * 32, smem, st>>>(
      (const __nv_bfloat16*)x, (const float*)w, (const float*)c, (const float*)s,
      (const __nv_bfloat16*)g, (__nv_bfloat16*)dx, (float*)dw, L, N, eps);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch(const void* x, const void* w, const void* c, const void* s, const void* g,
                   void* dx, void* dw, int B, int L, int N, float eps, int rope,
                   cudaStream_t st) {
  return rope ? launch_r<C, true>(x, w, c, s, g, dx, dw, B, L, N, eps, st)
              : launch_r<C, false>(x, w, c, s, g, dx, dw, B, L, N, eps, st);
}

}  // namespace

// x [B, L, N*128] bf16; w [N*128] fp32; c, s [L, 128] fp32 (ignored unless
// rope); g [B, N, L, 128] bf16; dx [B, L, N*128] bf16; dw [B, ceil(L / 32),
// N*128] fp32 per-tile partials. N up to 16 (a lane keeps 8 N floats of du).
extern "C" int hyv_rmsnorm_rope_bwd(const void* x, const void* w, const void* c, const void* s,
                                    const void* g, void* dx, void* dw, int B, int L, int N,
                                    int D, float eps, int rope, void* stream) {
  if (D != 128) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if ((long long)B * L == 0) return 0;
  switch (N) {  // chunks per lane = N * 128 / 256
    case 2: return launch<1>(x, w, c, s, g, dx, dw, B, L, N, eps, rope, st);
    case 4: return launch<2>(x, w, c, s, g, dx, dw, B, L, N, eps, rope, st);
    case 8: return launch<4>(x, w, c, s, g, dx, dw, B, L, N, eps, rope, st);
    case 12: return launch<6>(x, w, c, s, g, dx, dw, B, L, N, eps, rope, st);
    case 16: return launch<8>(x, w, c, s, g, dx, dw, B, L, N, eps, rope, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

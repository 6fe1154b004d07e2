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
// Design: K6's row layouts (row_norm.cuh) over 16 B chunks: narrow rows
// (N <= 16) one warp each, wide rows (16 < N <= 64, the 14B width N = 40
// among them) a block of 8 warps each. A thread holds chunks
// t + kRowThreads i of x (8 features each), so x is read once and the two
// row sums are row_norm.cuh sums. A thread's chunks all sit at chunk t % 16
// of their heads, so the rope partner 64 features away is on lane ^ 8: one
// shuffle of g. g is gathered from the head-major layout in 256 B runs per
// head. A block owns a tile of 32 rows (narrow: 4 warps of 8 rows; wide:
// the 8 warps on one row after another). The dw sums accumulate in shared
// memory, one [M] slot per row group (a thread owns its columns): 4 x 8 KB
// narrow at N 16, 1 x 20 KB wide at N 40. The block writes one [M] partial
// per tile, which the caller sums in a fixed order (no atomics, so dw is
// deterministic). Rows past L are masked out of the partials. The chunk
// count is a runtime bound under a ceiling of 2, 4, 6 or 8 chunks a lane
// (narrow) or 4 a thread (wide), fixed at compile time where the row fills
// a narrow ceiling, as in K8: at N 40 a lane of the narrow layout would
// hold 160 floats of du plus 80 of x.
#include "row_norm.cuh"

namespace {

constexpr int kTileRows = 32;

// 8 floats from p, or zeros where !ok (a predicated load, not a branch)
__device__ __forceinline__ void load8f(const float* p, float* f, bool ok = true) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 a = ok ? __ldg(reinterpret_cast<const float4*>(p)) : zero;
  const float4 b = ok ? __ldg(reinterpret_cast<const float4*>(p) + 1) : zero;
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

template <int W, int kCmax, bool kExact, bool kRope>
__global__ void __launch_bounds__(hyv::RowLayout<W>::kThreads)
rmsnorm_rope_bwd_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
                        const float* __restrict__ ctab, const float* __restrict__ stab,
                        const __nv_bfloat16* __restrict__ g, __nv_bfloat16* __restrict__ dx,
                        float* __restrict__ dw_part, int L, int n_arg, float eps) {
  using Layout = hyv::RowLayout<W>;
  const int N = kExact ? kCmax * Layout::kRowThreads / 16 : n_arg;
  constexpr int kGroupRows = kTileRows / Layout::kRows;  // rows per row group
  extern __shared__ float4 part[];  // [kRows][M / 4]
  __shared__ __align__(16) float red[Layout::kRedFloats];
  const int M = N * 128, n_chunks = N * 16;
  const int tg = Layout::thread_in_row(), grp = Layout::row_in_block();
  const int tile = blockIdx.x, b = blockIdx.y, n_tiles = gridDim.x;
  float4* my_dw = part + grp * (M / 4);
#pragma unroll
  for (int i = 0; i < kCmax; ++i) {
    const int chunk = tg + Layout::kRowThreads * i;
    if (kExact || chunk < n_chunks) {
      my_dw[2 * chunk] = make_float4(0.f, 0.f, 0.f, 0.f);
      my_dw[2 * chunk + 1] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  const int d0 = (tg & 15) * 8;  // feature offset inside the head
  int par = 0;

  for (int r = 0; r < kGroupRows; ++r) {
    const int l = tile * kTileRows + grp * kGroupRows + r;
    if (l >= L) break;  // uniform over the row's threads: the ragged last tile
    const long long row = (long long)b * L + l;
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * M);
    uint4 raw[kCmax];
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < kCmax; ++i) {
      const int chunk = tg + Layout::kRowThreads * i;
      raw[i] = kExact || chunk < n_chunks ? __ldcs(xr + chunk) : make_uint4(0u, 0u, 0u, 0u);
      float f[8];
      hyv::unpack8(raw[i], f);
#pragma unroll
      for (int e = 0; e < 8; ++e) ss += f[e] * f[e];
    }
    const float rr = 1.0f / sqrtf(Layout::row_sum(ss, red, par) * (1.0f / M) + eps);

    float cs[8], sp[8];
    if constexpr (kRope) {
      load8f(ctab + (long long)l * 128 + d0, cs);
      load8f(stab + (long long)l * 128 + (d0 ^ 64), sp);  // roll(S, 64) at d0
    }
    float du[kCmax][8];
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < kCmax; ++i) {
#pragma unroll
      for (int e = 0; e < 8; ++e) du[i][e] = 0.f;
      const int chunk = tg + Layout::kRowThreads * i;
      const bool mine = kExact || chunk < n_chunks;
      const int h = chunk >> 4;
      const uint4 graw =
          mine ? __ldcs(reinterpret_cast<const uint4*>(
                     g + (((long long)b * N + h) * L + l) * 128 + d0))
               : make_uint4(0u, 0u, 0u, 0u);
      float gv[8];
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
      // a lane without a chunk holds du = x = w = 0: it adds nothing
      float xf[8], wv[8];
      hyv::unpack8(raw[i], xf);
      load8f(w + chunk * 8, wv, mine);
      float t[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        dot += du[i][e] * wv[e] * xf[e];
        t[e] = du[i][e] * hyv::bf16_round(__fmul_rn(xf[e], rr));
      }
      if (mine) {
        float4& lo = my_dw[2 * chunk];
        float4& hi = my_dw[2 * chunk + 1];
        lo.x += t[0]; lo.y += t[1]; lo.z += t[2]; lo.w += t[3];
        hi.x += t[4]; hi.y += t[5]; hi.z += t[6]; hi.w += t[7];
      }
    }
    const float r3dot = (rr * rr * rr) * (Layout::row_sum(dot, red, par) * (1.0f / M));
    uint4* dxr = reinterpret_cast<uint4*>(dx + row * M);
#pragma unroll
    for (int i = 0; i < kCmax; ++i) {
      const int chunk = tg + Layout::kRowThreads * i;
      const bool mine = kExact || chunk < n_chunks;
      float xf[8], wv[8], o[8];
      hyv::unpack8(raw[i], xf);
      load8f(w + chunk * 8, wv, mine);
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = rr * (du[i][e] * wv[e]) - xf[e] * r3dot;
      if (mine) __stwb(dxr + chunk, hyv::pack8(o));  // one 16 B store (see K6)
    }
  }

  __syncthreads();
  const float* partf = reinterpret_cast<const float*>(part);
  float* out = dw_part + ((long long)b * n_tiles + tile) * M;
  for (int c = threadIdx.x; c < M; c += Layout::kThreads) {
    float a = 0.f;
#pragma unroll
    for (int wi = 0; wi < Layout::kRows; ++wi) a += partf[wi * M + c];
    out[c] = a;
  }
}

template <int W, int kCmax, bool kExact, bool kRope>
cudaError_t launch_r(const void* x, const void* w, const void* c, const void* s, const void* g,
                     void* dx, void* dw, int B, int L, int N, float eps, cudaStream_t st) {
  using Layout = hyv::RowLayout<W>;
  const dim3 grid((L + kTileRows - 1) / kTileRows, B);
  const int smem = Layout::kRows * N * 128 * (int)sizeof(float);
  auto kernel = rmsnorm_rope_bwd_kernel<W, kCmax, kExact, kRope>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, Layout::kThreads, smem, st>>>(
      (const __nv_bfloat16*)x, (const float*)w, (const float*)c, (const float*)s,
      (const __nv_bfloat16*)g, (__nv_bfloat16*)dx, (float*)dw, L, N, eps);
  return cudaGetLastError();
}

template <int W, int kCmax, bool kExact>
cudaError_t launch(const void* x, const void* w, const void* c, const void* s, const void* g,
                   void* dx, void* dw, int B, int L, int N, float eps, int rope,
                   cudaStream_t st) {
  return rope ? launch_r<W, kCmax, kExact, true>(x, w, c, s, g, dx, dw, B, L, N, eps, st)
              : launch_r<W, kCmax, kExact, false>(x, w, c, s, g, dx, dw, B, L, N, eps, st);
}

// a narrow tier: the row fills it exactly (compile-time chunk count, no
// guards) or not
template <int kCmax>
cudaError_t launch_tier(const void* x, const void* w, const void* c, const void* s,
                        const void* g, void* dx, void* dw, int B, int L, int N, float eps,
                        int rope, cudaStream_t st) {
  return N == 2 * kCmax
             ? launch<1, kCmax, true>(x, w, c, s, g, dx, dw, B, L, N, eps, rope, st)
             : launch<1, kCmax, false>(x, w, c, s, g, dx, dw, B, L, N, eps, rope, st);
}

}  // namespace

// x [B, L, N*128] bf16; w [N*128] fp32; c, s [L, 128] fp32 (ignored unless
// rope); g [B, N, L, 128] bf16; dx [B, L, N*128] bf16; dw [B, ceil(L / 32),
// N*128] fp32 per-tile partials. N from 1 to 64.
extern "C" int hyv_rmsnorm_rope_bwd(const void* x, const void* w, const void* c, const void* s,
                                    const void* g, void* dx, void* dw, int B, int L, int N,
                                    int D, float eps, int rope, void* stream) {
  if (D != 128 || N < 1 || N > 64) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if ((long long)B * L == 0) return 0;
  const int cl = (N + 1) / 2;  // chunks per lane of one warp
  if (cl <= 2) return launch_tier<2>(x, w, c, s, g, dx, dw, B, L, N, eps, rope, st);
  if (cl <= 4) return launch_tier<4>(x, w, c, s, g, dx, dw, B, L, N, eps, rope, st);
  if (cl <= 6) return launch_tier<6>(x, w, c, s, g, dx, dw, B, L, N, eps, rope, st);
  if (cl <= 8) return launch_tier<8>(x, w, c, s, g, dx, dw, B, L, N, eps, rope, st);
  return launch<hyv::kWideWarps, 4, false>(x, w, c, s, g, dx, dw, B, L, N, eps, rope, st);
}

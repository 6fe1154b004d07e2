// K9: backward of the fused LayerNorm + scale/shift, out = LN(x) * s[b] + t[b].
//
// Replaces hyvideo_prfl_tpu/ops/stream.py _bwd_kernel (:84; pallas_call at
// :151, launched by _bwd_call :146). Per row, recomputing the statistics
// from x (the residuals are the layer inputs only):
//
//   yn = (x - mean) * rstd,  dyn = g * s
//   dx = rstd * (dyn - mean_D(dyn) - yn * mean_D(dyn * yn))      fp32
//   ds = sum_rows g * yn,   dt = sum_rows g
//
// g is bf16 at the three block sites and fp32 at the head.
//
// Bound on the H100: bytes. Per element it reads x (4 B) and g (2 or 4 B)
// and writes dx (4 B), with ~15 flops: the floor is that traffic at
// 3.35 TB/s. The ds/dt partials add 2 x 4 B x D per 32-row tile, 1/64 of
// the x traffic.
//
// Design: K8's row layouts (row_norm.cuh). A block owns a tile of 32 rows:
// narrow rows (D <= 2048) one warp each, 8 rows per warp, 4 warps; wide rows
// (2048 < D <= 8192) the whole block of 8 warps, one row after another.
// Each thread keeps its float4 chunks of x and dyn in registers, so x and g
// are read once, and the three row sums are warp shuffles (narrow) or
// shuffles plus one shared-memory exchange per sum (wide; the last two
// share it). The cross-row sums ds/dt accumulate in shared memory, one
// [2][D] slot per row group (each thread owns its own columns, so no
// atomics), then the block sums its groups and writes one [D] partial of
// each per tile. The caller sums the [B, n_tiles, D] partials: a second
// pass in a fixed order, as the TPU kernel's per-tile partials, so ds and
// dt are deterministic. Rows past L are masked out of the partials. The
// chunk count is a runtime bound under a ceiling of 4, 8, 12 or 16 float4
// a thread (narrow) or 8 (wide), fixed at compile time where the width
// fills a narrow ceiling, as in K8: at D 5120 a lane of the narrow layout
// would hold 320 floats, a thread of the wide one holds 40.
#include "row_norm.cuh"

namespace {

constexpr int kTileRows = 32;

__device__ __forceinline__ float4 load4(const float* p) { return __ldcs(reinterpret_cast<const float4*>(p)); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldcs(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

template <int W, int kVmax, bool kExact, typename GT>
__global__ void __launch_bounds__(hyv::RowLayout<W>::kThreads)
ln_scale_shift_bwd_kernel(const float* __restrict__ x, const float* __restrict__ s,
                          const GT* __restrict__ g, float* __restrict__ dx,
                          float* __restrict__ ds_part, float* __restrict__ dt_part,
                          int L, int d_arg, float eps) {
  using Layout = hyv::RowLayout<W>;
  const int D = kExact ? kVmax * 4 * Layout::kRowThreads : d_arg;
  constexpr int kGroupRows = kTileRows / Layout::kRows;  // rows per row group
  extern __shared__ float4 part[];  // [kRows][2][D / 4]
  __shared__ __align__(16) float red[Layout::kRedFloats];
  const int tg = Layout::thread_in_row(), grp = Layout::row_in_block();
  const int tile = blockIdx.x, b = blockIdx.y, n_tiles = gridDim.x;
  const int n4 = D / 4;
  float4* my_ds = part + grp * 2 * n4;
  float4* my_dt = my_ds + n4;
#pragma unroll
  for (int i = 0; i < kVmax; ++i) {
    const int c = tg + Layout::kRowThreads * i;
    if (kExact || c < n4) {
      my_ds[c] = make_float4(0.f, 0.f, 0.f, 0.f);
      my_dt[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  const float4* sr = reinterpret_cast<const float4*>(s + (long long)b * D);
  int par = 0;

  for (int r = 0; r < kGroupRows; ++r) {
    const int l = tile * kTileRows + grp * kGroupRows + r;
    if (l >= L) break;  // uniform over the row's threads: the ragged last tile
    const long long row = (long long)b * L + l;
    const float* xr = x + row * D;
    float4 v[kVmax];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kVmax; ++i) {
      const int c = tg + Layout::kRowThreads * i;
      v[i] = kExact || c < n4 ? load4(xr + 4 * c) : make_float4(0.f, 0.f, 0.f, 0.f);
      sum += (v[i].x + v[i].y) + (v[i].z + v[i].w);
    }
    const float mean = Layout::row_sum(sum, red, par) * (1.0f / D);
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < kVmax; ++i) {
      if (kExact || tg + Layout::kRowThreads * i < n4) {
        v[i].x -= mean; v[i].y -= mean; v[i].z -= mean; v[i].w -= mean;
        sq += (v[i].x * v[i].x + v[i].y * v[i].y) + (v[i].z * v[i].z + v[i].w * v[i].w);
      }
    }
    const float rstd = 1.0f / sqrtf(Layout::row_sum(sq, red, par) * (1.0f / D) + eps);

    // dy holds g, then dyn = g * s; v becomes yn; the partials take g * yn
    // and g. Every load of g is issued before the first shared-memory
    // update, in branch-free code (a load behind a per-chunk branch would
    // wait for the chunk before it)
    float4 dy[kVmax];
    float m1 = 0.f, m2 = 0.f;
    const GT* gr = g + row * D;
#pragma unroll
    for (int i = 0; i < kVmax; ++i) {
      const int c = tg + Layout::kRowThreads * i;
      dy[i] = kExact || c < n4 ? load4(gr + 4 * c) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < kVmax; ++i) {
      const int c = tg + Layout::kRowThreads * i;
      const float4 gv = dy[i];
      const bool mine = kExact || c < n4;
      const float4 sv = mine ? __ldg(sr + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      v[i].x *= rstd; v[i].y *= rstd; v[i].z *= rstd; v[i].w *= rstd;
      if (mine) {
        float4 a = my_ds[c], t = my_dt[c];
        a.x += gv.x * v[i].x; a.y += gv.y * v[i].y; a.z += gv.z * v[i].z; a.w += gv.w * v[i].w;
        t.x += gv.x; t.y += gv.y; t.z += gv.z; t.w += gv.w;
        my_ds[c] = a;
        my_dt[c] = t;
      }
      dy[i] = make_float4(gv.x * sv.x, gv.y * sv.y, gv.z * sv.z, gv.w * sv.w);
      m1 += (dy[i].x + dy[i].y) + (dy[i].z + dy[i].w);
      m2 += (dy[i].x * v[i].x + dy[i].y * v[i].y) + (dy[i].z * v[i].z + dy[i].w * v[i].w);
    }
    const float2 m = Layout::row_sum2(m1, m2, red, par);
    m1 = m.x * (1.0f / D);
    m2 = m.y * (1.0f / D);
    float4* dxr = reinterpret_cast<float4*>(dx + row * D);
#pragma unroll
    for (int i = 0; i < kVmax; ++i) {
      const int c = tg + Layout::kRowThreads * i;
      float4 o;
      o.x = rstd * ((dy[i].x - m1) - v[i].x * m2);
      o.y = rstd * ((dy[i].y - m1) - v[i].y * m2);
      o.z = rstd * ((dy[i].z - m1) - v[i].z * m2);
      o.w = rstd * ((dy[i].w - m1) - v[i].w * m2);
      if (kExact || c < n4) __stcs(dxr + c, o);
    }
  }

  __syncthreads();
  const float* partf = reinterpret_cast<const float*>(part);
  const long long out0 = ((long long)b * n_tiles + tile) * D;
  for (int c = threadIdx.x; c < D; c += Layout::kThreads) {
    float a = 0.f, t = 0.f;
#pragma unroll
    for (int w = 0; w < Layout::kRows; ++w) {
      a += partf[w * 2 * D + c];
      t += partf[w * 2 * D + D + c];
    }
    ds_part[out0 + c] = a;
    dt_part[out0 + c] = t;
  }
}

template <int W, int kVmax, bool kExact, typename GT>
cudaError_t launch_g(const void* x, const void* s, const void* g, void* dx, void* ds, void* dt,
                     int B, int L, int D, float eps, cudaStream_t st) {
  using Layout = hyv::RowLayout<W>;
  const dim3 grid((L + kTileRows - 1) / kTileRows, B);
  const int smem = Layout::kRows * 2 * D * (int)sizeof(float);
  auto kernel = ln_scale_shift_bwd_kernel<W, kVmax, kExact, GT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, Layout::kThreads, smem, st>>>((const float*)x, (const float*)s, (const GT*)g,
                                               (float*)dx, (float*)ds, (float*)dt, L, D, eps);
  return cudaGetLastError();
}

template <int W, int kVmax, bool kExact>
cudaError_t launch(const void* x, const void* s, const void* g, void* dx, void* ds, void* dt,
                   int B, int L, int D, float eps, int g_bf16, cudaStream_t st) {
  return g_bf16 ? launch_g<W, kVmax, kExact, __nv_bfloat16>(x, s, g, dx, ds, dt, B, L, D, eps, st)
                : launch_g<W, kVmax, kExact, float>(x, s, g, dx, ds, dt, B, L, D, eps, st);
}

// a narrow tier: the row fills it exactly (compile-time chunk count, no
// guards) or not
template <int kVmax>
cudaError_t launch_tier(const void* x, const void* s, const void* g, void* dx, void* ds,
                        void* dt, int B, int L, int D, float eps, int g_bf16, cudaStream_t st) {
  return D == kVmax * 128
             ? launch<1, kVmax, true>(x, s, g, dx, ds, dt, B, L, D, eps, g_bf16, st)
             : launch<1, kVmax, false>(x, s, g, dx, ds, dt, B, L, D, eps, g_bf16, st);
}

}  // namespace

// x [B, L, D] fp32; s [B, D] fp32; g [B, L, D] bf16 (g_bf16) or fp32;
// dx [B, L, D] fp32; ds, dt [B, ceil(L / 32), D] fp32 per-tile partials.
// D a multiple of 128 up to 8192.
extern "C" int hyv_ln_scale_shift_bwd(const void* x, const void* s, const void* g, void* dx,
                                      void* ds, void* dt, int B, int L, int D, float eps,
                                      int g_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D <= 0 || D % 128 != 0 || D > 8192) return (int)cudaErrorInvalidValue;
  if ((long long)B * L == 0) return 0;
  const int c = D / 128;  // float4 chunks per lane of one warp
  if (c <= 4) return launch_tier<4>(x, s, g, dx, ds, dt, B, L, D, eps, g_bf16, st);
  if (c <= 8) return launch_tier<8>(x, s, g, dx, ds, dt, B, L, D, eps, g_bf16, st);
  if (c <= 12) return launch_tier<12>(x, s, g, dx, ds, dt, B, L, D, eps, g_bf16, st);
  if (c <= 16) return launch_tier<16>(x, s, g, dx, ds, dt, B, L, D, eps, g_bf16, st);
  return launch<hyv::kWideWarps, 8, false>(x, s, g, dx, ds, dt, B, L, D, eps, g_bf16, st);
}

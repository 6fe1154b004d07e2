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
// Design: the K8 row layout, one warp per row, each lane holding its D/128
// float4 chunks of x and dyn in registers, so x and g are read once and the
// three row sums are warp shuffles. A block of 4 warps owns a tile of 32
// rows (8 per warp). The cross-row sums ds/dt accumulate per warp in
// shared memory (each lane owns its own columns, so no atomics), then the
// block sums its 4 warps and writes one [D] partial of each per tile. The
// caller sums the [B, n_tiles, D] partials: a second pass in a fixed order,
// as the TPU kernel's per-tile partials, so ds and dt are deterministic.
// Rows past L are masked out of the partials.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 8;
constexpr int kTileRows = kWarps * kRowsPerWarp;

__device__ __forceinline__ float4 load4(const float* p) { return __ldcs(reinterpret_cast<const float4*>(p)); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldcs(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

template <int V, typename GT>
__global__ void __launch_bounds__(kWarps * 32)
ln_scale_shift_bwd_kernel(const float* __restrict__ x, const float* __restrict__ s,
                          const GT* __restrict__ g, float* __restrict__ dx,
                          float* __restrict__ ds_part, float* __restrict__ dt_part,
                          int L, float eps) {
  constexpr int D = V * 128;
  extern __shared__ float4 red[];  // [kWarps][2][D / 4]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile = blockIdx.x, b = blockIdx.y, n_tiles = gridDim.x;
  float4* my_ds = red + warp * 2 * (D / 4);
  float4* my_dt = my_ds + D / 4;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    my_ds[lane + 32 * i] = make_float4(0.f, 0.f, 0.f, 0.f);
    my_dt[lane + 32 * i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float4* sr = reinterpret_cast<const float4*>(s + (long long)b * D);

  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int l = tile * kTileRows + warp * kRowsPerWarp + r;
    if (l >= L) break;  // warp-uniform: the ragged last tile
    const long long row = (long long)b * L + l;
    const float* xr = x + row * D;
    float4 v[V];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      v[i] = load4(xr + 4 * (lane + 32 * i));
      sum += (v[i].x + v[i].y) + (v[i].z + v[i].w);
    }
    const float mean = hyv::warp_sum(sum) * (1.0f / D);
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      v[i].x -= mean; v[i].y -= mean; v[i].z -= mean; v[i].w -= mean;
      sq += (v[i].x * v[i].x + v[i].y * v[i].y) + (v[i].z * v[i].z + v[i].w * v[i].w);
    }
    const float rstd = 1.0f / sqrtf(hyv::warp_sum(sq) * (1.0f / D) + eps);

    // v becomes yn; dy holds dyn = g * s; the partials take g * yn and g
    float4 dy[V];
    float m1 = 0.f, m2 = 0.f;
    const GT* gr = g + row * D;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = lane + 32 * i;
      const float4 gv = load4(gr + 4 * c);
      const float4 sv = __ldg(sr + c);
      v[i].x *= rstd; v[i].y *= rstd; v[i].z *= rstd; v[i].w *= rstd;
      float4 a = my_ds[c], t = my_dt[c];
      a.x += gv.x * v[i].x; a.y += gv.y * v[i].y; a.z += gv.z * v[i].z; a.w += gv.w * v[i].w;
      t.x += gv.x; t.y += gv.y; t.z += gv.z; t.w += gv.w;
      my_ds[c] = a;
      my_dt[c] = t;
      dy[i] = make_float4(gv.x * sv.x, gv.y * sv.y, gv.z * sv.z, gv.w * sv.w);
      m1 += (dy[i].x + dy[i].y) + (dy[i].z + dy[i].w);
      m2 += (dy[i].x * v[i].x + dy[i].y * v[i].y) + (dy[i].z * v[i].z + dy[i].w * v[i].w);
    }
    m1 = hyv::warp_sum(m1) * (1.0f / D);
    m2 = hyv::warp_sum(m2) * (1.0f / D);
    float4* dxr = reinterpret_cast<float4*>(dx + row * D);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float4 o;
      o.x = rstd * ((dy[i].x - m1) - v[i].x * m2);
      o.y = rstd * ((dy[i].y - m1) - v[i].y * m2);
      o.z = rstd * ((dy[i].z - m1) - v[i].z * m2);
      o.w = rstd * ((dy[i].w - m1) - v[i].w * m2);
      __stcs(dxr + lane + 32 * i, o);
    }
  }

  __syncthreads();
  const float* redf = reinterpret_cast<const float*>(red);
  const long long out0 = ((long long)b * n_tiles + tile) * D;
  for (int c = threadIdx.x; c < D; c += kWarps * 32) {
    float a = 0.f, t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      a += redf[w * 2 * D + c];
      t += redf[w * 2 * D + D + c];
    }
    ds_part[out0 + c] = a;
    dt_part[out0 + c] = t;
  }
}

template <int V, typename GT>
cudaError_t launch_g(const void* x, const void* s, const void* g, void* dx, void* ds, void* dt,
                   int B, int L, float eps, cudaStream_t st) {
  const dim3 grid((L + kTileRows - 1) / kTileRows, B);
  const int smem = kWarps * 2 * V * 128 * (int)sizeof(float);
  auto kernel = ln_scale_shift_bwd_kernel<V, GT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kWarps * 32, smem, st>>>((const float*)x, (const float*)s, (const GT*)g,
                                          (float*)dx, (float*)ds, (float*)dt, L, eps);
  return cudaGetLastError();
}

template <int V>
cudaError_t launch(const void* x, const void* s, const void* g, void* dx, void* ds, void* dt,
                   int B, int L, float eps, int g_bf16, cudaStream_t st) {
  return g_bf16 ? launch_g<V, __nv_bfloat16>(x, s, g, dx, ds, dt, B, L, eps, st)
                : launch_g<V, float>(x, s, g, dx, ds, dt, B, L, eps, st);
}

}  // namespace

// x [B, L, D] fp32; s [B, D] fp32; g [B, L, D] bf16 (g_bf16) or fp32;
// dx [B, L, D] fp32; ds, dt [B, ceil(L / 32), D] fp32 per-tile partials.
// D up to 2048: a lane keeps 2 x D / 32 floats of the row in registers.
extern "C" int hyv_ln_scale_shift_bwd(const void* x, const void* s, const void* g, void* dx,
                                      void* ds, void* dt, int B, int L, int D, float eps,
                                      int g_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if ((long long)B * L == 0) return 0;
  switch (D) {
    case 128: return launch<1>(x, s, g, dx, ds, dt, B, L, eps, g_bf16, st);
    case 256: return launch<2>(x, s, g, dx, ds, dt, B, L, eps, g_bf16, st);
    case 512: return launch<4>(x, s, g, dx, ds, dt, B, L, eps, g_bf16, st);
    case 1024: return launch<8>(x, s, g, dx, ds, dt, B, L, eps, g_bf16, st);
    case 1536: return launch<12>(x, s, g, dx, ds, dt, B, L, eps, g_bf16, st);
    case 2048: return launch<16>(x, s, g, dx, ds, dt, B, L, eps, g_bf16, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

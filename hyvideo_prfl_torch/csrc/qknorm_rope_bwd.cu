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
// share through L2: 0.31 ms at [1, 32,760, 5120]. So the card's 3.35 TB/s
// have to stay busy: some 25 KB in flight on every SM, all the time.
//
// Design, for every head count N from 1 to 64, with rope and without:
//
// * Persistent grid: min(#SMs, tiles) blocks of 8 consumer warps and one
//   producer warp, one block per SM. Tiles are T consecutive rows of one
//   batch element; block i owns the contiguous run of tiles
//   [i * tiles / grid, (i + 1) * tiles / grid), fixed by the shapes and
//   the SM count alone.
// * A ring of 2 to 8 stages in shared memory, kept full by one producer
//   thread on mbarriers: a stage holds the tile's x rows (one 1D bulk copy,
//   T * M * 2 bytes, contiguous in [B, L, M]), its g box [N, T, 128] (one
//   TMA load through a rank-4 map over the head-major [B, N, L, 128]; rows
//   past L arrive as zeros) and, with rope, the T rows of both tables (two
//   bulk copies). Tiles k + 1 .. k + stages - 1 load while tile k
//   computes. At N = 40: T = 2, 42 KB a stage, 4 stages.
// * S warps per row (S = 1, 2, 4 or 8: the fewest that leave a lane at most
//   six 32-chunk groups; N 40: S = 4, five groups), T = 8 / S rows a
//   tile. A lane holds 16 B chunks g * 32 + lane of the row (8 features
//   each), so its rope partner 64 features away sits on lane ^ 8: one
//   shuffle. Pass 1 reads x, g and w from shared memory and forms the two
//   row sums sum(x^2) and sum(du w x) together (neither needs r); a warp
//   sums by shuffles, and the S warps of a row add their partials in a
//   fixed order behind a named barrier of those S warps alone, in slots
//   that alternate between rows. Pass 2 recomputes du, writes dx with one
//   16 B store per lane (a warp writes 512 contiguous bytes) and adds
//   du * bf16(x r) into the lane's dw registers. No block-wide barrier
//   stands between rows or tiles: a warp returns its stage with one arrive.
// * dw: the lane's columns are the same in every row it takes, so its
//   partial stays in registers (at most 6 x 8 floats) across all the
//   block's tiles. At the end the T warps that share a slice write theirs to
//   shared memory and the block adds them in a fixed order: one [M]
//   partial per block, which the caller sums in a fixed order. dw is the
//   same to the bit on every call on one card (no atomics, no order that
//   depends on timing).
#include "sm90.cuh"

namespace {

constexpr int kWarps = 8;                    // consumer warps
constexpr int kThreads = (kWarps + 1) * 32;  // + the producer warp
constexpr int kMaxGroups = 6;                // 32-chunk groups a lane takes per row
constexpr int kMaxStages = 8;
constexpr int kSmemMax = 227 * 1024;
// byte offsets in the 1024-aligned shared block: barriers (full then empty,
// 8 B each), the row-sum slots [T][2][S] float2, w [M] fp32, the ring
constexpr uint32_t kBarFull = 0, kBarEmpty = 8 * kMaxStages;
constexpr uint32_t kRed = 256;
constexpr uint32_t kW = 2048;
constexpr int kConsumerBar = 9;  // named barrier of the 256 consumer threads

struct Geometry {
  int S, T, stages, stage_bytes, ring, smem, tiles_per_b, tiles, grid;
};

// The tile shape of a call, the same for the launch and for the partial
// count the wrapper allocates.
Geometry geometry(int B, int L, int N, bool rope, int sms) {
  Geometry g;
  const int groups = (N * 16 + 31) / 32;
  g.S = 1;
  while ((groups + g.S - 1) / g.S > kMaxGroups) g.S *= 2;
  g.T = kWarps / g.S;
  if (g.T > L) g.T = L;
  g.stage_bytes = g.T * N * 512 + (rope ? g.T * 1024 : 0);
  g.ring = (int)((kW + N * 512 + 1023) & ~1023u);
  g.stages = (kSmemMax - 1024 - g.ring) / g.stage_bytes;
  if (g.stages > kMaxStages) g.stages = kMaxStages;
  g.smem = g.ring + g.stages * g.stage_bytes + 1024;
  g.tiles_per_b = (L + g.T - 1) / g.T;
  g.tiles = B * g.tiles_per_b;
  g.grid = g.tiles < sms ? g.tiles : sms;
  return g;
}

__device__ __forceinline__ void lds8f(const float* p, float* f) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

template <bool kRope>
__global__ void __launch_bounds__(kThreads, 1)
rmsnorm_rope_bwd_kernel(const __grid_constant__ CUtensorMap gmap,
                        const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
                        const float* __restrict__ ctab, const float* __restrict__ stab,
                        __nv_bfloat16* __restrict__ dx, float* __restrict__ dw_part, int L,
                        int N, int S, int T, int stages, int stage_bytes, int ring,
                        int tiles_per_b, int tiles, float eps) {
  using namespace hyv::sm90;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const sbase = smem_raw + (base - raw);  // generic pointer to `base`
  const int M = N * 128, n_chunks = N * 16, groups = (n_chunks + 31) / 32;
  const int t0 = (int)((long long)blockIdx.x * tiles / gridDim.x);
  const int t1 = (int)((long long)(blockIdx.x + 1) * tiles / gridDim.x);
  const uint32_t x_bytes = (uint32_t)T * M * 2, g_off = x_bytes,
                 tab_off = g_off + (uint32_t)N * T * 256;

  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(base + kBarFull + 8 * i, 1);
      mbar_init(base + kBarEmpty + 8 * i, kWarps);  // one lane per consumer warp
    }
    fence_barrier_init();
    prefetch_map(&gmap);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == kWarps) {
    // ---- producer: one thread issues every copy ----
    if (lane != 0) return;
    for (int k = 0; k < t1 - t0; ++k) {
      const int st = k % stages, tile = t0 + k;
      const int b = tile / tiles_per_b, l0 = (tile - b * tiles_per_b) * T;
      const int rows = min(T, L - l0);
      const uint32_t sx = base + ring + st * stage_bytes, bar = base + kBarFull + 8 * st;
      mbar_wait(base + kBarEmpty + 8 * st, ((k / stages) & 1) ^ 1);
      // the g box counts whole, its rows past L included (zero-filled)
      mbar_expect_tx(bar, (uint32_t)rows * M * 2 + (uint32_t)N * T * 256 +
                              (kRope ? (uint32_t)rows * 1024 : 0u));
      bulk_load(sx, x + ((long long)b * L + l0) * M, (uint32_t)rows * M * 2, bar);
      tma_load_4d(sx + g_off, &gmap, bar, 0, l0, 0, b);
      if constexpr (kRope) {
        bulk_load(sx + tab_off, ctab + (long long)l0 * 128, (uint32_t)rows * 512, bar);
        bulk_load(sx + tab_off + T * 512, stab + (long long)l0 * 128, (uint32_t)rows * 512, bar);
      }
    }
    return;
  }

  // ---- consumers: S warps per row, T rows per tile ----
  float* const ws = reinterpret_cast<float*>(sbase + kW);
  for (int i = threadIdx.x; i < M / 4; i += kWarps * 32)
    reinterpret_cast<float4*>(ws)[i] = __ldg(reinterpret_cast<const float4*>(w) + i);
  named_bar_sync(kConsumerBar, kWarps * 32);

  const int slice = warp % S, rw = warp / S;
  const int d0 = (lane & 15) * 8;  // the lane's feature offset in every head
  float2* const red = reinterpret_cast<float2*>(sbase + kRed) + rw * 2 * S;
  float dws[kMaxGroups][8];
#pragma unroll
  for (int j = 0; j < kMaxGroups; ++j)
#pragma unroll
    for (int e = 0; e < 8; ++e) dws[j][e] = 0.f;
  int par = 0;

  for (int k = 0; k < t1 - t0; ++k) {
    const int st = k % stages, tile = t0 + k;
    const int b = tile / tiles_per_b, l = (tile - b * tiles_per_b) * T + rw;
    mbar_wait(base + kBarFull + 8 * st, (k / stages) & 1);
    if (rw < T && l < L) {  // uniform over the row's S warps
      const uint8_t* stage = sbase + ring + st * stage_bytes;
      const uint4* xr = reinterpret_cast<const uint4*>(stage + rw * M * 2);
      const uint8_t* gs = stage + g_off + rw * 256;  // head h at + h * T * 256
      float cs[8], sp[8];
      if constexpr (kRope) {
        const float* tab = reinterpret_cast<const float*>(stage + tab_off) + rw * 128;
        lds8f(tab + d0, cs);
        lds8f(tab + T * 128 + (d0 ^ 64), sp);  // roll(S, 64) at d0
      }
      // du of the lane's chunk of group j (zeros past the row)
      auto load = [&](int j, float* xf, float* du, float* wv) {
        const int chunk = (slice + S * j) * 32 + lane;
        const bool mine = chunk < n_chunks;
        const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
        const uint4 xraw = mine ? xr[chunk] : zero;
        const uint4 graw =
            mine ? *reinterpret_cast<const uint4*>(gs + (chunk >> 4) * T * 256 + d0 * 2) : zero;
        hyv::unpack8(xraw, xf);
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
          for (int e = 0; e < 8; ++e) du[e] = gv[e] * cs[e] + pv[e] * sp[e];
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) du[e] = gv[e];
        }
        if (mine) {
          lds8f(ws + chunk * 8, wv);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) wv[e] = 0.f;
        }
        return chunk;
      };

      // pass 1: sum(x^2) and sum(du w x)
      float ss = 0.f, dot = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxGroups; ++j) {
        if (slice + S * j < groups) {  // uniform over the warp
          float xf[8], du[8], wv[8];
          load(j, xf, du, wv);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            ss += xf[e] * xf[e];
            dot += du[e] * wv[e] * xf[e];
          }
        }
      }
      ss = hyv::warp_sum(ss);
      dot = hyv::warp_sum(dot);
      if (S > 1) {
        float2* slot = red + par * S;
        par ^= 1;
        if (lane == 0) slot[slice] = make_float2(ss, dot);
        named_bar_sync(1 + rw, 32 * S);
        ss = dot = 0.f;
        for (int i = 0; i < S; ++i) {
          const float2 v = slot[i];
          ss += v.x;
          dot += v.y;
        }
      }
      const float rr = 1.0f / sqrtf(ss * (1.0f / M) + eps);
      const float r3dot = (rr * rr * rr) * (dot * (1.0f / M));

      // pass 2: dx, and du * bf16(x r) into the lane's dw
      uint4* dxr = reinterpret_cast<uint4*>(dx + ((long long)b * L + l) * M);
#pragma unroll
      for (int j = 0; j < kMaxGroups; ++j) {
        if (slice + S * j < groups) {
          float xf[8], du[8], wv[8], o[8];
          const int chunk = load(j, xf, du, wv);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            o[e] = rr * (du[e] * wv[e]) - xf[e] * r3dot;
            dws[j][e] += du[e] * hyv::bf16_round(__fmul_rn(xf[e], rr));
          }
          if (chunk < n_chunks) __stwb(dxr + chunk, hyv::pack8(o));
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(base + kBarEmpty + 8 * st);
  }

  // dw: the T warps of each slice add their partials in row order, through
  // shared memory (the ring: every copy into it has landed and been read)
  named_bar_sync(kConsumerBar, kWarps * 32);
  float* const part = reinterpret_cast<float*>(sbase + ring);
  if (rw < T) {
#pragma unroll
    for (int j = 0; j < kMaxGroups; ++j) {
      const int chunk = (slice + S * j) * 32 + lane;
      if (slice + S * j < groups && chunk < n_chunks) {
        float4* p = reinterpret_cast<float4*>(part + rw * M + chunk * 8);
        p[0] = make_float4(dws[j][0], dws[j][1], dws[j][2], dws[j][3]);
        p[1] = make_float4(dws[j][4], dws[j][5], dws[j][6], dws[j][7]);
      }
    }
  }
  named_bar_sync(kConsumerBar, kWarps * 32);
  float* out = dw_part + (long long)blockIdx.x * M;
  for (int c = threadIdx.x; c < M; c += kWarps * 32) {
    float a = 0.f;
    for (int r = 0; r < T; ++r) a += part[r * M + c];
    out[c] = a;
  }
}

}  // namespace

// The number of [N*128] dw partials a call at these shapes writes (its
// grid), or 0 when there is nothing to do.
extern "C" int hyv_rmsnorm_rope_bwd_parts(int B, int L, int N, int rope) {
  if ((long long)B * L == 0 || N < 1 || N > 64) return 0;
  return geometry(B, L, N, rope != 0, hyv::sm90::sm_count()).grid;
}

// x [B, L, N*128] bf16; w [N*128] fp32; c, s [L, 128] fp32 (ignored unless
// rope); g [B, N, L, 128] bf16; dx [B, L, N*128] bf16; dw
// [hyv_rmsnorm_rope_bwd_parts(B, L, N, rope), N*128] fp32 per-block
// partials. N from 1 to 64; every pointer 16-byte aligned.
extern "C" int hyv_rmsnorm_rope_bwd(const void* x, const void* w, const void* c, const void* s,
                                    const void* g, void* dx, void* dw, int B, int L, int N,
                                    int D, float eps, int rope, void* stream) {
  if (D != 128 || N < 1 || N > 64) return (int)cudaErrorInvalidValue;
  if ((long long)B * L == 0) return 0;
  const int sms = hyv::sm90::sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const Geometry geo = geometry(B, L, N, rope != 0, sms);
  if (geo.stages < 2) return (int)cudaErrorInvalidValue;
  CUtensorMap gmap;
  const cuuint64_t dims[4] = {128, (cuuint64_t)L, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t strides[3] = {256, (cuuint64_t)L * 256, (cuuint64_t)N * L * 256};
  const cuuint32_t box[4] = {128, (cuuint32_t)geo.T, (cuuint32_t)N, 1};
  cudaError_t err = hyv::sm90::encode_tiled(&gmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, g, dims,
                                            strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return (int)err;
  auto kernel = rope ? rmsnorm_rope_bwd_kernel<true> : rmsnorm_rope_bwd_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, geo.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<geo.grid, kThreads, geo.smem, (cudaStream_t)stream>>>(
      gmap, (const __nv_bfloat16*)x, (const float*)w, (const float*)c, (const float*)s,
      (__nv_bfloat16*)dx, (float*)dw, L, N, geo.S, geo.T, geo.stages, geo.stage_bytes, geo.ring,
      geo.tiles_per_b, geo.tiles, eps);
  return (int)cudaGetLastError();
}

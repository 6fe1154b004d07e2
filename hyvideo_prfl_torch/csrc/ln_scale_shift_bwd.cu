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
// 3.35 TB/s, 11.9 us at [1, 3,120, 1280]. So every SM has to keep some
// 25 KB in flight all the time, and the ds/dt sums across rows must cost
// next to nothing.
//
// Design (K7's, qknorm_rope_bwd.cu), for every D that is a multiple of 128
// up to 8192 and either g type. The geometry comes from the caller
// (ops/stream.py k9_geometry, which the wrapper allocates from); the entry
// point checks it.
//
// * Persistent grid: min(#SMs, tiles) co-resident blocks (a cooperative
//   launch) of 8 consumer warps and one producer warp. Tiles are T
//   consecutive rows of one batch element; block i owns the contiguous run
//   of tiles [i * tiles / grid, (i + 1) * tiles / grid), fixed by the
//   shapes and the SM count alone.
// * A ring of stages in shared memory, kept full by one producer thread on
//   mbarriers: a stage holds the tile's x rows and its g rows, each one 1D
//   bulk copy (rows are contiguous in [B, L, D]); tile k + 1 loads while
//   tile k computes. Two stages, or more for narrow rows, up to 48 KB
//   loading: on the H100 deeper rings were slower at every width measured
//   (scripts/ablate_ln_bwd_torch.py: at [1, 32,760, 5120] 2 stages took
//   0.585 ms, 6 stages 0.611; at [1, 3,120, 1280] 2 stages 0.0214, 7
//   stages 0.0241).
// * S warps per row (S = 1, 2, 4 or 8: the fewest that leave a lane at most
//   eight 128-feature groups; T = 8 / S rows a tile). Lane l of slice i
//   holds the 16 B chunks (i + S j) * 32 + l of the row, the same columns
//   in every row. Three passes read x, g and s[b] from shared memory (the
//   registers hold the ds/dt partials): sum x; then sum xc^2, sum dyn and
//   sum dyn * xc together; then dx, in 16 B streaming stores (a warp writes
//   512 contiguous bytes). Each sum is warp shuffles, and the S warps of a
//   row add their partials in a fixed order behind a named barrier of those
//   S warps alone. No block-wide barrier stands between rows or tiles: a
//   warp returns its stage with one arrive.
// * ds/dt: a lane keeps its columns' partials in registers across the
//   block's tiles. s[b] sits in shared memory, loaded when the run enters a
//   batch element. There, and at the end of the run, the block's T row
//   groups add their partials in row order through shared memory into one
//   [2, D] partial per (block, b), in slot block + b.
// * The cross-block sum takes no launch of its own: a grid-wide ticket (a
//   word of the caller's, which the last block sets back to 0), then every
//   warp of the grid sums whole columns of the partials, lane j over the
//   blocks first + j, first + j + 32, ... in order, then a shuffle tree.
//   So ds and dt are the same to the bit on every call with the same
//   shapes on the same card: no atomics on the data, no order that
//   depends on timing. At [1, 3,120, 1280] the ticket and the sum take
//   3.6 us of 21.4 (the same script).
#include "sm90.cuh"

namespace {

constexpr int kWarps = 8;                    // consumer warps
constexpr int kThreads = (kWarps + 1) * 32;  // + the producer warp
constexpr int kMaxGroups = 8;                // 128-feature groups a lane takes per row
constexpr int kMaxStages = 8;
constexpr int kSmemMax = 227 * 1024;
// byte offsets in shared memory: the barriers (full then empty, 8 B each),
// the row-sum slots [T][2][S] float4, then from kHeader s[b] [D] fp32, the
// [2][D] fp32 region where the row groups add their ds/dt partials (T > 1),
// then the ring
constexpr uint32_t kBarFull = 0, kBarEmpty = 8 * kMaxStages;
constexpr uint32_t kRed = 128;
constexpr int kHeader = 1024;
constexpr int kConsumerBar = 15;  // named barrier of the consumer threads; rows take 1 .. T

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 lds4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// the tile's owner: the largest block i with i * tiles / grid <= tile
__device__ __forceinline__ int owner(int tile, int tiles, int grid) {
  return (int)(((long long)(tile + 1) * grid - 1) / tiles);
}

template <typename GT>
__global__ void __launch_bounds__(kThreads, 1)
ln_scale_shift_bwd_kernel(const float* __restrict__ x, const float* __restrict__ s,
                          const GT* __restrict__ g, float* __restrict__ dx,
                          float* __restrict__ part, float* __restrict__ ds,
                          float* __restrict__ dt, unsigned int* __restrict__ sync, int B,
                          int L, int D, int S, int T, int stages, int stage_bytes, int ring,
                          int tiles_per_b, int tiles, float eps) {
  using namespace hyv::sm90;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem);
  const int groups = D / 128, grid = gridDim.x;
  const int t0 = (int)((long long)blockIdx.x * tiles / grid);
  const int t1 = (int)((long long)(blockIdx.x + 1) * tiles / grid);
  const uint32_t x_bytes = (uint32_t)T * D * 4;  // a stage: x rows, then g rows
  const float inv_d = 1.0f / D;

  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(base + kBarFull + 8 * i, 1);
      mbar_init(base + kBarEmpty + 8 * i, kWarps);  // one lane per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == kWarps) {
    // ---- producer: one thread issues every copy ----
    if (lane == 0) {
      for (int k = 0; k < t1 - t0; ++k) {
        const int st = k % stages, tile = t0 + k;
        const int b = tile / tiles_per_b, l0 = (tile - b * tiles_per_b) * T;
        const int rows = min(T, L - l0);
        const long long row0 = (long long)b * L + l0;
        const uint32_t sx = base + ring + st * stage_bytes, bar = base + kBarFull + 8 * st;
        mbar_wait(base + kBarEmpty + 8 * st, ((k / stages) & 1) ^ 1);
        mbar_expect_tx(bar, (uint32_t)rows * D * (uint32_t)(4 + sizeof(GT)));
        bulk_load(sx, x + row0 * D, (uint32_t)rows * D * 4, bar);
        bulk_load(sx + x_bytes, g + row0 * D, (uint32_t)rows * D * (uint32_t)sizeof(GT), bar);
      }
    }
    __syncwarp();
  } else {
    // ---- consumers: S warps per row, T rows per tile ----
    const int slice = warp % S, rw = warp / S;
    float4* const red = reinterpret_cast<float4*>(smem + kRed) + rw * 2 * S;
    float* const ss = reinterpret_cast<float*>(smem + kHeader);  // s[b]
    float* const region = ss + D;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 acc_s[kMaxGroups], acc_t[kMaxGroups];
#pragma unroll
    for (int j = 0; j < kMaxGroups; ++j) acc_s[j] = acc_t[j] = zero;
    int par = 0;

    // the sum of v's first n components over the row's S warps, in every
    // lane of them: shuffles, then the S partials in slice order
    auto row_sum = [&](float4 v, int n) {
      v.x = hyv::warp_sum(v.x);
      if (n > 1) {
        v.y = hyv::warp_sum(v.y);
        v.z = hyv::warp_sum(v.z);
      }
      if (S > 1) {
        float4* slot = red + par * S;
        par ^= 1;  // consecutive sums alternate slots
        if (lane == 0) slot[slice] = v;
        named_bar_sync(1 + rw, 32 * S);
        v = zero;
        for (int i = 0; i < S; ++i) v = add4(v, slot[i]);
      }
      return v;
    };

    // the block's ds/dt partial for batch element b: the T row groups add
    // theirs in row order through the region; the last writes the slot
    auto flush = [&](int b) {
      float* out = part + (long long)(blockIdx.x + b) * 2 * D;
      for (int r = 0; r < T; ++r) {
        if (rw == r) {
#pragma unroll
          for (int j = 0; j < kMaxGroups; ++j) {
            if (slice + S * j < groups) {
              const int c = ((slice + S * j) * 32 + lane) * 4;
              float4 a = acc_s[j], t = acc_t[j];
              if (r > 0) {
                a = add4(a, lds4(region + c));
                t = add4(t, lds4(region + D + c));
              }
              float4* ds_to = reinterpret_cast<float4*>((r == T - 1 ? out : region) + c);
              float4* dt_to = reinterpret_cast<float4*>((r == T - 1 ? out : region) + D + c);
              *ds_to = a;
              *dt_to = t;
              acc_s[j] = acc_t[j] = zero;
            }
          }
        }
        if (T > 1) named_bar_sync(kConsumerBar, kWarps * 32);
      }
    };

    int cur_b = -1;
    for (int k = 0; k < t1 - t0; ++k) {
      const int st = k % stages, tile = t0 + k;
      const int b = tile / tiles_per_b, l = (tile - b * tiles_per_b) * T + rw;
      if (b != cur_b) {  // uniform over the consumers: every warp takes every tile
        if (cur_b >= 0) flush(cur_b);
        cur_b = b;
        // s[b] into shared memory, once every warp is done with the last one
        named_bar_sync(kConsumerBar, kWarps * 32);
        for (int i = threadIdx.x; i < D / 4; i += kWarps * 32)
          reinterpret_cast<float4*>(ss)[i] = __ldg(reinterpret_cast<const float4*>(s) +
                                                   (long long)b * (D / 4) + i);
        named_bar_sync(kConsumerBar, kWarps * 32);
      }
      mbar_wait(base + kBarFull + 8 * st, (k / stages) & 1);
      if (rw < T && l < L) {  // uniform over the row's S warps
        const uint8_t* stage = smem + ring + st * stage_bytes;
        const float* xs = reinterpret_cast<const float*>(stage) + rw * D;
        const GT* gs = reinterpret_cast<const GT*>(stage + x_bytes) + rw * D;
        // x and g are read from the stage in each pass that needs them
        // (shared memory has the bandwidth; registers hold the partials)
        float4 acc = zero;
#pragma unroll
        for (int j = 0; j < kMaxGroups; ++j) {
          if (slice + S * j < groups) {  // uniform over the warp
            const float4 xv = lds4(xs + ((slice + S * j) * 32 + lane) * 4);
            acc.x += (xv.x + xv.y) + (xv.z + xv.w);
          }
        }
        const float mean = row_sum(acc, 1).x * inv_d;

        // xc = x - mean; sum xc^2, sum dyn and sum dyn * xc (none needs
        // rstd); dt takes g
        acc = zero;
#pragma unroll
        for (int j = 0; j < kMaxGroups; ++j) {
          if (slice + S * j < groups) {
            const int c = ((slice + S * j) * 32 + lane) * 4;
            const float4 xv = lds4(xs + c), gv = lds4(gs + c), sv = lds4(ss + c);
            const float4 u = make_float4(xv.x - mean, xv.y - mean, xv.z - mean, xv.w - mean);
            const float4 dy = make_float4(gv.x * sv.x, gv.y * sv.y, gv.z * sv.z, gv.w * sv.w);
            acc.x += (u.x * u.x + u.y * u.y) + (u.z * u.z + u.w * u.w);
            acc.y += (dy.x + dy.y) + (dy.z + dy.w);
            acc.z += (dy.x * u.x + dy.y * u.y) + (dy.z * u.z + dy.w * u.w);
            acc_t[j] = add4(acc_t[j], gv);
          }
        }
        acc = row_sum(acc, 3);
        const float rstd = rsqrtf(acc.x * inv_d + eps);
        const float m1 = acc.y * inv_d, m2 = acc.z * inv_d * rstd;  // mean(dyn * yn)

        // dx, and g * yn into ds
        float4* dxr = reinterpret_cast<float4*>(dx + ((long long)b * L + l) * D);
#pragma unroll
        for (int j = 0; j < kMaxGroups; ++j) {
          if (slice + S * j < groups) {
            const int c4 = (slice + S * j) * 32 + lane;
            const float4 xv = lds4(xs + c4 * 4), gv = lds4(gs + c4 * 4), sv = lds4(ss + c4 * 4);
            const float4 yn = make_float4((xv.x - mean) * rstd, (xv.y - mean) * rstd,
                                          (xv.z - mean) * rstd, (xv.w - mean) * rstd);
            acc_s[j].x += gv.x * yn.x; acc_s[j].y += gv.y * yn.y;
            acc_s[j].z += gv.z * yn.z; acc_s[j].w += gv.w * yn.w;
            float4 o;
            o.x = rstd * ((gv.x * sv.x - m1) - yn.x * m2);
            o.y = rstd * ((gv.y * sv.y - m1) - yn.y * m2);
            o.z = rstd * ((gv.z * sv.z - m1) - yn.z * m2);
            o.w = rstd * ((gv.w * sv.w - m1) - yn.w * m2);
            __stcs(dxr + c4, o);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(base + kBarEmpty + 8 * st);
    }
    flush(cur_b);
  }

  // ---- the grid's ticket: every block's partials are written ----
  // Each block adds one to the count; the last sets it back to 0, which
  // releases the others (no call on this stream starts before they exit)
  // and leaves the count ready for the next call.
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(sync, 1u) == (unsigned int)grid - 1) {
      atomicExch(sync, 0u);
    } else {
      while (*reinterpret_cast<volatile unsigned int*>(sync) != 0u) {
      }
    }
    __threadfence();
  }
  __syncthreads();

  // ---- ds, dt: one warp per (b, output, 4 columns), over the grid ----
  const int c4s = D / 4, items = B * 2 * c4s;
  const int n_warps = grid * (kThreads / 32);
  for (int it = blockIdx.x * (kThreads / 32) + warp; it < items; it += n_warps) {
    const int b = it / (2 * c4s), rem = it - b * 2 * c4s;  // rem: output * c4s + column
    const int first = owner(b * tiles_per_b, tiles, grid);
    const int last = owner((b + 1) * tiles_per_b - 1, tiles, grid);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = first + lane; i <= last; i += 32)
      a = add4(a, __ldcg(reinterpret_cast<const float4*>(part + (long long)(i + b) * 2 * D) +
                         rem));
    a.x = hyv::warp_sum(a.x);
    a.y = hyv::warp_sum(a.y);
    a.z = hyv::warp_sum(a.z);
    a.w = hyv::warp_sum(a.w);
    if (lane == 0) {
      float* out = rem < c4s ? ds : dt;
      reinterpret_cast<float4*>(out + (long long)b * D)[rem % c4s] = a;
    }
  }
}

template <typename GT>
cudaError_t launch(const void* x, const void* s, const void* g, void* dx, void* part, void* ds,
                   void* dt, void* sync, int B, int L, int D, float eps, int S, int T,
                   int stages, int ring, int grid, cudaStream_t st) {
  const int stage_bytes = T * D * (4 + (int)sizeof(GT));
  const int tiles_per_b = (L + T - 1) / T;
  const int smem = ring + stages * stage_bytes;
  // the caller's geometry (ops/stream.py k9_geometry), checked
  const bool ok = S >= 1 && T >= 1 && T * S <= kWarps && (S == 1 || T < kConsumerBar) &&
                  (D / 128 + S - 1) / S <= kMaxGroups && stages >= 1 &&
                  stages <= kMaxStages && ring % 16 == 0 &&
                  ring >= kHeader + 4 * D + (T > 1 ? 8 * D : 0) && smem <= kSmemMax &&
                  grid >= 1 &&
                  grid <= B * tiles_per_b;
  if (!ok) return cudaErrorInvalidValue;
  auto kernel = ln_scale_shift_bwd_kernel<GT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // co-resident blocks, or the launch is refused: the grid's ticket waits
  // for every block
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, (const float*)x, (const float*)s, (const GT*)g,
                            (float*)dx, (float*)part, (float*)ds, (float*)dt,
                            (unsigned int*)sync, B, L, D, S, T, stages, stage_bytes, ring,
                            tiles_per_b, B * tiles_per_b, eps);
}

}  // namespace

// x [B, L, D] fp32; s [B, D] fp32; g [B, L, D] bf16 (g_bf16) or fp32;
// dx [B, L, D] fp32; ds, dt [B, D] fp32; part [grid + B - 1, 2, D] fp32
// scratch; sync one uint32 word, zero before the first call on a stream
// (the kernel leaves it so for the next). D a multiple of 128 up to 8192;
// S, T, stages, ring and grid from ops/stream.py k9_geometry; every pointer
// 16-byte aligned.
extern "C" int hyv_ln_scale_shift_bwd(const void* x, const void* s, const void* g, void* dx,
                                      void* part, void* ds, void* dt, void* sync, int B, int L,
                                      int D, float eps, int g_bf16, int S, int T, int stages,
                                      int ring, int grid, void* stream) {
  if (D <= 0 || D % 128 != 0 || D > 8192) return (int)cudaErrorInvalidValue;
  if ((long long)B * L == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  return g_bf16 ? (int)launch<__nv_bfloat16>(x, s, g, dx, part, ds, dt, sync, B, L, D, eps, S,
                                             T, stages, ring, grid, st)
                : (int)launch<float>(x, s, g, dx, part, ds, dt, sync, B, L, D, eps, S, T,
                                     stages, ring, grid, st);
}

// P1 and P2: the int8 tensor-core rate probes, int8 against bf16.
//
// Replaces
//   P1 hyvideo_prfl_tpu scripts/probe_int8_rate.py:25 kern (pallas_call :36):
//      a grid (reps, nblocks) whose every step adds a @ b_nb into one
//      revisited output block, int8 -> int32 and bf16 -> fp32;
//   P2 scripts/probe_int8_mosaic.py:29 _kern_int8 and :40 _kern_bf16
//      (pallas_call :56): 64 chained [512, 512] . [512, 512] products in one
//      kernel, the same two types.
// Both compute out = sum over reps r and b-blocks nb of a @ b_nb, with
// a [M, K] and b stored transposed, bt [nblocks * n_cols, K] (K contiguous
// in both: the K-major layout wgmma reads); P2 is nblocks = 1. They time
// int8 on wgmma m64n128k32 s32.s8.s8 (the instruction of K10's score,
// flash_fwd_qk8.cu) against bf16 on m64n128k16 f32.bf16.bf16 (K1's), so
// the pair says what int8 gains on the card's own matrix path.
//
// Bound on the H100: tensor-core math (1,979 int8 TOPS, 989 bf16 TFLOP/s);
// the operands are a few MB and are reused reps times.
//
// Design, on sm90.cuh: a block owns a 64 x 128 output tile and a share of
// the reps. One producer thread streams K in 128-byte chunks (128 int8 or
// 64 bf16 features) of a and of b_nb through a 4-stage TMA ring (the
// 128-byte swizzle: an 8 KB box of a, a 16 KB box of b); two consumer
// warpgroups each run half of the block's reps on each chunk with wgmma,
// both operands read from shared memory, the sums in registers. The TPU
// grid runs in order into one output block; on the card the reps are
// split over the C blocks of a thread-block cluster as well (C up to 8,
// the largest whose clusters all fit on the card at once, which the GPCs'
// SM counts decide: P2's 512 x 512 output is 32 tiles; P1's 512 x 2048 is
// 128 tiles, C = 1). At the end each warpgroup stages its partial tile in
// its block's shared memory, and block q of the cluster adds its share
// [q * 2048 / C, (q + 1) * 2048 / C) of the tile's 2048 16-byte vectors
// over all 2C partials, read through distributed shared memory in rank
// order, and stores each output element once: no atomics, no zeroed
// output. Int32 sums are exact in any order, and fp32 ones while every
// partial sum is an integer under 2^24 (the probes' inputs are -1, 0 and
// 1).
#include "sm90.cuh"

namespace {

constexpr int kBM = 64;   // output rows of a block
constexpr int kBN = 128;  // output columns of a block
constexpr int kChunk = 128;  // bytes of K per stage
constexpr int kStages = 4;
constexpr int kThreads = 384;
constexpr int kATile = kBM * kChunk;  // a's box: 8 KB
constexpr int kBTile = kBN * kChunk;  // b's box: 16 KB
constexpr int kStage = kATile + kBTile;
// byte offsets in the 1024-aligned shared block: the ring, then the
// barriers (full then empty, 8 B each); the two warpgroups' partial tiles
// [2][64][kRedRow] reuse the ring once the last product has retired
constexpr uint32_t kBar = kStages * kStage;
constexpr int kRedRow = kBN * 4 + 32;  // 32 B of padding: conflict-free 8 B stores
constexpr int kRedTile = kBM * kRedRow;
constexpr int kSmemBytes = kBar + 64 + 1024;
static_assert(2 * kRedTile <= kBar, "the partial tiles must fit in the ring");

using namespace hyv::sm90;

template <bool kInt8>
__global__ void __launch_bounds__(kThreads, 1)
probe_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
             void* out, int n_chunks, int n_cols, int nblocks, int reps) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar = base + kBar;
  const uint32_t C = gridDim.x / (n_cols / kBN), q = cluster_ctarank();
  const int m0 = blockIdx.y * kBM, n0 = (blockIdx.x / C) * kBN;
  // the block's reps [r0, r1), halved between the consumer warpgroups
  const int r0 = (int)((long long)q * reps / C), r1 = (int)((long long)(q + 1) * reps / C);
  const int rh = r0 + (r1 - r0) / 2;
  const int n_steps = nblocks * n_chunks;
  constexpr int kElems = kInt8 ? 128 : 64;  // features of one 128 B chunk

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(bar + 8 * i, 1);
      mbar_init(bar + 32 + 8 * i, 8);  // one lane per consumer warp
    }
    fence_barrier_init();
    prefetch_map(&amap);
    prefetch_map(&bmap);
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, wt = threadIdx.x & 127, lane = threadIdx.x & 31;
  float accf[64];
  uint32_t acci[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    accf[i] = 0.f;
    acci[i] = 0u;
  }
  if (wg == 0) {
    // ---- producer: one thread issues every load ----
    if (threadIdx.x == 0) {
      for (int step = 0; step < n_steps; ++step) {
        const int st = step % kStages, nb = step / n_chunks, kc = step - nb * n_chunks;
        const uint32_t sa = base + st * kStage;
        mbar_wait(bar + 32 + 8 * st, ((step / kStages) & 1) ^ 1);
        mbar_expect_tx(bar + 8 * st, kStage);
        tma_load_2d(sa, &amap, bar + 8 * st, kc * kElems, m0);
        tma_load_2d(sa + kATile, &bmap, bar + 8 * st, kc * kElems, nb * n_cols + n0);
      }
    }
  } else {
    // ---- consumers: each warpgroup takes half the reps of the whole tile ----
    const int ra = wg == 1 ? r0 : rh, rb = wg == 1 ? rh : r1;
    int prev = -1;
    for (int step = 0; step < n_steps; ++step) {
      const int st = step % kStages;
      const uint32_t sa = base + st * kStage, sb = sa + kATile;
      mbar_wait(bar + 8 * st, (step / kStages) & 1);
      wgmma_fence();
      for (int r = ra; r < rb; ++r) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t da = desc_sw128(sa + kk * 32, 1, 64);
          const uint64_t db = desc_sw128(sb + kk * 32, 1, 64);
          if constexpr (kInt8)
            wgmma_m64n128k32_s8_ss(acci, da, db, 1);
          else
            wgmma_m64n128k16_ss(accf, da, db, 1);
        }
      }
      wgmma_commit();
      // the previous stage's products have retired: it returns to the producer
      wgmma_wait<1>();
      if (prev >= 0 && lane == 0) mbar_arrive(bar + 32 + 8 * prev);
      prev = st;
    }
    wgmma_wait<0>();
    if constexpr (kInt8)
      reg_fence(acci);
    else
      reg_fence(accf);
  }

  // Each warpgroup's partial tile, staged over the ring once both consumer
  // warpgroups' products have retired (every load has landed by then).
  __syncthreads();
  if (wg > 0) {
    const int row = (wt >> 5) * 16 + (lane >> 2), col = (lane & 3) * 2;
    uint8_t* red = smem_raw + (base - (uint32_t)__cvta_generic_to_shared(smem_raw)) +
                   (wg - 1) * kRedTile;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint2 v;
        if constexpr (kInt8) {
          v = make_uint2(acci[4 * j + 2 * h], acci[4 * j + 2 * h + 1]);
        } else {
          v = make_uint2(__float_as_uint(accf[4 * j + 2 * h]),
                         __float_as_uint(accf[4 * j + 2 * h + 1]));
        }
        *reinterpret_cast<uint2*>(red + (row + 8 * h) * kRedRow + (8 * j + col) * 4) = v;
      }
  }
  cluster_sync();

  // Block q adds its rows of the 2C partials, in rank order, and stores
  // them.
  constexpr int kVecs = kBM * kBN / 4;
  const int v1 = (int)((q + 1) * kVecs / C);
  for (int i = (int)(q * kVecs / C) + threadIdx.x; i < v1; i += kThreads) {
    const int row = i / (kBN / 4), c4 = (i % (kBN / 4)) * 4;
    const uint32_t off = base + row * kRedRow + c4 * 4;
    uint4 s = ld_cluster_v4(mapa(off, 0));
    for (uint32_t p = 1; p < 2 * C; ++p) {
      const uint4 v = ld_cluster_v4(mapa(off + (p & 1) * kRedTile, p >> 1));
      if constexpr (kInt8) {
        s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
      } else {
        s.x = __float_as_uint(__uint_as_float(s.x) + __uint_as_float(v.x));
        s.y = __float_as_uint(__uint_as_float(s.y) + __uint_as_float(v.y));
        s.z = __float_as_uint(__uint_as_float(s.z) + __uint_as_float(v.z));
        s.w = __float_as_uint(__uint_as_float(s.w) + __uint_as_float(v.w));
      }
    }
    *reinterpret_cast<uint4*>(reinterpret_cast<uint32_t*>(out) +
                              (long long)(m0 + row) * n_cols + n0 + c4) = s;
  }
  // no block leaves while another still reads its shared memory
  cluster_sync();
}

// The kernel instance of a type, its shared memory set.
using Kernel = decltype(&probe_kernel<true>);
cudaError_t instance(int int8, Kernel* kernel) {
  *kernel = int8 ? probe_kernel<true> : probe_kernel<false>;
  return cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
}

cudaLaunchConfig_t config(cudaLaunchAttribute* attr, int tiles_n, int tiles_m, int c,
                          cudaStream_t stream) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles_n * c, tiles_m);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The cluster size of a call: the largest up to 8 that leaves every block
// at least one rep and puts every tile's cluster on the card at once, else
// 1.
int cluster_size(Kernel kernel, int tiles_n, int tiles_m, int reps) {
  const int sms = sm_count();
  for (int c = 8; c > 1; --c) {
    if (c > reps || tiles_n * tiles_m * c > sms) continue;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = config(&attr, tiles_n, tiles_m, c, nullptr);
    int active = 0;
    if (cudaOccupancyMaxActiveClusters(&active, (const void*)kernel, &cfg) == cudaSuccess &&
        active >= tiles_n * tiles_m)
      return c;
    cudaGetLastError();
  }
  return 1;
}

bool valid(int M, int k_bytes, int n_cols, int nblocks, int reps) {
  return M > 0 && n_cols > 0 && k_bytes > 0 && M % kBM == 0 && n_cols % kBN == 0 &&
         k_bytes % kChunk == 0 && nblocks >= 1 && reps >= 1;
}

int launch(const void* a, const void* bt, void* out, int M, int k_bytes, int n_cols,
           int nblocks, int reps, int int8, void* stream) {
  if (!valid(M, k_bytes, n_cols, nblocks, reps)) return (int)cudaErrorInvalidValue;
  Kernel kernel;
  cudaError_t err = instance(int8, &kernel);
  if (err != cudaSuccess) return (int)err;
  const int tiles_n = n_cols / kBN, tiles_m = M / kBM;
  const int C = cluster_size(kernel, tiles_n, tiles_m, reps);
  // a [M, K] and bt [nblocks * n_cols, K], K contiguous: boxes of 128 B x
  // 64 rows of a, x 128 rows of b
  const int elem = int8 ? 1 : 2, K = k_bytes / elem;
  const auto type = int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint32_t abox[2] = {(cuuint32_t)(kChunk / elem), (cuuint32_t)kBM};
  const cuuint32_t bbox[2] = {(cuuint32_t)(kChunk / elem), (cuuint32_t)kBN};
  const cuuint64_t adims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t bdims[2] = {(cuuint64_t)K, (cuuint64_t)nblocks * n_cols};
  const cuuint64_t strides[1] = {(cuuint64_t)k_bytes};
  CUtensorMap amap, bmap;
  if ((err = encode_tiled(&amap, type, 2, a, adims, strides, abox,
                          CU_TENSOR_MAP_SWIZZLE_128B)) ||
      (err = encode_tiled(&bmap, type, 2, bt, bdims, strides, bbox, CU_TENSOR_MAP_SWIZZLE_128B)))
    return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(&attr, tiles_n, tiles_m, C, (cudaStream_t)stream);
  err = cudaLaunchKernelEx(&cfg, kernel, amap, bmap, out, k_bytes / kChunk, n_cols, nblocks,
                           reps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// P1: out [M, n_cols] (int32 for int8, fp32 for bf16; every element
// written) = sum over reps and nb of a [M, K] @ bt[nb * n_cols:(nb + 1) *
// n_cols, K]^T; k_bytes = K times the element size. M and n_cols
// multiples of 64 and 128, k_bytes of 128.
extern "C" int hyv_probe_rate(const void* a, const void* bt, void* out, int M, int k_bytes,
                              int n_cols, int nblocks, int reps, int int8, void* stream) {
  return launch(a, bt, out, M, k_bytes, n_cols, nblocks, reps, int8, stream);
}

// P2: out [M, N] = sum of `steps` chained products a [M, K] @ bt [N, K]^T.
extern "C" int hyv_probe_chain(const void* a, const void* bt, void* out, int M, int k_bytes,
                               int n, int steps, int int8, void* stream) {
  return launch(a, bt, out, M, k_bytes, n, 1, steps, int8, stream);
}

// The cluster size (blocks that share one output tile's reps) a probe call
// at these shapes takes, or a negative CUDA error.
extern "C" int hyv_probe_cluster(int M, int k_bytes, int n_cols, int reps, int int8) {
  if (!valid(M, k_bytes, n_cols, 1, reps)) return -(int)cudaErrorInvalidValue;
  Kernel kernel;
  const cudaError_t err = instance(int8, &kernel);
  if (err != cudaSuccess) return -(int)err;
  return cluster_size(kernel, n_cols / kBN, M / kBM, reps);
}

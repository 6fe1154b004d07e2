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
// in both: the layout ldmatrix and the int8 mma want); P2 is nblocks = 1.
// They time int8 on mma.sync m16n8k32 (s8 x s8 -> s32) against bf16 on
// m16n8k16 (-> fp32): the instruction K10 uses for q k^T and its bf16
// counterpart on the same path, so the pair says what int8 gains there.
//
// Bound on the H100: tensor-core math (1,979 int8 TOPS, 989 bf16 TFLOP/s);
// the operands are a few MB and are reused reps times.
//
// Design: operands sit in shared memory and the products accumulate in
// registers. A block of 8 warps owns a 256 x 128 output tile (64 x 64 per
// warp: 32 products per 32-byte step of K, 4 KB of ldmatrix reads) and
// streams K in 128-byte chunks (128 int8 or 64 bf16 features) of a and of
// b_nb through a two-stage cp.async ring. On each chunk it runs its share
// of the reps, reloading the fragments from shared memory every rep, as
// the TPU kernel re-reads its blocks every grid step (nothing loop-invariant
// to hoist). The TPU grid runs in order into one output block; on the card
// the reps are split over blocks to fill the SMs (P1's 512 x 2048 output is
// only 32 such tiles), and each block adds its partial sums with atomics:
// exact in any order for int32, and for fp32 while every partial sum is an
// integer under 2^24 (the probes' inputs are -1, 0 and 1).
#include <type_traits>

#include "tensor_core.cuh"

namespace {

constexpr int kBM = 256;
constexpr int kBN = 128;
constexpr int kChunk = 128;  // bytes of K per stage
constexpr int kThreads = 256;
constexpr int kATile = kBM * kChunk;
constexpr int kBTile = kBN * kChunk;
constexpr int kStage = kATile + kBTile;
constexpr int kSmemBytes = 2 * kStage;

using hyv::cp_async16;
using hyv::cp_async_commit;
using hyv::cp_async_wait;
using hyv::ldsm_x4;
using hyv::swz128;

template <bool kInt8>
__global__ void __launch_bounds__(kThreads, 1)
probe_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ bt, void* out,
             int k_bytes, int n_cols, int nblocks, int reps, int splits) {
  using Acc = typename std::conditional<kInt8, int, float>::type;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t s0 = (uint32_t)__cvta_generic_to_shared(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 1) * 64, wn = (warp & 1) * 64;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int r0 = (int)((long long)blockIdx.z * reps / splits);
  const int r1 = (int)((long long)(blockIdx.z + 1) * reps / splits);
  const int n_chunks = k_bytes / kChunk;
  const int n_steps = nblocks * n_chunks;

  auto load = [&](int step, int stage) {
    const int nb = step / n_chunks, kc = step - nb * n_chunks;
    const uint8_t* ap = a + (long long)m0 * k_bytes + kc * kChunk;
    const uint8_t* bp = bt + ((long long)nb * n_cols + n0) * k_bytes + kc * kChunk;
    const uint32_t sa = s0 + stage * kStage, sb = sa + kATile;
#pragma unroll
    for (int i = 0; i < kBM * 8 / kThreads; ++i) {
      const int idx = tid + i * kThreads, r = idx >> 3, ch = idx & 7;
      cp_async16(sa + swz128(r, ch), ap + (long long)r * k_bytes + ch * 16, true);
    }
#pragma unroll
    for (int i = 0; i < kBN * 8 / kThreads; ++i) {
      const int idx = tid + i * kThreads, r = idx >> 3, ch = idx & 7;
      cp_async16(sb + swz128(r, ch), bp + (long long)r * k_bytes + ch * 16, true);
    }
  };

  Acc acc[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  load(0, 0);
  cp_async_commit();
  for (int step = 0; step < n_steps; ++step) {
    const int st = step & 1;
    if (step + 1 < n_steps) load(step + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const uint32_t sa = s0 + st * kStage, sb = sa + kATile;
    for (int r = r0; r < r1; ++r) {
#pragma unroll
      for (int kk = 0; kk < kChunk / 32; ++kk) {
        uint32_t af[4][4], bf[8][2];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          ldsm_x4(sa + swz128(wm + i * 16 + (lane & 15), kk * 2 + (lane >> 4)),
                  af[i][0], af[i][1], af[i][2], af[i][3]);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          ldsm_x4(sb + swz128(wn + jj * 16 + (lane & 7) + ((lane >> 4) << 3),
                              kk * 2 + ((lane >> 3) & 1)),
                  bf[2 * jj][0], bf[2 * jj][1], bf[2 * jj + 1][0], bf[2 * jj + 1][1]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if constexpr (kInt8)
              hyv::mma_s8(acc[i][j], af[i], bf[j][0], bf[j][1]);
            else
              hyv::mma(acc[i][j], af[i], bf[j][0], bf[j][1]);
          }
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's load
  }

  Acc* o = reinterpret_cast<Acc*>(out);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long row = m0 + wm + i * 16 + g + 8 * (e >> 1);
        atomicAdd(o + row * n_cols + n0 + wn + j * 8 + 2 * t + (e & 1), acc[i][j][e]);
      }
}

int launch(const void* a, const void* bt, void* out, int M, int k_bytes, int n_cols,
           int nblocks, int reps, int splits, int int8, void* stream) {
  if (M % kBM || n_cols % kBN || k_bytes % kChunk || nblocks < 1 || reps < 1 || splits < 1)
    return (int)cudaErrorInvalidValue;
  auto kernel = int8 ? probe_kernel<true> : probe_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_cols / kBN, M / kBM, splits);
  kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      (const uint8_t*)a, (const uint8_t*)bt, out, k_bytes, n_cols, nblocks, reps, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// P1: out [M, n_cols] (int32 for int8, fp32 for bf16, zeroed by the
// caller) += sum over reps and nb of a [M, K] @ bt[nb * n_cols:(nb + 1) *
// n_cols, K]^T; k_bytes = K times the element size. M a multiple of 256,
// n_cols of 128, k_bytes of 128.
extern "C" int hyv_probe_rate(const void* a, const void* bt, void* out, int M, int k_bytes,
                              int n_cols, int nblocks, int reps, int splits, int int8,
                              void* stream) {
  return launch(a, bt, out, M, k_bytes, n_cols, nblocks, reps, splits, int8, stream);
}

// P2: out [M, N] += steps chained products a [M, K] @ bt [N, K]^T.
extern "C" int hyv_probe_chain(const void* a, const void* bt, void* out, int M, int k_bytes,
                               int n, int steps, int splits, int int8, void* stream) {
  return launch(a, bt, out, M, k_bytes, n, 1, steps, splits, int8, stream);
}

// K1 and K3: fixed-max ("bounded") flash-attention forward, head_dim 128.
//
// Replaces hyvideo_prfl_tpu/ops/flash_attention.py
//   K1 _fwd_kernel_bounded  (pallas_call at flash_attention.py:619, via
//      _flash_fwd_impl): the streaming forward of the DiT self-attention;
//   K3 _fwd_kernel_single   (pallas_call at flash_attention.py:656, via
//      _flash_fwd_single) in its bounded form: the single-K-block forward
//      of the text cross-attention (lk <= FULL_K_MAX = 3584).
// Both compute, per (batch, head) and q row,
//
//   q' = bf16(q * scale * log2(e));  p = exp2(q' . k)   (no running max)
//   l  = sum p;  o = (sum bf16(p) v) / l;  lse = ln(l)
//
// which is exact while the logits stay under ~70: the DiT's qk-RMSNorm
// keeps them there (flash_attention.py:76-101). Keys past lk are masked
// (p = 0) inside the last tile; the TPU instead padded K with zeros and
// subtracted the pad count from l, which gives the same result.
//
// Bound on the H100: tensor-core math. At the 81-frame slice shape
// (24 heads x 32,760 x 32,760 x 128) one call is ~13 TFLOP against ~0.4 GB
// of q/k/v/o traffic, far above the ~295 flop/byte line.
//
// Design (FlashAttention-2 shape on mma.sync; TMA and wgmma wait for a
// later revision):
// * A block of 8 warps owns 128 q rows of one (batch, head); each warp owns
//   16 rows and keeps its pre-scaled q fragments in registers for the whole
//   key loop. The grid's y axis walks batch * heads, so no two blocks share
//   an output and nothing carries across blocks.
// * Keys stream in 64-row tiles of K and V through a two-stage cp.async
//   ring in shared memory; the next tile loads while this one computes.
// * Both products (q k^T and p v) are mma.sync.m16n8k16 bf16 -> fp32 on the
//   tensor cores, fed by ldmatrix (v through ldmatrix.trans, so v is read in
//   its native [B, L, N, D] layout with no transpose). Rows of 256 B are
//   XOR-swizzled in 16 B chunks so ldmatrix's 8-row reads hit distinct banks.
// * The bounded softmax needs no max, no rescale of the accumulator and no
//   cross-lane reduction inside the loop: p = exp2(s) turns the score
//   fragment straight into the bf16 A operand of the p v product, and the
//   row sums reduce across the lane quad once at the end.
// * q and k are read in [B, N, L, D] and v in [B, L, N, D] through strides;
//   o is written in [B, L, N, D] and lse as [B*N, Lq] fp32.
// K3 is the same loop: with no running max there is no per-block state to
// drop, so the single-block case is this loop over at most 56 key tiles.
// It is the kSingle = true instance, so profiles name K1 and K3 apart, and
// its entry enforces the lk <= FULL_K_MAX contract.
#include "tensor_core.cuh"

namespace {

constexpr int kD = 128;
constexpr int kBlockM = 128;
constexpr int kBlockN = 64;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowBytes = kD * 2;
constexpr int kTileBytes = kBlockN * kRowBytes;
constexpr int kSmemBytes = kBlockM * kRowBytes + 4 * kTileBytes;  // Q + 2x(K, V)
constexpr int kFullKMax = 3584;
constexpr float kLn2 = 0.6931471805599453f;

using hyv::cp_async16;
using hyv::cp_async_commit;
using hyv::cp_async_wait;
using hyv::ldsm_x4;
using hyv::ldsm_x4_t;
using hyv::mma;
using hyv::pack_bf16x2;
using hyv::swz;

struct Strides {  // element strides of (batch, head, row); the feature stride is 1
  long long b, h, l;
};

template <bool kSingle>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_bounded_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                         int N, int Lq, int Lk, Strides qs, Strides ks, Strides vs,
                         Strides os, float qscale) {
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t sQ = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t sK0 = sQ + kBlockM * kRowBytes;
  const uint32_t sV0 = sK0 + 2 * kTileBytes;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, b = bh / N, h = bh - b * N;
  const int m0 = blockIdx.x * kBlockM;
  const __nv_bfloat16* qp = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kp = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vp = v + b * vs.b + h * vs.h;

  auto load_kv = [&](int tile, int stage) {
    const int n0 = tile * kBlockN;
#pragma unroll
    for (int i = 0; i < kBlockN * 16 / kThreads; ++i) {
      const int idx = tid + i * kThreads, r = idx >> 4, c = idx & 15;
      const bool valid = n0 + r < Lk;
      const long long key = valid ? n0 + r : 0;
      cp_async16(sK0 + stage * kTileBytes + swz(r, c), kp + key * ks.l + c * 8, valid);
      cp_async16(sV0 + stage * kTileBytes + swz(r, c), vp + key * vs.l + c * 8, valid);
    }
  };

  const int n_tiles = (Lk + kBlockN - 1) / kBlockN;
  load_kv(0, 0);
  cp_async_commit();

  // q tile -> bf16(q * scale * log2e) in shared memory (the TPU kernel's
  // pre-scaling, rounded to bf16 before the product as it rounds)
#pragma unroll
  for (int i = 0; i < kBlockM * 16 / kThreads; ++i) {
    const int idx = tid + i * kThreads, r = idx >> 4, c = idx & 15;
    const int row = m0 + r;
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (row < Lq) {
      hyv::unpack8(*reinterpret_cast<const uint4*>(qp + row * qs.l + c * 8), f);
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = __fmul_rn(f[e], qscale);
    }
    *reinterpret_cast<uint4*>(smem + swz(r, c)) = hyv::pack8(f);
  }
  __syncthreads();

  const int wr = warp * 16;
  uint32_t qf[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    ldsm_x4(sQ + swz(wr + (lane & 15), kk * 2 + (lane >> 4)),
            qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3]);

  float acc[kD / 8][4];
#pragma unroll
  for (int t = 0; t < kD / 8; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
  float lsum[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) load_kv(j + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const uint32_t sK = sK0 + st * kTileBytes, sV = sV0 + st * kTileBytes;

    // s = q' k^T: 16 rows x 64 keys per warp (8 fragments of 8 keys)
    float s[kBlockN / 8][4];
#pragma unroll
    for (int t = 0; t < kBlockN / 8; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
      for (int nn = 0; nn < kBlockN / 16; ++nn) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(sK + swz(nn * 16 + (lane & 7) + ((lane >> 4) << 3), kk * 2 + ((lane >> 3) & 1)),
                b0, b1, b2, b3);
        mma(s[2 * nn], qf[kk], b0, b1);
        mma(s[2 * nn + 1], qf[kk], b2, b3);
      }
    }

    // p = exp2(s); keys past Lk (only in the last tile) get p = 0
    const int key0 = j * kBlockN + (lane & 3) * 2;
    const bool tail = j * kBlockN + kBlockN > Lk;
#pragma unroll
    for (int t = 0; t < kBlockN / 8; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[t][e]);
        if (tail && key0 + t * 8 + (e & 1) >= Lk) p = 0.f;
        s[t][e] = p;
        lsum[e >> 1] += p;
      }
    }

    // o += bf16(p) v: the score fragments are the A operand directly
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dd = 0; dd < kD / 16; ++dd) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_t(sV + swz(kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3), dd * 2 + (lane >> 4)),
                  b0, b1, b2, b3);
        mma(acc[2 * dd], a, b0, b1);
        mma(acc[2 * dd + 1], a, b2, b3);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's load
  }

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    lsum[e] += __shfl_xor_sync(0xffffffffu, lsum[e], 1);
    lsum[e] += __shfl_xor_sync(0xffffffffu, lsum[e], 2);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = m0 + wr + (lane >> 2) + 8 * half;
    if (row >= Lq) continue;
    const float l = lsum[half];
    const float l_safe = l <= 0.f ? 1.f : l;
    __nv_bfloat16* orow = o + b * os.b + h * os.h + row * os.l + (lane & 3) * 2;
#pragma unroll
    for (int t = 0; t < kD / 8; ++t)
      *reinterpret_cast<uint32_t*>(orow + t * 8) =
          pack_bf16x2(acc[t][2 * half] / l_safe, acc[t][2 * half + 1] / l_safe);
    if ((lane & 3) == 0) lse[(long long)bh * Lq + row] = log2f(fmaxf(l, 1e-30f)) * kLn2;
  }
}

}  // namespace

// q [B, N, Lq, 128], k [B, N, Lk, 128], v [B, Lk, N, 128] bf16 addressed by
// element strides (feature stride 1, rows 16 B aligned); o [B, Lq, N, 128]
// bf16 by strides; lse [B*N, Lq] fp32. qscale = fp32(scale * log2(e)).
// single != 0 is the K3 entry: lk must be <= FULL_K_MAX.
extern "C" int hyv_flash_fwd_bounded(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int B, int N, int Lq, int Lk,
    long long q_sb, long long q_sh, long long q_sl,
    long long k_sb, long long k_sh, long long k_sl,
    long long v_sb, long long v_sh, long long v_sl,
    long long o_sb, long long o_sh, long long o_sl,
    float qscale, int single, void* stream) {
  if (Lk <= 0 || (single && Lk > kFullKMax)) return (int)cudaErrorInvalidValue;
  if (B * N == 0 || Lq == 0) return 0;
  auto kernel = single ? flash_fwd_bounded_kernel<true> : flash_fwd_bounded_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Lq + kBlockM - 1) / kBlockM, B * N);
  kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)o, (float*)lse, N, Lq, Lk, Strides{q_sb, q_sh, q_sl},
      Strides{k_sb, k_sh, k_sl}, Strides{v_sb, v_sh, v_sl}, Strides{o_sb, o_sh, o_sl},
      qscale);
  return (int)cudaGetLastError();
}

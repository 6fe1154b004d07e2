// K10: fixed-max ("bounded") flash-attention forward with an int8 q k^T,
// head_dim 128, written for Hopper: TMA loads, int8 and bf16 wgmma
// products, warp specialisation and a persistent grid.
//
// Replaces hyvideo_prfl_tpu/ops/flash_attention.py
//   K10 _fwd_kernel_bounded_qk8 (:290; pallas_call at :713, via
//       _flash_fwd_qk8): the serving-only forward of the DiT self-attention
//       under WanConfig.quant_attn = "int8" (int8 serving and the int8 PRFL
//       rollout). It has no backward.
// q and k arrive as int8 with one symmetric scale per (batch, head), made
// outside the kernel (flash_attention.py _quantize_bn); c folds both scales,
// the softmax scale and log2(e) into one fp32 scalar per (batch, head).
// Per q row:
//
//   s32 = q8 . k8 (exact int32);  p = exp2(float(s32) * c)   (no running max)
//   l = sum p;  o = (sum bf16(p) v) / l;  lse = ln(l)
//
// Keys past Lk get p = 0 in the last tile; the TPU zero-padded them (they
// quantize to 0, so s32 = 0 and p = 1) and subtracted the pad count from l,
// which gives the same result.
//
// Bound on the H100: tensor-core math. At the 81-frame CFG-2 shape (24
// heads x 32,760 x 32,760 x 128) one call is 6.6e12 int8 ops for the score
// (1,979 TOPS peak) and 6.6e12 bf16 flop for p v (989 TFLOP/s peak), 10.0 ms
// together, against ~0.3 GB of q8/k8/v/o traffic. Beside the products, each
// 128 x 128 score tile takes 16,384 exp2 on the multi-function units, as in
// K1, whose design this is (flash_fwd.cu): a persistent grid over (batch *
// head, q tile of 128 rows), a producer warpgroup issuing TMA loads beside
// two consumer warpgroups of 64 q rows each (setmaxnreg 24 / 240), q in two
// buffers, k/v in two stages of 128 keys, and each consumer issuing the
// score of key tile j before p v of tile j - 1, so the softmax runs while
// that p v is in flight. What differs:
// * The score is wgmma m64n128k32 s32.s8.s8, both operands in shared memory
//   (for 8-bit types wgmma takes only K-major A and B; q8 and k8 are [.., L,
//   128] with the features contiguous, so both are K-major as they lie). An
//   int8 row of 128 features is one 128-byte swizzle span, so a q8 or k8
//   tile is one TMA box of 128 x 128 B (16 KB), and 4 k32 steps cover the
//   features where bf16 takes 8 k16 steps. q8 arrives quantized: no q' pass.
// * The int32 accumulator has the fp32 one's register layout; each score
//   becomes p in its own register: float(s32) (exact: |s32| <= 128 * 127^2
//   < 2^24), then __fmul_rn by c, as the plain version multiplies, then
//   exp2. The conversion is the I2F instruction. The exact alternative
//   without it (s32 + 0x4B400000 read as a float is 1.5 * 2^23 + s32, and
//   an FADD takes 1.5 * 2^23 away) measured ~10% slower over the whole
//   kernel on an H100 (scripts/ablate_flash_fwd_torch.py, variant
//   qk8_magic): one more instruction per score where the softmax, not the
//   tensor cores, sets the pace.
// * o is staged in a buffer of its own (a q8 tile is half an o tile) and
//   written by a TMA store; each warpgroup waits for its previous store to
//   have read its half before writing the next. q's buffer returns to the
//   producer once the tile's last score product has retired.
// * Shared memory: q8 2 x 16 KB, two stages of k8 (16 KB) and v (32 KB),
//   o 32 KB: 160 KB.
// lse is written as [B*N, Lq] fp32; the TPU kernel's 128-lane lse layout is
// a TPU layout artefact the port drops.
#include "sm90.cuh"
#include "tensor_core.cuh"

namespace {

using namespace hyv::sm90;

constexpr int kD = 128;
constexpr int kBlockM = 128;  // q rows per tile, 64 per consumer warpgroup
constexpr int kBlockN = 128;  // keys per stage
constexpr int kThreads = 384;
constexpr uint32_t kQ8Tile = kBlockM * kD;      // one q8 or k8 tile: 16 KB, one TMA box
constexpr uint32_t kVTile = kBlockN * kD * 2;   // one v or o tile: 32 KB
constexpr uint32_t kVHalf = kVTile / 2;         // one 64-feature box of a bf16 tile
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kQBufs = 2;   // q8 tile buffers
constexpr int kStages = 2;  // k8/v stages
// byte offsets in the 1024-aligned shared block; barriers (8 B each): q
// full/empty per buffer, k full/empty and v full/empty per stage
constexpr uint32_t kK = kQBufs * kQ8Tile;
constexpr uint32_t kV = kK + kStages * kQ8Tile;
constexpr uint32_t kO = kV + kStages * kVTile;
constexpr uint32_t kBar = kO + kVTile;
constexpr uint32_t kQFull = 0, kQEmpty = 16, kKFull = 32, kKEmpty = 32 + 8 * kStages,
                   kVFull = 32 + 16 * kStages, kVEmpty = 32 + 24 * kStages;
constexpr int kSmemBytes = kBar + 32 + 32 * kStages + 1024;  // + barriers + alignment

// float(s) of the int32 score held in s's bits
__device__ __forceinline__ float s32_to_f32(uint32_t s) { return __int2float_rn((int)s); }

__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_qk8_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap omap, const float* __restrict__ c,
                     float* __restrict__ lse, int N, int Lq, int Lk, int n_qt, int n_tiles) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar = base + kBar;
  const int nk = (Lk + kBlockN - 1) / kBlockN;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kQBufs; ++i) {
      mbar_init(bar + kQFull + 8 * i, 1);
      mbar_init(bar + kQEmpty + 8 * i, 8);  // one lane per consumer warp
    }
    for (int i = 0; i < kStages; ++i) {
      mbar_init(bar + kKFull + 8 * i, 1);
      mbar_init(bar + kKEmpty + 8 * i, 8);
      mbar_init(bar + kVFull + 8 * i, 1);
      mbar_init(bar + kVEmpty + 8 * i, 8);
    }
    fence_barrier_init();
    prefetch_map(&qmap);
    prefetch_map(&kmap);
    prefetch_map(&vmap);
    prefetch_map(&omap);
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every load ----
    reg_dealloc<24>();
    if (threadIdx.x != 0) return;
    int st = 0;
    uint32_t ph = 0;
    int it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
      const int bh = tile / n_qt, qt = tile - bh * n_qt, b = bh / N, h = bh - b * N;
      const int qb = it % kQBufs;
      mbar_wait(bar + kQEmpty + 8 * qb, ((it / kQBufs) & 1) ^ 1);
      mbar_expect_tx(bar + kQFull + 8 * qb, kQ8Tile);
      tma_load_4d(base + qb * kQ8Tile, &qmap, bar + kQFull + 8 * qb, 0, qt * kBlockM, h, b);
      for (int j = 0; j < nk; ++j) {
        const uint32_t sk = base + kK + st * kQ8Tile, sv = base + kV + st * kVTile;
        mbar_wait(bar + kKEmpty + 8 * st, ph ^ 1);
        mbar_expect_tx(bar + kKFull + 8 * st, kQ8Tile);
        tma_load_4d(sk, &kmap, bar + kKFull + 8 * st, 0, j * kBlockN, h, b);
        mbar_wait(bar + kVEmpty + 8 * st, ph ^ 1);
        mbar_expect_tx(bar + kVFull + 8 * st, kVTile);
        tma_load_4d(sv, &vmap, bar + kVFull + 8 * st, 0, j * kBlockN, h, b);
        tma_load_4d(sv + kVHalf, &vmap, bar + kVFull + 8 * st, 64, j * kBlockN, h, b);
        if (++st == kStages) {
          st = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroups 1 and 2, 64 q rows each ----
  reg_alloc<240>();
  const int cw = wg - 1;                          // consumer warpgroup, 0 or 1
  const int wt = threadIdx.x & 127;               // thread in the warpgroup
  const int lane = threadIdx.x & 31;
  const int r0 = cw * 64 + (wt >> 5) * 16 + (lane >> 2);  // this thread's rows: r0, r0 + 8
  const int key_lane = (lane & 3) * 2;            // its first key column in a group of 8
  const uint32_t so = base + kO;

  uint32_t s[64];                  // int32 scores, then the bits of p
  uint32_t pf[kBlockN / 16][4];    // bf16(p) as the A fragments of p v
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0u;
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk) pf[kk][0] = pf[kk][1] = pf[kk][2] = pf[kk][3] = 0u;
  int st = 0;
  uint32_t ph = 0;
  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
    const int bh = tile / n_qt, qt = tile - bh * n_qt, b = bh / N, h = bh - b * N;
    const int qb = it % kQBufs;
    const uint32_t sq = base + qb * kQ8Tile;
    const float cs = c[bh];
    mbar_wait(bar + kQFull + 8 * qb, (it / kQBufs) & 1);

    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    float lsum[2] = {0.f, 0.f};
    int prev = 0;
    // o += bf16(p) v for the key tile in stage `stage`
    auto issue_pv = [&](int stage) {
      const uint32_t sv = base + kV + stage * kVTile;
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk)
        wgmma_m64n128k16_rs<1>(acc, pf[kk], desc_sw128(sv + kk * 2048, kVHalf >> 4, 64), 1);
      wgmma_commit();
    };

    // Key tile j: issue s32 = q8 k8^T of tile j, then p v of tile j - 1;
    // the softmax of tile j starts once its scores are in, while that p v
    // is still in flight.
    for (int j = 0; j < nk; ++j) {
      const uint32_t sk = base + kK + st * kQ8Tile;
      mbar_wait(bar + kKFull + 8 * st, ph);
      if (j > 0) mbar_wait(bar + kVFull + 8 * prev, prev < st ? ph : ph ^ 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 32; ++kk)
        wgmma_m64n128k32_s8_ss(s, desc_sw128(sq + cw * 64 * 128 + kk * 32, 1, 64),
                               desc_sw128(sk + kk * 32, 1, 64), kk > 0);
      wgmma_commit();
      if (j > 0) issue_pv(prev);
      if (j > 0)
        wgmma_wait<1>();
      else
        wgmma_wait<0>();
      reg_fence(s);
      if (lane == 0) mbar_arrive(bar + kKEmpty + 8 * st);

      // p = exp2(float(s32) * c); keys at or past Lk (only in the last
      // tile) get p = 0. The sums run in independent chains (element i of
      // the fragment belongs to row half (i >> 1) & 1).
      float ls[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
      const bool tail = j * kBlockN + kBlockN > Lk;
      const int key0 = j * kBlockN + key_lane;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        float p = exp2_mufu(__fmul_rn(s32_to_f32(s[i]), cs));
        if (tail && key0 + (i >> 2) * 8 + (i & 1) >= Lk) p = 0.f;
        s[i] = __float_as_uint(p);
        ls[(i >> 1) & 1][(i >> 2) & 1] += p;
      }

      // p v of tile j - 1 has retired: its v stage returns to the producer,
      // and acc and the A fragments are free to write
      wgmma_wait<0>();
      reg_fence(acc);
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) reg_fence(pf[kk]);
      if (j > 0 && lane == 0) mbar_arrive(bar + kVEmpty + 8 * prev);
      lsum[0] += ls[0][0] + ls[0][1];
      lsum[1] += ls[1][0] + ls[1][1];
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pf[kk][i] = hyv::pack_bf16x2(__uint_as_float(s[8 * kk + 2 * i]),
                                       __uint_as_float(s[8 * kk + 2 * i + 1]));
      prev = st;
      if (++st == kStages) {
        st = 0;
        ph ^= 1;
      }
    }
    // every score product of the tile has retired: q8's buffer returns
    if (lane == 0) mbar_arrive(bar + kQEmpty + 8 * qb);
    // p v of the last key tile
    mbar_wait(bar + kVFull + 8 * prev, prev < st ? ph : ph ^ 1);
    wgmma_fence();
    issue_pv(prev);
    wgmma_wait<0>();
    reg_fence(acc);
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) reg_fence(pf[kk]);
    if (lane == 0) mbar_arrive(bar + kVEmpty + 8 * prev);

    // o = acc / l, bf16, staged in the o buffer (this warpgroup's 64 rows,
    // once its previous store has read them) in the swizzled layout of the
    // o map
    if (wt == 0) bulk_wait_read();
    named_bar_sync(1 + cw, 128);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      lsum[half] += __shfl_xor_sync(0xffffffffu, lsum[half], 1);
      lsum[half] += __shfl_xor_sync(0xffffffffu, lsum[half], 2);
      const float l = lsum[half];
      const float l_inv = 1.f / (l <= 0.f ? 1.f : l);  // one reciprocal per row, as K1
      const int row = r0 + 8 * half;
#pragma unroll
      for (int jd = 0; jd < kD / 8; ++jd) {
        const uint32_t addr = so + (jd >> 3) * kVHalf + hyv::swz128(row, jd & 7) + (lane & 3) * 4;
        const uint32_t val = hyv::pack_bf16x2(acc[4 * jd + 2 * half] * l_inv,
                                              acc[4 * jd + 2 * half + 1] * l_inv);
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(val) : "memory");
      }
      const int grow = qt * kBlockM + row;
      if ((lane & 3) == 0 && grow < Lq)
        lse[(long long)bh * Lq + grow] = log2f(fmaxf(l, 1e-30f)) * kLn2;
    }
    fence_proxy_async();
    named_bar_sync(1 + cw, 128);
    if (wt == 0) {
      const int row0 = qt * kBlockM + cw * 64;
      tma_store_4d(&omap, so + cw * 64 * 128, 0, row0, h, b);
      tma_store_4d(&omap, so + kVHalf + cw * 64 * 128, 64, row0, h, b);
      bulk_commit();
    }
  }
  if (wt == 0) bulk_wait();
}

}  // namespace

// q8 [B, N, Lq, 128], k8 [B, N, Lk, 128] int8 and v [B, Lk, N, 128] bf16
// addressed by element strides (feature stride 1, 16-byte aligned bases,
// every stride a multiple of 16 bytes); c [B*N] fp32; o [B, Lq, N, 128]
// bf16 by strides; lse [B*N, Lq] fp32.
extern "C" int hyv_flash_fwd_qk8(
    const void* q8, const void* k8, const void* v, const void* c, void* o, void* lse,
    int B, int N, int Lq, int Lk,
    long long q_sb, long long q_sh, long long q_sl,
    long long k_sb, long long k_sh, long long k_sl,
    long long v_sb, long long v_sh, long long v_sl,
    long long o_sb, long long o_sh, long long o_sl, void* stream) {
  if (Lk <= 0) return (int)cudaErrorInvalidValue;
  if (B * N == 0 || Lq == 0) return 0;
  CUtensorMap qmap, kmap, vmap, omap;
  cudaError_t err;
  if ((err = encode_i8_rows(&qmap, q8, Lq, N, B, q_sl, q_sh, q_sb, kBlockM)) ||
      (err = encode_i8_rows(&kmap, k8, Lk, N, B, k_sl, k_sh, k_sb, kBlockN)) ||
      (err = encode_bf16_rows(&vmap, v, Lk, N, B, v_sl, v_sh, v_sb, kBlockN)) ||
      (err = encode_bf16_rows(&omap, o, Lq, N, B, o_sl, o_sh, o_sb, kBlockM / 2)))
    return (int)err;
  err = cudaFuncSetAttribute(flash_fwd_qk8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const int n_qt = (Lq + kBlockM - 1) / kBlockM;
  const int n_tiles = n_qt * B * N;
  flash_fwd_qk8_kernel<<<n_tiles < sms ? n_tiles : sms, kThreads, kSmemBytes,
                         (cudaStream_t)stream>>>(qmap, kmap, vmap, omap, (const float*)c,
                                                 (float*)lse, N, Lq, Lk, n_qt, n_tiles);
  return (int)cudaGetLastError();
}

// the dynamic shared memory each K10 block asks for, for reports
extern "C" int hyv_flash_fwd_qk8_smem() { return kSmemBytes; }

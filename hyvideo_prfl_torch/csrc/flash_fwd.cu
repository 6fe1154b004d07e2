// K1, K2, K3 and K3s: the flash-attention forward, head_dim 128, in the
// fixed-max ("bounded") and the online-softmax ("shifted") form, streaming
// over any number of keys (K1, K2) or over the single K block of a short
// key range (K3, K3s), written for Hopper: TMA loads, wgmma products, warp
// specialisation and a persistent grid.
//
// Replaces hyvideo_prfl_tpu/ops/flash_attention.py
//   K1  _fwd_kernel_bounded (:250; pallas_call at :619, via _flash_fwd_impl):
//       the streaming bounded forward of the qk-normed DiT self-attention;
//   K2  _fwd_kernel         (:198; pallas_call at :619): the streaming
//       shifted forward, taken without qk-norm, under a key mask, and
//       everywhere under HYV_FLASH_BOUNDED=0;
//   K3  _fwd_kernel_single  (:331; pallas_call at :656, via _flash_fwd_single)
//       in its bounded form: the text cross-attention of the qk-normed DiT
//       (lk <= FULL_K_MAX = 3584);
//   K3s the same kernel with bounded=False (:351-356): its shifted form, on
//       the shifted route and under a key mask.
// Per (batch, head) and q row, with q' = bf16(fp32(q) * scale * log2(e)) --
// the TPU's rounding point, flash_attention.py:339 -- and s = q' . k:
//
//   bounded:  p = exp2(s)  (no running max);  l = sum p;
//             o = (sum bf16(p) v) / l;  lse = ln l
//   shifted:  a running row max m over 128-key tiles, p = exp2(s - m),
//             the earlier sums rescaled by exp2(m_old - m);
//             o = (sum bf16(p) v) / l;  lse = (m + log2 l) ln 2
//
// The bounded form is exact while the logits stay under ~70: the DiT's
// qk-RMSNorm keeps them there (flash_attention.py:76-101). Keys at or past
// lk are masked (p = 0) inside the last tile; the TPU instead padded K with
// zeros and removed their mass from l at the end, which gives the same
// result. lk is Lk, or for the shifted forms the optional int32 [B*N] valid
// length of each (batch, head); the key loop ends at the tile that holds
// the last valid key, so fully masked tiles cost nothing.
//
// Bound on the H100: tensor-core math. At the 81-frame CFG-2
// self-attention (B 2, N 12, lq = lk = 32,760) one K1/K2 call is 1.32e13
// flop against 0.8 GB of q/k/v/o traffic: 13.3 ms at the 989 TFLOP/s bf16
// peak. Beside the products, each 128 x 128 score tile takes 16,384 exp2 on
// the SM's multi-function units, about half the products' time, so the
// softmax must run while the tensor cores work. At the text
// cross-attention (K3/K3s, lk 512) the key loop is 4 tiles long, and the
// per-tile prologue (loading and scaling q) and epilogue (normalising and
// writing o) weigh as much as the loop. One template serves all four; the
// design:
//
// * Persistent grid: min(#SMs, tiles) blocks, tiles = ceil(Lq/128) x B*N
//   walked with stride gridDim.x in (batch*head, q-tile) order, so the
//   blocks in flight share one head's k/v in L2 (16.8 MB at 32,760 keys).
// * Warp specialisation, 384 threads: warpgroup 0 is the producer (24
//   registers after setmaxnreg; one thread issues every TMA load), and
//   warpgroups 1 and 2 are consumers (240 registers) owning 64 of the
//   tile's 128 q rows each: 128 x 24 + 256 x 240 = 64,512 of 65,536.
// * TMA with mbarriers; separate full/empty barriers for k and v so q'k^T
//   starts before v has arrived. Rank-4 maps over (D, L, N, B) built from
//   the wrapper's element strides read head-major q/k, token-major views
//   and v in [B, L, N, D] alike; rows past L arrive as zeros.
//   q in two buffers, so the next tile's q lands during this tile's loop,
//   and k/v in two stages of 128 keys (192 KB), in all four forms (one q
//   buffer and three stages, 224 KB, measured no faster for the streaming
//   forms: scripts/ablate_flash_fwd_torch.py, variant "three_stages").
// * Both products on wgmma m64n128k16. Each consumer warp forms q' for its
//   16 q rows once per tile, in place in the q buffer (ldmatrix, scale,
//   stmatrix, then a fence to the async proxy), and q'k^T reads its A
//   operand from there through a descriptor (shared x shared): no A
//   register, which ptxas would not keep across the key loop. k is the B
//   operand as it lies (K-major); p leaves the fp32 score accumulator as
//   bf16 pairs that are already the register A fragment of p v; v is read
//   [keys, D] with B's transpose bit, never transposed in memory.
// * Each consumer warpgroup issues q'k^T of key tile j and then p v of
//   tile j - 1, and waits for the first alone: the softmax of tile j (exp2
//   and the sums; the shifted forms' row max) runs while that p v is
//   still in flight, and beside the other warpgroup's products, which the
//   tensor cores interleave as the two issue them (FlashAttention-3's
//   intra-warpgroup overlap, Shah et al. 2024, section 3.2; its
//   ping-pong turns between the warpgroups, section 3.1, measured slower
//   here: the ablation's variant "turns"). Only once the p v has retired
//   are the accumulator (rescaled by the shifted forms) and the A
//   fragments of the next p v written.
// * Epilogue: o = acc * (1 / l), one reciprocal per row, is staged, bf16,
//   in the tile's own q buffer (each consumer warpgroup has read its q
//   rows by then) and written by a TMA store, which clips rows past Lq;
//   the buffer returns to the producer at the next tile's start, once the
//   store has read it.
// The four forms are the <kShifted, kStreaming> instances of one template.
// kStreaming changes no code (the host check alone holds the single-block
// forms to lk <= FULL_K_MAX); it names the instances apart in profiles. The
// kShifted branches are compile-time, so the bounded instances carry none
// of the shifted forms' work or registers.
#include "sm90.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int kD = 128;
constexpr int kBlockM = 128;  // q rows per tile, 64 per consumer warpgroup
constexpr int kBlockN = 128;  // keys per stage
constexpr int kThreads = 384;
constexpr int kTileBytes = kBlockM * kD * 2;  // one q, k or v tile: 32 KB
constexpr int kHalf = kTileBytes / 2;         // one 64-feature box of a tile
constexpr int kFullKMax = 3584;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kQBufs = 2;   // q tile buffers
constexpr int kStages = 2;  // k/v stages
// byte offsets in the 1024-aligned shared block; barriers (8 B each): q
// full/empty per buffer, k full/empty and v full/empty per stage
constexpr uint32_t kK = kQBufs * kTileBytes;
constexpr uint32_t kV = kK + kStages * kTileBytes;
constexpr uint32_t kBar = kV + kStages * kTileBytes;
constexpr uint32_t kQFull = 0, kQEmpty = 16, kKFull = 32, kKEmpty = 56, kVFull = 80,
                   kVEmpty = 104;
constexpr int kSmemBytes = kBar + 128 + 1024;  // + barriers + alignment

using namespace hyv::sm90;

struct Tile {
  int b, h, qt, bh, nk, lk;
};

// 2^x on the multi-function unit alone (exp2f adds a rescue of denormal
// results, which the sums cannot see); 2^-inf = 0
__device__ __forceinline__ float exp2_mufu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ Tile decode(int tile, int n_qt, int N, int Lk, const int* kvalid) {
  Tile t;
  t.bh = tile / n_qt;
  t.qt = tile - t.bh * n_qt;
  t.b = t.bh / N;
  t.h = t.bh - t.b * N;
  t.lk = kvalid != nullptr ? min(kvalid[t.bh], Lk) : Lk;
  t.nk = (t.lk + kBlockN - 1) / kBlockN;
  return t;
}

template <bool kShifted, bool kStreaming>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap omap,
                 float* __restrict__ lse, const int* __restrict__ kvalid, int N, int Lq, int Lk,
                 int n_qt, int n_tiles, float qscale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar = base + kBar;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kQBufs; ++i) {
      mbar_init(bar + kQFull + 8 * i, 1);
      mbar_init(bar + kQEmpty + 8 * i, 2);  // one store thread per consumer warpgroup
    }
    for (int i = 0; i < kStages; ++i) {
      mbar_init(bar + kKFull + 8 * i, 1);
      mbar_init(bar + kKEmpty + 8 * i, 8);  // one lane per consumer warp
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
      const Tile t = decode(tile, n_qt, N, Lk, kvalid);
      const int qb = it % kQBufs;
      const uint32_t sq = base + qb * kTileBytes;
      mbar_wait(bar + kQEmpty + 8 * qb, ((it / kQBufs) & 1) ^ 1);
      mbar_expect_tx(bar + kQFull + 8 * qb, kTileBytes);
      tma_load_4d(sq, &qmap, bar + kQFull + 8 * qb, 0, t.qt * kBlockM, t.h, t.b);
      tma_load_4d(sq + kHalf, &qmap, bar + kQFull + 8 * qb, 64, t.qt * kBlockM, t.h, t.b);
      for (int j = 0; j < t.nk; ++j) {
        const uint32_t sk = base + kK + st * kTileBytes, sv = base + kV + st * kTileBytes;
        mbar_wait(bar + kKEmpty + 8 * st, ph ^ 1);
        mbar_expect_tx(bar + kKFull + 8 * st, kTileBytes);
        tma_load_4d(sk, &kmap, bar + kKFull + 8 * st, 0, j * kBlockN, t.h, t.b);
        tma_load_4d(sk + kHalf, &kmap, bar + kKFull + 8 * st, 64, j * kBlockN, t.h, t.b);
        mbar_wait(bar + kVEmpty + 8 * st, ph ^ 1);
        mbar_expect_tx(bar + kVFull + 8 * st, kTileBytes);
        tma_load_4d(sv, &vmap, bar + kVFull + 8 * st, 0, j * kBlockN, t.h, t.b);
        tma_load_4d(sv + kHalf, &vmap, bar + kVFull + 8 * st, 64, j * kBlockN, t.h, t.b);
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
  const int wrow = cw * 64 + (wt >> 5) * 16;      // the warp's first row in the tile
  const int r0 = wrow + (lane >> 2);              // this thread's rows: r0 and r0 + 8
  const int key_lane = (lane & 3) * 2;            // its first key column in a group of 8
  // the ldmatrix address of this lane for the A fragment of q' columns
  // 16kk..16kk+15 (16 B chunk 2kk + lane/16 of the 256 B row)
  auto q_frag = [&](uint32_t sq, int kk) {
    const int chunk = kk * 2 + (lane >> 4);
    return sq + (chunk >> 3) * kHalf + hyv::swz128(wrow + (lane & 15), chunk & 7);
  };
  const float neg_inf = __int_as_float(0xff800000);

  float s[64];                     // scores, then p
  uint32_t pf[kBlockN / 16][4];     // bf16(p) as the A fragments of p v
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk) pf[kk][0] = pf[kk][1] = pf[kk][2] = pf[kk][3] = 0u;
  int st = 0;
  uint32_t ph = 0;
  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
    const Tile t = decode(tile, n_qt, N, Lk, kvalid);
    const int qb = it % kQBufs;
    const uint32_t sq = base + qb * kTileBytes;

    // q' = bf16(q * scale * log2e), written back in place over the warp's
    // own 16 rows
    mbar_wait(bar + kQFull + 8 * qb, (it / kQBufs) & 1);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      uint32_t r[4];
      hyv::ldsm_x4(q_frag(sq, kk), r[0], r[1], r[2], r[3]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&r[i]));
        r[i] = hyv::pack_bf16x2(__fmul_rn(f.x, qscale), __fmul_rn(f.y, qscale));
      }
      stsm_x4(q_frag(sq, kk), r[0], r[1], r[2], r[3]);
    }
    // wgmma reads the warpgroup's 64 rows of q' through the async proxy
    fence_proxy_async();
    named_bar_sync(1 + cw, 128);
    // the previous tile's o store has read its q buffer by now; hand it back
    if (it > 0 && wt == 0) {
      bulk_wait_read();
      mbar_arrive(bar + kQEmpty + 8 * (qb ^ 1));
    }

    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    float lsum[2] = {0.f, 0.f};
    float m_run[2] = {neg_inf, neg_inf};  // shifted forms: running row max
    int prev = 0;
    // o += bf16(p) v for the key tile in stage `stage`
    auto issue_pv = [&](int stage) {
      const uint32_t sv = base + kV + stage * kTileBytes;
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk)
        wgmma_m64n128k16_rs<1>(acc, pf[kk], desc_sw128(sv + kk * 2048, kHalf >> 4, 64), 1);
      wgmma_commit();
    };

    // Key tile j: issue s = q' k^T of tile j, then p v of tile j - 1; the
    // softmax of tile j starts once its scores are in, while that p v is
    // still in flight.
    for (int j = 0; j < t.nk; ++j) {
      const uint32_t sk = base + kK + st * kTileBytes;
      mbar_wait(bar + kKFull + 8 * st, ph);
      if (j > 0) mbar_wait(bar + kVFull + 8 * prev, prev < st ? ph : ph ^ 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        wgmma_m64n128k16_ss(
            s, desc_sw128(sq + (kk >> 2) * kHalf + cw * 64 * 128 + (kk & 3) * 32, 1, 64),
            desc_sw128(sk + (kk >> 2) * kHalf + (kk & 3) * 32, 1, 64), kk > 0);
      wgmma_commit();
      if (j > 0) issue_pv(prev);
      if (j > 0)
        wgmma_wait<1>();
      else
        wgmma_wait<0>();
      reg_fence(s);
      if (lane == 0) mbar_arrive(bar + kKEmpty + 8 * st);

      // keys at or past lk (only in the last tile) -> -inf, so p = 0
      if (j * kBlockN + kBlockN > t.lk) {
        const int key0 = j * kBlockN + key_lane;
#pragma unroll
        for (int i = 0; i < 64; ++i)
          if (key0 + (i >> 2) * 8 + (i & 1) >= t.lk) s[i] = neg_inf;
      }
      // Row maxima and sums run in independent chains (element i of the
      // fragment belongs to row half (i >> 1) & 1), so one warp's softmax
      // does not wait on the latency of a 32-long dependent chain.
      float ls[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
      float corr[2] = {1.f, 1.f};
      if constexpr (kShifted) {
        // the tile's row max over the quad's 128 keys
        float mx4[2][4];
#pragma unroll
        for (int i = 0; i < 8; ++i) mx4[i >> 2][i & 3] = m_run[i >> 2];
#pragma unroll
        for (int i = 0; i < 64; ++i)
          mx4[(i >> 1) & 1][(i >> 2) & 3] = fmaxf(mx4[(i >> 1) & 1][(i >> 2) & 3], s[i]);
        float mx[2];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          mx[half] = fmaxf(fmaxf(mx4[half][0], mx4[half][1]), fmaxf(mx4[half][2], mx4[half][3]));
          mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
          mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
        }
        // what the earlier tiles summed is rescaled to the new max (0 on
        // the first tile, where m_run is -inf)
        corr[0] = exp2_mufu(m_run[0] - mx[0]);
        corr[1] = exp2_mufu(m_run[1] - mx[1]);
        m_run[0] = mx[0];
        m_run[1] = mx[1];
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const float p = exp2_mufu(s[i] - m_run[(i >> 1) & 1]);  // masked: exp2(-inf) = 0
          s[i] = p;
          ls[(i >> 1) & 1][(i >> 2) & 1] += p;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const float p = exp2_mufu(s[i]);  // masked: exp2(-inf) = 0
          s[i] = p;
          ls[(i >> 1) & 1][(i >> 2) & 1] += p;
        }
      }

      // p v of tile j - 1 has retired: its v stage returns to the producer,
      // and acc and the A fragments are free to write
      wgmma_wait<0>();
      reg_fence(acc);
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) reg_fence(pf[kk]);
      if (j > 0 && lane == 0) mbar_arrive(bar + kVEmpty + 8 * prev);
      if constexpr (kShifted) {
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] *= corr[(i >> 1) & 1];
      }
      lsum[0] = lsum[0] * corr[0] + (ls[0][0] + ls[0][1]);
      lsum[1] = lsum[1] * corr[1] + (ls[1][0] + ls[1][1]);
      // bf16(p): the score fragments of keys 16kk..16kk+15 are the A operand
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pf[kk][i] = hyv::pack_bf16x2(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
      prev = st;
      if (++st == kStages) {
        st = 0;
        ph ^= 1;
      }
    }
    // p v of the last key tile
    if (t.nk > 0) {
      mbar_wait(bar + kVFull + 8 * prev, prev < st ? ph : ph ^ 1);
      wgmma_fence();
      issue_pv(prev);
      wgmma_wait<0>();
      reg_fence(acc);
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) reg_fence(pf[kk]);
      if (lane == 0) mbar_arrive(bar + kVEmpty + 8 * prev);
    }

    // o = acc / l, bf16, staged in this tile's q buffer (the warpgroup's own
    // rows, whose last product has retired) in the swizzled layout of the o
    // map
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      lsum[half] += __shfl_xor_sync(0xffffffffu, lsum[half], 1);
      lsum[half] += __shfl_xor_sync(0xffffffffu, lsum[half], 2);
      const float l = lsum[half];
      // one reciprocal per row: on an H100, 64 IEEE divisions per thread
      // cost ~20% of the single-block kernel's time at lk 512, and the
      // product lies within an fp32 ulp of the quotient
      const float l_inv = 1.f / (l <= 0.f ? 1.f : l);
      const int row = r0 + 8 * half;
#pragma unroll
      for (int jd = 0; jd < kD / 8; ++jd) {
        const uint32_t addr = sq + (jd >> 3) * kHalf + hyv::swz128(row, jd & 7) + (lane & 3) * 4;
        const uint32_t val = hyv::pack_bf16x2(acc[4 * jd + 2 * half] * l_inv,
                                              acc[4 * jd + 2 * half + 1] * l_inv);
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(val) : "memory");
      }
      const int grow = t.qt * kBlockM + row;
      if ((lane & 3) == 0 && grow < Lq) {
        const float log2l = log2f(fmaxf(l, 1e-30f));
        lse[(long long)t.bh * Lq + grow] = (kShifted ? m_run[half] + log2l : log2l) * kLn2;
      }
    }
    fence_proxy_async();
    named_bar_sync(1 + cw, 128);
    if (wt == 0) {
      const int row0 = t.qt * kBlockM + cw * 64;
      tma_store_4d(&omap, sq + cw * 64 * 128, 0, row0, t.h, t.b);
      tma_store_4d(&omap, sq + kHalf + cw * 64 * 128, 64, row0, t.h, t.b);
      bulk_commit();
    }
  }
  if (wt == 0) bulk_wait();
}

template <bool kShifted, bool kStreaming>
cudaError_t launch(const CUtensorMap& qmap, const CUtensorMap& kmap, const CUtensorMap& vmap,
                   const CUtensorMap& omap, float* lse, const int* valid, int N, int Lq, int Lk,
                   int n_qt, int n_tiles, float qscale, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<kShifted, kStreaming>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemBytes);
  if (err != cudaSuccess) return err;
  const int sms = hyv::sm90::sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const int grid = n_tiles < sms ? n_tiles : sms;
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(qmap, kmap, vmap, omap, lse, valid, N, Lq, Lk,
                                                 n_qt, n_tiles, qscale);
  return cudaGetLastError();
}

}  // namespace

// q [B, N, Lq, 128], k [B, N, Lk, 128], v [B, Lk, N, 128] bf16 addressed by
// element strides (feature stride 1, 16-byte aligned bases, every stride a
// multiple of 8 elements; q and k may be token-major views); o [B, Lq, N,
// 128] bf16 by strides; lse [B*N, Lq] fp32. qscale = fp32(scale *
// log2(e)). single != 0 takes the single-block forms K3/K3s (lk <=
// FULL_K_MAX), single == 0 the streaming forms K1/K2. shifted != 0 takes
// the online-softmax form (K2, K3s), which alone takes valid: null, or
// int32 [B*N] key counts (>= 1).
extern "C" int hyv_flash_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, const void* valid,
    int B, int N, int Lq, int Lk,
    long long q_sb, long long q_sh, long long q_sl,
    long long k_sb, long long k_sh, long long k_sl,
    long long v_sb, long long v_sh, long long v_sl,
    long long o_sb, long long o_sh, long long o_sl,
    float qscale, int single, int shifted, void* stream) {
  if (Lk <= 0 || (single && Lk > kFullKMax)) return (int)cudaErrorInvalidValue;
  if (valid != nullptr && !shifted) return (int)cudaErrorInvalidValue;
  if (B * N == 0 || Lq == 0) return 0;
  CUtensorMap qmap, kmap, vmap, omap;
  cudaError_t err;
  using hyv::sm90::encode_bf16_rows;
  if ((err = encode_bf16_rows(&qmap, q, Lq, N, B, q_sl, q_sh, q_sb, kBlockM)) ||
      (err = encode_bf16_rows(&kmap, k, Lk, N, B, k_sl, k_sh, k_sb, kBlockN)) ||
      (err = encode_bf16_rows(&vmap, v, Lk, N, B, v_sl, v_sh, v_sb, kBlockN)) ||
      (err = encode_bf16_rows(&omap, o, Lq, N, B, o_sl, o_sh, o_sb, kBlockM / 2)))
    return (int)err;
  const int n_qt = (Lq + kBlockM - 1) / kBlockM;
  const int n_tiles = n_qt * B * N;
  const auto form = single ? (shifted ? launch<true, false> : launch<false, false>)
                           : (shifted ? launch<true, true> : launch<false, true>);
  return (int)form(qmap, kmap, vmap, omap, (float*)lse, (const int*)valid, N, Lq, Lk, n_qt,
                   n_tiles, qscale, (cudaStream_t)stream);
}

// the dynamic shared memory each block of the four forms asks for, for
// reports
extern "C" int hyv_flash_fwd_smem() { return kSmemBytes; }

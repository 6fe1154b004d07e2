// K3 and K3s: the single-K-block flash-attention forward, head_dim 128,
// in the fixed-max ("bounded") and the online-softmax ("shifted") form,
// written for Hopper: TMA loads, wgmma products, warp specialisation and a
// persistent grid.
//
// Replaces hyvideo_prfl_tpu/ops/flash_attention.py
//   K3  _fwd_kernel_single (:331; pallas_call at :656, via _flash_fwd_single)
//       in its bounded form: the text cross-attention of the qk-normed DiT
//       (lk <= FULL_K_MAX = 3584);
//   K3s the same kernel with bounded=False (:351-356): its shifted form, on
//       the shifted route and under a key mask.
// It computes what flash_fwd.cu's streaming forms compute (see there), per
// (batch, head) and q row, with q' = bf16(q * scale * log2(e)), s = q' . k:
//
//   bounded:  p = exp2(s);  l = sum p;  o = (sum bf16(p) v) / l;  lse = ln l
//   shifted:  a running row max m over 128-key tiles, p = exp2(s - m),
//             the earlier sums rescaled by exp2(m_old - m);
//             lse = (m + log2 l) ln 2
//
// with keys at or past lk masked (p = 0); lk is Lk, or for K3s the optional
// int32 [B*N] valid length of each (batch, head), and the key loop ends at
// the tile that holds the last valid key.
//
// Bound on the H100: tensor-core math. At the 81-frame CFG-2 text
// cross-attention (B 2, N 12, lq 32,760, lk 512) one call is 2.06e11 flop
// against 0.4 GB of q/o traffic and 6 MB of k/v: 0.208 ms at the 989
// TFLOP/s bf16 peak. The key loop is short (4 tiles of 128 keys), so the
// per-tile prologue (loading and scaling q) and epilogue (normalising and
// writing o) weigh as much as the loop; the design hides them:
//
// * Persistent grid: min(#SMs, tiles) blocks, tiles = ceil(Lq/128) x B*N
//   walked with stride gridDim.x in (batch*head, q-tile) order, so the
//   blocks in flight share one head's k/v in L2.
// * Warp specialisation, 384 threads: warpgroup 0 is the producer (24
//   registers after setmaxnreg; one thread issues every TMA load), and
//   warpgroups 1 and 2 are consumers (240 registers) owning 64 of the
//   tile's 128 q rows each: 128 x 24 + 256 x 240 = 64,512 of 65,536.
// * TMA with mbarriers: q tiles in two buffers, so the next tile's q lands
//   during this tile's loop; k and v in two stages of 128 keys each, with
//   separate full/empty barriers for k and v so q'k^T starts before v has
//   arrived. Rank-4 maps over (D, L, N, B) built from the wrapper's element
//   strides read head-major q/k, token-major views and v in [B, L, N, D]
//   alike; rows past L arrive as zeros.
// * Both products on wgmma m64n128k16 with A in registers. Each consumer
//   warp forms q' = bf16(fp32(q) * qscale) for its 16 q rows once per tile
//   -- the TPU's rounding point, flash_attention.py:339 -- in place in the
//   q buffer (ldmatrix, scale, stmatrix), and reads its A fragments from
//   there for each key tile. k is the B operand as it lies (K-major); p
//   leaves the fp32 score accumulator as bf16 pairs that are already the A
//   fragment of p v; v is read [keys, D] with B's transpose bit, never
//   transposed in memory.
// * The p v product of one key tile is left in flight while the next
//   tile's q'k^T is issued behind it; one wait then retires both. The two
//   consumer warpgroups take turns issuing these pairs (named barriers),
//   so one's softmax overlaps the other's products.
// * Epilogue: o = acc * (1 / l) is staged, bf16, in the tile's own q buffer
//   (each consumer warpgroup has read its q rows by then) and written by a
//   TMA store, which clips rows past Lq; the buffer returns to the producer
//   once the store has read it, checked at the next tile's start.
// * Shared memory: q 2 x 32 KB, k 2 x 32 KB, v 2 x 32 KB = 192 KB.
#include "sm90.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int kD = 128;
constexpr int kBlockM = 128;  // q rows per tile, 64 per consumer warpgroup
constexpr int kBlockN = 128;  // keys per stage
constexpr int kThreads = 384;
constexpr int kTileBytes = kBlockM * kD * 2;  // one q, k or v tile: 32 KB
constexpr int kHalf = kTileBytes / 2;         // one 64-feature box of a tile
constexpr int kSmemBytes = 6 * kTileBytes + 128 + 1024;  // + barriers + alignment
constexpr int kFullKMax = 3584;
constexpr float kLn2 = 0.6931471805599453f;

using namespace hyv::sm90;

// byte offsets in the 1024-aligned shared block
constexpr uint32_t kQ = 0, kK = 2 * kTileBytes, kV = 4 * kTileBytes, kBar = 6 * kTileBytes;
// barriers, 8 B each: q full/empty, k full/empty, v full/empty, two of each
constexpr uint32_t kQFull = 0, kQEmpty = 16, kKFull = 32, kKEmpty = 48, kVFull = 64,
                   kVEmpty = 80;

struct Tile {
  int b, h, qt, bh, nk, lk;
};

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

template <bool kShifted>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_single_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const __grid_constant__ CUtensorMap omap, float* __restrict__ lse,
                        const int* __restrict__ kvalid, int N, int Lq, int Lk, int n_qt,
                        int n_tiles, float qscale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar = base + kBar;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(bar + kQFull + 8 * i, 1);
      mbar_init(bar + kQEmpty + 8 * i, 2);  // one store thread per consumer warpgroup
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
      const int qb = it & 1;
      const uint32_t sq = base + kQ + qb * kTileBytes;
      mbar_wait(bar + kQEmpty + 8 * qb, ((it >> 1) & 1) ^ 1);
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
        if (++st == 2) {
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
  // Turns on the tensor cores, alternating between the two consumer
  // warpgroups: each issues its products (p v of one key tile and q'k^T of
  // the next) between waiting on its own named barrier (3 + cw) and
  // arriving at the other's, so one warpgroup's softmax runs while the
  // other's products do. Warpgroup 0 takes the first turn.
  auto turn_begin = [&]() { named_bar_sync(3 + cw, 256); };
  auto turn_end = [&]() { named_bar_arrive(4 - cw, 256); };
  if (cw == 0) named_bar_arrive(3, 256);
  auto load_q = [&](uint32_t sq, uint32_t (&qf)[kD / 16][4]) {
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      hyv::ldsm_x4(q_frag(sq, kk), qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3]);
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
    const int qb = it & 1;
    const uint32_t sq = base + kQ + qb * kTileBytes;

    // q' = bf16(q * scale * log2e), written back in place over the warp's
    // own 16 rows; each key tile reads its A fragments from there
    mbar_wait(bar + kQFull + 8 * qb, (it >> 1) & 1);
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
    __syncwarp();
    // the previous tile's o store has read its buffer: hand it back
    if (it > 0 && wt == 0) {
      bulk_wait_read();
      mbar_arrive(bar + kQEmpty + 8 * (qb ^ 1));
    }

    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    float lsum[2] = {0.f, 0.f};
    float m_run[2] = {neg_inf, neg_inf};  // shifted form: running row max
    int prev = 0;
    // The A fragments of q'k^T are read from shared memory afresh for each
    // key tile, and before the previous tile's p v is issued: ptxas keeps
    // no wgmma A register across a loop (it reuses it), and serialises the
    // pipeline if other instructions write one while a wgmma is in flight.
    uint32_t qf[kD / 16][4];
    load_q(sq, qf);

    for (int j = 0; j < t.nk; ++j) {
      const uint32_t sk = base + kK + st * kTileBytes, sv = base + kV + st * kTileBytes;
      // s = q' k^T (64 rows x 128 keys per warpgroup); this wait also
      // retires the previous tile's p v
      mbar_wait(bar + kKFull + 8 * st, ph);
      if (j == 0) turn_begin();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        wgmma_m64n128k16_rs<0>(s, qf[kk],
                               desc_sw128(sk + (kk >> 2) * kHalf + (kk & 3) * 32, 1, 64),
                               kk > 0);
      wgmma_commit();
      turn_end();
      wgmma_wait<0>();
      reg_fence(s);
      reg_fence(acc);
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) reg_fence(pf[kk]);
      if (lane == 0) {
        mbar_arrive(bar + kKEmpty + 8 * st);
        if (j > 0) mbar_arrive(bar + kVEmpty + 8 * prev);
      }

      const int key0 = j * kBlockN + key_lane;
      const bool tail = j * kBlockN + kBlockN > t.lk;
      if constexpr (kShifted) {
        // masked keys -> -inf; the tile's row max over the quad's 128 keys
        float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          if (tail && key0 + (i >> 2) * 8 + (i & 1) >= t.lk) s[i] = neg_inf;
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
          mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
          // rescale what the earlier tiles summed to the new max (0 on the
          // first tile, where m_run is -inf)
          const float corr = exp2f(m_run[half] - mx[half]);
          m_run[half] = mx[half];
          lsum[half] *= corr;
#pragma unroll
          for (int i = 0; i < 64; ++i)
            if (((i >> 1) & 1) == half) acc[i] *= corr;
        }
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const float p = exp2f(s[i] - m_run[(i >> 1) & 1]);  // masked: exp2(-inf) = 0
          s[i] = p;
          lsum[(i >> 1) & 1] += p;
        }
      } else {
        // p = exp2(s); keys at or past lk (only in the last tile) get p = 0
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          float p = exp2f(s[i]);
          if (tail && key0 + (i >> 2) * 8 + (i & 1) >= t.lk) p = 0.f;
          s[i] = p;
          lsum[(i >> 1) & 1] += p;
        }
      }
      // bf16(p): the score fragments of keys 16kk..16kk+15 are the A operand
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pf[kk][i] = hyv::pack_bf16x2(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);

      load_q(sq, qf);  // for the next key tile

      // o += bf16(p) v, left in flight
      mbar_wait(bar + kVFull + 8 * st, ph);
      turn_begin();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk)
        wgmma_m64n128k16_rs<1>(acc, pf[kk], desc_sw128(sv + kk * 2048, kHalf >> 4, 64), 1);
      wgmma_commit();
      if (j == t.nk - 1) turn_end();
      prev = st;
      if (++st == 2) {
        st = 0;
        ph ^= 1;
      }
    }
    wgmma_wait<0>();
    reg_fence(acc);
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) reg_fence(pf[kk]);
    if (t.nk > 0 && lane == 0) mbar_arrive(bar + kVEmpty + 8 * prev);

    // o = acc / l, bf16, staged in this tile's q buffer (the warpgroup's own
    // rows, read into registers above) in the swizzled layout of the o map
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      lsum[half] += __shfl_xor_sync(0xffffffffu, lsum[half], 1);
      lsum[half] += __shfl_xor_sync(0xffffffffu, lsum[half], 2);
      const float l = lsum[half];
      // one reciprocal per row: on an H100, 64 IEEE divisions per thread
      // cost ~20% of the kernel's time at lk 512, and the product lies
      // within an fp32 ulp of the quotient
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

int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0)
    cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  return counts[dev];
}

}  // namespace

namespace hyv {

// The K3/K3s launch behind hyv_flash_fwd (flash_fwd.cu) when single != 0:
// the same pointers, sizes and element strides (q/k as (batch, head, row),
// v/o likewise), lse [B*N, Lq] fp32, valid null or int32 [B*N].
int flash_fwd_single(const void* q, const void* k, const void* v, void* o, void* lse,
                     const void* valid, int B, int N, int Lq, int Lk, long long q_sb,
                     long long q_sh, long long q_sl, long long k_sb, long long k_sh,
                     long long k_sl, long long v_sb, long long v_sh, long long v_sl,
                     long long o_sb, long long o_sh, long long o_sl, float qscale, int shifted,
                     void* stream) {
  if (Lk <= 0 || Lk > kFullKMax) return (int)cudaErrorInvalidValue;
  if (B * N == 0 || Lq == 0) return 0;
  CUtensorMap qmap, kmap, vmap, omap;
  cudaError_t err;
  if ((err = sm90::encode_bf16_rows(&qmap, q, Lq, N, B, q_sl, q_sh, q_sb, kBlockM)) ||
      (err = sm90::encode_bf16_rows(&kmap, k, Lk, N, B, k_sl, k_sh, k_sb, kBlockN)) ||
      (err = sm90::encode_bf16_rows(&vmap, v, Lk, N, B, v_sl, v_sh, v_sb, kBlockN)) ||
      (err = sm90::encode_bf16_rows(&omap, o, Lq, N, B, o_sl, o_sh, o_sb, kBlockM / 2)))
    return (int)err;
  auto kernel = shifted ? flash_fwd_single_kernel<true> : flash_fwd_single_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (Lq + kBlockM - 1) / kBlockM;
  const int n_tiles = n_qt * B * N;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const int grid = n_tiles < sms ? n_tiles : sms;
  kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      qmap, kmap, vmap, omap, (float*)lse, (const int*)valid, N, Lq, Lk, n_qt, n_tiles, qscale);
  return (int)cudaGetLastError();
}

}  // namespace hyv

// the dynamic shared memory each K3/K3s block asks for, for reports
extern "C" int hyv_flash_fwd_single_smem() { return kSmemBytes; }

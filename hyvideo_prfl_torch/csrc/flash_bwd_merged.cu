// K4: the merged flash-attention backward, head_dim 128, written for
// Hopper: TMA loads, wgmma products, warp specialisation, and dq added by
// TMA reductions.
//
// Replaces hyvideo_prfl_tpu/ops/flash_attention.py _dqkv_kernel (:453;
// pallas_call at :890 in _flash_bwd_merged :849): the merged backward, five
// products per (q tile, key tile) cell. The route to it is the JAX rule
// (flash_attention.py:763), taken by the Python wrapper; the split backward
// K5 is in flash_bwd.cu. Per (batch, head), from the saved lse (the
// backward recomputes p, so the bounded and the shifted forward share it):
//
//   q' = bf16(q * scale * log2e),  p = exp2(q' k^T - lse * log2e)
//   dv += bf16(p)^T dO,   dp = dO v^T,   ds = p * (dp - delta)
//   dk += bf16(ds)^T bf16(q * scale),   dq += bf16(ds) bf16(k * scale)
//
// with delta = rowsum(dO * o) over the bf16 o the forward wrote. Keys at or
// past lk contribute nothing (p = 0), where lk is Lk or the optional int32
// [B*N] valid length of the head (the shifted forward's key mask), so
// masked keys get exactly zero gradients; a block whose keys are all masked
// writes zeros and stops.
//
// Bound on the H100: tensor-core math. At the 81-frame self-attention
// shape (12 heads x 32,760 x 32,760 x 128) one call is 1.65e13 flop (five
// products) against well under 1 GB of traffic: 16.7 ms at the 989 TFLOP/s
// bf16 peak. The text cross-attention (lk 512) is the same work per key
// over only 4 key tiles a head.
//
// Design (FlashAttention-3's backward shape, simplified):
// * A prologue kernel forms, once per call, q' and q_s = bf16(q * scale)
//   in a [2, B*N, Lq, 128] scratch, and per 64-row q tile the row
//   statistics lse * log2e (+inf past Lq, so p = 0 there) and delta (a
//   warp's sum of dO * o) in a [B*N, n_qt, 2, 64] scratch, so the main
//   kernel's tiles arrive ready for the tensor cores.
// * Tiles and roles. A block owns 128 keys of one (batch, head), keeps
//   their dk and dv in fp32 registers and sweeps q tiles of 64 rows; 384
//   threads: warpgroup 0 is the producer (24 registers after setmaxnreg; one
//   thread issues every load), warpgroups 1 and 2 are consumers (240
//   registers) owning 64 keys each. k and v arrive once by TMA; the q',
//   q_s and dO tiles and the statistics stream through a ring of two
//   stages, each with a full barrier (TMA bytes) and an empty one.
// * The five products on wgmma. s^T = k q'^T and dp^T = v dO^T (m64n64,
//   both operands in shared memory) leave p^T and ds^T in the accumulator
//   layout, which is the register A operand of dv += p^T dO and
//   dk += ds^T q_s (m64n128, dO and q_s read with B's transpose bit). For
//   dq = ds k_s, each warpgroup writes bf16(ds^T) to a shared [128 keys x
//   64 q] tile, read as A with the transpose bit, and computes 64 of the
//   128 features of the q tile's dq over all 128 keys (m64n64).
// * dq without per-element atomics: each warpgroup stages its fp32 64 x 64
//   share in the stage's own q' or q_s buffer, free once both warpgroups'
//   products have retired, and adds it to the fp32 [B*N, Lq, 128] buffer
//   with two TMA reduce-adds (boxes of 32 features x 64 rows; rows past Lq
//   are clipped). The stage returns to the producer when the reduction has
//   read it, checked after the next tile's first products are issued. The
//   order of the adds across blocks still changes from run to run: dq is
//   not bitwise deterministic.
// * k_s = bf16(k * scale) is formed once per block in shared memory.
// * Short key ranges (the text cross-attention, 4 key tiles a head): the
//   wrapper splits each key tile's q sweep over `splits` blocks so that
//   the grid fills the SMs; each split writes fp32 dk/dv partials, which
//   the wrapper sums in a fixed order. splits = 1 (bf16 dk/dv written
//   straight from registers) once the key tiles alone fill the card.
// * Shared memory: k, v, k_s 3 x 32 KB, ds^T 16 KB, two stages of q', q_s,
//   dO (16 KB each) and statistics (512 B): 211 KB.
#include "sm90.cuh"
#include "tensor_core.cuh"

namespace {

using namespace hyv::sm90;

constexpr int kD = 128;
constexpr int kBlockN = 128;  // keys per block, 64 per consumer warpgroup
constexpr int kBlockM = 64;   // q rows per stage
constexpr int kThreads = 384;
constexpr float kLog2e = 1.4426950408889634f;

// shared memory, byte offsets from a 1024-aligned base; every tile is two
// 64-feature halves of 128-byte-swizzled rows
constexpr uint32_t kKvTile = kBlockN * kD * 2;   // k, v or k_s: 32 KB
constexpr uint32_t kKvHalf = kKvTile / 2;
constexpr uint32_t kQTile = kBlockM * kD * 2;    // q', q_s or dO: 16 KB
constexpr uint32_t kQHalf = kQTile / 2;
constexpr uint32_t kStatBytes = 2 * kBlockM * 4;  // lse * log2e and delta of 64 rows
constexpr uint32_t kOffK = 0, kOffV = kKvTile, kOffKs = 2 * kKvTile, kOffDs = 3 * kKvTile;
constexpr uint32_t kOffStage = kOffDs + kBlockN * kBlockM * 2;  // after ds^T: 128 x 64 bf16
constexpr uint32_t kStageBytes = 3 * kQTile + 1024;             // q', q_s, dO, statistics
constexpr uint32_t kSQp = 0, kSQs = kQTile, kSDo = 2 * kQTile, kSStat = 3 * kQTile;
constexpr uint32_t kOffBar = kOffStage + 2 * kStageBytes;
constexpr int kSmemBytes = kOffBar + 64 + 1024;  // + barriers + alignment slack
// barriers, 8 B each: full and empty per stage, k/v full
constexpr uint32_t kFull = 0, kEmpty = 16, kKvFull = 32;

struct MergedArgs {
  const float* stats;  // [B*N, n_qt, 2, 64]: lse * log2e, delta
  const int* valid;    // null, or [B*N] key counts
  __nv_bfloat16* dk;   // splits == 1: bf16 by strides
  __nv_bfloat16* dv;
  float* part;         // splits > 1: [2, splits, B*N, Lk, 128] fp32 dk, dv
  long long dk_sb, dk_sh, dk_sl, dv_sb, dv_sh, dv_sl;
  int N, Lk, n_qt, splits;
  float scale;
};

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_merged_kernel(const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const __grid_constant__ CUtensorMap qpmap,
                        const __grid_constant__ CUtensorMap qsmap,
                        const __grid_constant__ CUtensorMap domap,
                        const __grid_constant__ CUtensorMap dqmap, const MergedArgs args) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t bar = base + kOffBar;

  const int bh = blockIdx.y, b = bh / args.N, h = bh - b * args.N;
  const int kt = blockIdx.x / args.splits, split = blockIdx.x - kt * args.splits;
  const int n0 = kt * kBlockN;
  const int lk = args.valid != nullptr ? min(args.valid[bh], args.Lk) : args.Lk;
  const int qt0 = (int)((long long)split * args.n_qt / args.splits);
  const int qt1 = (int)((long long)(split + 1) * args.n_qt / args.splits);
  const int n_tiles = n0 < lk ? qt1 - qt0 : 0;  // all keys masked: write zeros

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(bar + kFull + 8 * i, 1);
      mbar_init(bar + kEmpty + 8 * i, 2);  // one thread per consumer warpgroup
    }
    mbar_init(bar + kKvFull, 1);
    fence_barrier_init();
    prefetch_map(&kmap);
    prefetch_map(&vmap);
    prefetch_map(&qpmap);
    prefetch_map(&qsmap);
    prefetch_map(&domap);
    prefetch_map(&dqmap);
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every load ----
    reg_dealloc<24>();
    if (threadIdx.x != 0 || n_tiles == 0) return;
    mbar_expect_tx(bar + kKvFull, 2 * kKvTile);
    tma_load_4d(base + kOffK, &kmap, bar + kKvFull, 0, n0, h, b);
    tma_load_4d(base + kOffK + kKvHalf, &kmap, bar + kKvFull, 64, n0, h, b);
    tma_load_4d(base + kOffV, &vmap, bar + kKvFull, 0, n0, h, b);
    tma_load_4d(base + kOffV + kKvHalf, &vmap, bar + kKvFull, 64, n0, h, b);
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it & 1, qt = qt0 + it, m0 = qt * kBlockM;
      const uint32_t sb = base + kOffStage + st * kStageBytes, full = bar + kFull + 8 * st;
      mbar_wait(bar + kEmpty + 8 * st, ((it >> 1) & 1) ^ 1);
      mbar_expect_tx(full, 3 * kQTile + kStatBytes);
      tma_load_4d(sb + kSQp, &qpmap, full, 0, m0, h, b);
      tma_load_4d(sb + kSQp + kQHalf, &qpmap, full, 64, m0, h, b);
      tma_load_4d(sb + kSQs, &qsmap, full, 0, m0, h, b);
      tma_load_4d(sb + kSQs + kQHalf, &qsmap, full, 64, m0, h, b);
      tma_load_4d(sb + kSDo, &domap, full, 0, m0, h, b);
      tma_load_4d(sb + kSDo + kQHalf, &domap, full, 64, m0, h, b);
      bulk_load(sb + kSStat, args.stats + ((long long)bh * args.n_qt + qt) * (2 * kBlockM),
                kStatBytes, full);
    }
    return;
  }

  // ---- consumers: warpgroups 1 and 2, 64 keys each ----
  reg_alloc<240>();
  const int cw = wg - 1;             // consumer warpgroup, 0 or 1
  const int wt = threadIdx.x & 127;  // thread in the warpgroup
  const int lane = threadIdx.x & 31;
  // this thread's key rows in the block (accumulator rows): key_row, key_row + 8
  const int key_row = cw * 64 + (wt >> 5) * 16 + (lane >> 2);
  const int q_lane = (lane & 3) * 2;  // its first q (or feature) column in a group of 8

  float dk[64], dv[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;

  if (n_tiles > 0) {
    // k_s = bf16(k * scale) over this warpgroup's 64 keys, in k's layout
    mbar_wait(bar + kKvFull, 0);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int idx = wt + 128 * i, r = cw * 64 + (idx >> 4), c = idx & 15;
      const uint32_t off = (c >> 3) * kKvHalf + hyv::swz128(r, c & 7);
      float f[8];
      hyv::unpack8(*reinterpret_cast<const uint4*>(smem + kOffK + off), f);
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = __fmul_rn(f[e], args.scale);
      *reinterpret_cast<uint4*>(smem + kOffKs + off) = hyv::pack8(f);
    }
    fence_proxy_async();  // read by the dq products, after the ds^T barrier
  }

  // The accumulators live across the loop and only wgmma writes them
  // while a product is in flight; every register write between an issue
  // and its wait would serialise the wgmma pipeline (ptxas note C7513).
  float s[32], dp[32], dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = dq[i] = 0.f;
  const bool tail = n0 + kBlockN > lk;
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1, m0 = (qt0 + it) * kBlockM;
    const uint32_t sb = base + kOffStage + st * kStageBytes;
    const float* stat =
        reinterpret_cast<const float*>(smem + kOffStage + st * kStageBytes + kSStat);
    mbar_wait(bar + kFull + 8 * st, (it >> 1) & 1);

    // s^T = k q'^T and dp^T = v dO^T: this warpgroup's 64 keys x 64 q rows
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_m64n64k16_ss<0, 0>(
          s, desc_sw128(base + kOffK + (kk >> 2) * kKvHalf + cw * 8192 + (kk & 3) * 32, 1, 64),
          desc_sw128(sb + kSQp + (kk >> 2) * kQHalf + (kk & 3) * 32, 1, 64), kk > 0);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_m64n64k16_ss<0, 0>(
          dp, desc_sw128(base + kOffV + (kk >> 2) * kKvHalf + cw * 8192 + (kk & 3) * 32, 1, 64),
          desc_sw128(sb + kSDo + (kk >> 2) * kQHalf + (kk & 3) * 32, 1, 64), kk > 0);
    wgmma_commit();
    // the previous tile's dq reductions have read their staging buffer:
    // return that stage to the producer
    if (it > 0 && wt == 0) {
      bulk_wait_read();
      mbar_arrive(bar + kEmpty + 8 * (st ^ 1));
    }
    wgmma_wait<0>();
    reg_fence(s);
    reg_fence(dp);

    // p = exp2(s - lse * log2e); keys at or past lk get p = 0 (q rows past
    // Lq have lse * log2e = +inf, so p = 0 there too); then
    // ds^T = p^T (dp^T - delta) in place of dp
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int q = (i >> 2) * 8 + q_lane + (i & 1);
      float p = exp2f(s[i] - stat[q]);
      if (tail && n0 + key_row + 8 * ((i >> 1) & 1) >= lk) p = 0.f;
      s[i] = p;
      dp[i] = p * (dp[i] - stat[kBlockM + q]);
    }
    // bf16(p^T) and bf16(ds^T): the accumulator fragments of q columns
    // 16kk..16kk+15 are the A operand of k-step kk; [kk][i] holds q columns
    // 16kk + 8(i / 2).. of key row key_row + 8(i % 2)
    uint32_t pf[4][4], dsf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pf[kk][i] = hyv::pack_bf16x2(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
        dsf[kk][i] = hyv::pack_bf16x2(dp[8 * kk + 2 * i], dp[8 * kk + 2 * i + 1]);
      }
    // bf16(ds^T) into the shared [128 keys x 64 q] tile, before any product
    // reads dsf
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = key_row + 8 * (i & 1);
        const uint32_t addr = base + kOffDs + hyv::swz128(row, 2 * kk + (i >> 1)) + (lane & 3) * 4;
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(dsf[kk][i]) : "memory");
      }
    fence_proxy_async();

    // dv += bf16(p)^T dO and dk += bf16(ds)^T q_s
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n128k16_rs<1>(dv, pf[kk], desc_sw128(sb + kSDo + kk * 2048, kQHalf >> 4, 64), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n128k16_rs<1>(dk, dsf[kk], desc_sw128(sb + kSQs + kk * 2048, kQHalf >> 4, 64), 1);
    wgmma_commit();
    named_bar_sync(1, 256);  // the whole ds^T tile (and k_s) is in place

    // dq = bf16(ds) k_s over all 128 keys, this warpgroup's 64 features
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk)
      wgmma_m64n64k16_ss<1, 1>(dq, desc_sw128(base + kOffDs + kk * 2048, 1, 64),
                               desc_sw128(base + kOffKs + cw * kKvHalf + kk * 2048, 1, 64),
                               kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(dq);
    reg_fence(dk);
    reg_fence(dv);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      reg_fence(pf[kk]);
      reg_fence(dsf[kk]);
    }
    named_bar_sync(2, 256);  // both warpgroups are done with this stage and ds^T

    // stage dq (fp32, 64 q x 64 features) in the stage's q' (warpgroup 0) or
    // q_s (warpgroup 1) buffer as two 128-byte-swizzled boxes of 32
    // features, then add it to the global dq with two TMA reductions
    const uint32_t stg = sb + (cw == 0 ? kSQp : kSQs);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = (wt >> 5) * 16 + (lane >> 2) + 8 * half;
        const int chunk = 2 * (j & 3) + ((lane & 3) >> 1);
        const uint32_t addr =
            stg + (j >> 2) * 8192 + row * 128 + ((chunk ^ (row & 7)) << 4) + (lane & 1) * 8;
        asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(dq[4 * j + 2 * half]),
                     "f"(dq[4 * j + 2 * half + 1])
                     : "memory");
      }
    fence_proxy_async();
    named_bar_sync(3 + cw, 128);
    if (wt == 0) {
      tma_reduce_add_4d(&dqmap, stg, cw * 64, m0, h, b);
      tma_reduce_add_4d(&dqmap, stg + 8192, cw * 64 + 32, m0, h, b);
      bulk_commit();
    }
  }
  if (wt == 0 && n_tiles > 0) bulk_wait();

  // epilogue: rows past Lk are dropped; one split writes bf16 dk (head-major)
  // and dv (token-major), several write fp32 partials
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = n0 + key_row + 8 * half;
    if (key >= args.Lk) continue;
    if (args.splits == 1) {
      __nv_bfloat16* dkr = args.dk + b * args.dk_sb + h * args.dk_sh + key * args.dk_sl;
      __nv_bfloat16* dvr = args.dv + b * args.dv_sb + h * args.dv_sh + key * args.dv_sl;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        const int d = 8 * j + q_lane;
        *reinterpret_cast<uint32_t*>(dkr + d) =
            hyv::pack_bf16x2(dk[4 * j + 2 * half], dk[4 * j + 2 * half + 1]);
        *reinterpret_cast<uint32_t*>(dvr + d) =
            hyv::pack_bf16x2(dv[4 * j + 2 * half], dv[4 * j + 2 * half + 1]);
      }
    } else {
      const long long plane = (long long)gridDim.y * args.Lk * kD;  // one split's [B*N, Lk, 128]
      float* dkr = args.part + ((long long)split * gridDim.y + bh) * args.Lk * kD +
                   (long long)key * kD;
      float* dvr = dkr + args.splits * plane;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        const int d = 8 * j + q_lane;
        *reinterpret_cast<float2*>(dkr + d) =
            make_float2(dk[4 * j + 2 * half], dk[4 * j + 2 * half + 1]);
        *reinterpret_cast<float2*>(dvr + d) =
            make_float2(dv[4 * j + 2 * half], dv[4 * j + 2 * half + 1]);
      }
    }
  }
}

// ---- prologue: q', q_s and the row statistics, one warp per q row ----

struct PrologueArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  const float* lse;   // [B*N, Lq], natural units
  __nv_bfloat16* qp;  // [2, B*N, Lq, 128]: q', q_s
  float* stats;       // [B*N, n_qt, 2, 64]
  long long q_sb, q_sh, q_sl, o_sb, o_sh, o_sl, do_sb, do_sh, do_sl;
  int N, Lq, n_qt;
  float qscale, scale;
};

constexpr int kPrologueWarps = 8;

__device__ __forceinline__ void unpack4(uint2 u, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(p[0]), c = __bfloat1622float2(p[1]);
  f[0] = a.x; f[1] = a.y; f[2] = c.x; f[3] = c.y;
}

__device__ __forceinline__ uint2 pack4(const float* f) {
  uint2 u;
  u.x = hyv::pack_bf16x2(f[0], f[1]);
  u.y = hyv::pack_bf16x2(f[2], f[3]);
  return u;
}

__global__ void __launch_bounds__(kPrologueWarps * 32)
flash_bwd_prologue_kernel(const PrologueArgs a) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kPrologueWarps + (threadIdx.x >> 5);
  const int bh = blockIdx.y, b = bh / a.N, h = bh - b * a.N;
  if (m >= a.n_qt * kBlockM) return;
  float lse2 = __int_as_float(0x7f800000), delta = 0.f;  // rows past Lq: p = 0
  if (m < a.Lq) {
    float f[4], g[4], t[4];
    const int c = lane * 4;  // this lane's 4 features
    unpack4(*reinterpret_cast<const uint2*>(a.q + b * a.q_sb + h * a.q_sh + m * a.q_sl + c), f);
    const long long row = ((long long)bh * a.Lq + m) * kD + c;
    const long long plane = (long long)gridDim.y * a.Lq * kD;
#pragma unroll
    for (int e = 0; e < 4; ++e) t[e] = __fmul_rn(f[e], a.qscale);
    *reinterpret_cast<uint2*>(a.qp + row) = pack4(t);
#pragma unroll
    for (int e = 0; e < 4; ++e) t[e] = __fmul_rn(f[e], a.scale);
    *reinterpret_cast<uint2*>(a.qp + plane + row) = pack4(t);
    unpack4(*reinterpret_cast<const uint2*>(a.o + b * a.o_sb + h * a.o_sh + m * a.o_sl + c), f);
    unpack4(*reinterpret_cast<const uint2*>(a.dout + b * a.do_sb + h * a.do_sh + m * a.do_sl + c),
            g);
    delta = hyv::warp_sum((f[0] * g[0] + f[1] * g[1]) + (f[2] * g[2] + f[3] * g[3]));
    lse2 = __fmul_rn(a.lse[(long long)bh * a.Lq + m], kLog2e);
  }
  if (lane == 0) {
    float* st = a.stats + ((long long)bh * a.n_qt + m / kBlockM) * (2 * kBlockM) + m % kBlockM;
    st[0] = lse2;
    st[kBlockM] = delta;
  }
}

}  // namespace

// q [B, N, Lq, 128], k [B, N, Lk, 128] head-major; v [B, Lk, N, 128], o and
// dO [B, Lq, N, 128] token-major; all bf16 by element strides (feature
// stride 1, rows 16 B aligned). lse [B*N, Lq] fp32. dq [B*N, Lq, 128] fp32,
// zeroed by the caller and accumulated into. dk [B, N, Lk, 128] and dv
// [B, Lk, N, 128] bf16 by strides when splits == 1; otherwise part [2,
// splits, B*N, Lk, 128] fp32 receives dk and dv partials for the caller to
// sum. Scratch: qp [2, B*N, Lq, 128] bf16, stats [B*N, ceil(Lq / 64), 2, 64]
// fp32. valid: null, or int32 [B*N] key counts (>= 1), the forward's key mask.
extern "C" int hyv_flash_bwd_merged(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, const void* valid, void* dq, void* dk, void* dv, void* qp, void* stats,
    void* part, int B, int N, int Lq, int Lk, int splits,
    long long q_sb, long long q_sh, long long q_sl,
    long long k_sb, long long k_sh, long long k_sl,
    long long v_sb, long long v_sh, long long v_sl,
    long long o_sb, long long o_sh, long long o_sl,
    long long do_sb, long long do_sh, long long do_sl,
    long long dk_sb, long long dk_sh, long long dk_sl,
    long long dv_sb, long long dv_sh, long long dv_sl,
    float qscale, float scale, void* stream) {
  if (Lk <= 0 || Lq <= 0 || splits < 1) return (int)cudaErrorInvalidValue;
  if (B * N == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int BN = B * N, n_qt = (Lq + kBlockM - 1) / kBlockM;
  const PrologueArgs pa{(const __nv_bfloat16*)q, (const __nv_bfloat16*)o,
                        (const __nv_bfloat16*)dout, (const float*)lse, (__nv_bfloat16*)qp,
                        (float*)stats, q_sb, q_sh, q_sl, o_sb, o_sh, o_sl, do_sb, do_sh, do_sl,
                        N, Lq, n_qt, qscale, scale};
  flash_bwd_prologue_kernel<<<dim3(n_qt * kBlockM / kPrologueWarps, BN), kPrologueWarps * 32, 0,
                              st>>>(pa);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const long long row = kD, head = (long long)Lq * kD, batch = (long long)N * Lq * kD;
  const __nv_bfloat16* qs = (const __nv_bfloat16*)qp + (long long)BN * Lq * kD;
  CUtensorMap kmap, vmap, qpmap, qsmap, domap, dqmap;
  if ((err = encode_bf16_rows(&kmap, k, Lk, N, B, k_sl, k_sh, k_sb, kBlockN)) ||
      (err = encode_bf16_rows(&vmap, v, Lk, N, B, v_sl, v_sh, v_sb, kBlockN)) ||
      (err = encode_bf16_rows(&qpmap, qp, Lq, N, B, row, head, batch, kBlockM)) ||
      (err = encode_bf16_rows(&qsmap, qs, Lq, N, B, row, head, batch, kBlockM)) ||
      (err = encode_bf16_rows(&domap, dout, Lq, N, B, do_sl, do_sh, do_sb, kBlockM)) ||
      (err = encode_f32_rows(&dqmap, dq, Lq, N, B, row, head, batch, kBlockM)))
    return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_merged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const MergedArgs args{(const float*)stats, (const int*)valid, (__nv_bfloat16*)dk,
                        (__nv_bfloat16*)dv, (float*)part, dk_sb, dk_sh, dk_sl, dv_sb, dv_sh, dv_sl,
                        N, Lk, n_qt, splits, scale};
  const int n_kt = (Lk + kBlockN - 1) / kBlockN;
  flash_bwd_merged_kernel<<<dim3(n_kt * splits, BN), kThreads, kSmemBytes, st>>>(
      kmap, vmap, qpmap, qsmap, domap, dqmap, args);
  return (int)cudaGetLastError();
}

// the dynamic shared memory each K4 block asks for, for reports
extern "C" int hyv_flash_bwd_merged_smem() { return kSmemBytes; }

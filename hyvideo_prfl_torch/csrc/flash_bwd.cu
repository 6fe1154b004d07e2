// K4 and K5: the flash-attention backward, head_dim 128, written for
// Hopper: TMA loads, wgmma products, warp specialisation.
//
// Replaces hyvideo_prfl_tpu/ops/flash_attention.py
//   K4  _dqkv_kernel (:453; pallas_call at :890 in _flash_bwd_merged :849):
//       the merged backward, five products per (q tile, key tile) cell;
//   K5  _dkv_kernel (:407; pallas_call at :798) and _dq_kernel (:371;
//       pallas_call at :775), both from _flash_bwd (:752): the split
//       backward, a dk/dv pass and a dq pass.
// The route between them is the JAX rule (flash_attention.py:763), taken by
// the Python wrapper: K4 when the padded q range holds at least four of
// JAX's backward q blocks and HYV_FLASH_MERGED_BWD is not 0, K5 otherwise.
// Per (batch, head), from the saved lse (the backward recomputes p, so the
// bounded and the shifted forward share it):
//
//   q' = bf16(q * scale * log2e),  p = exp2(q' k^T - lse * log2e)
//   dv += bf16(p)^T dO,   dp = dO v^T,   ds = p * (dp - delta)
//   dk += bf16(ds)^T bf16(q * scale),   dq += bf16(ds) bf16(k * scale)
//
// with delta = rowsum(dO * o) over the bf16 o the forward wrote. Keys at or
// past lk contribute nothing (p = 0), where lk is Lk or the optional int32
// [B*N] valid length of the head (the shifted forward's key mask, the TPU's
// "user" mask), so masked keys get exactly zero gradients; a dk/dv block
// whose keys are all masked writes zeros and stops, and the dq pass ends
// its key loop at the tile that holds the last valid key.
//
// Bound on the H100: tensor-core math. At the 81-frame self-attention
// shape (12 heads x 32,760 x 32,760 x 128) the five products are 1.65e13
// flop against well under 1 GB of traffic: 16.7 ms at the 989 TFLOP/s bf16
// peak. K5 computes s and dp in both passes (seven products); the bound
// counts the algorithm's five for both. K4 reaches ~0.55-0.58 of it: per q
// tile its softmax leaves the tensor cores idle (both warpgroups form it at
// once) and its dq staging and ds^T stores share the shared memory with the
// products (~384 KB a tile); PERF.md keeps the measurements.
//
// Design (FlashAttention-3's backward shape, simplified):
// * A prologue kernel forms, once per call, q' and q_s = bf16(q * scale)
//   in a [2, B*N, Lq, 128] scratch, and per 64-row q tile the row
//   statistics lse * log2e (+inf past Lq, so p = 0 there) and delta (a
//   warp's sum of dO * o) in a [B*N, n_qt, 2, 64] scratch, so the main
//   kernels' tiles arrive ready for the tensor cores. For K5 it also forms
//   k_s = bf16(k * scale) in a [B*N, Lk, 128] scratch: JAX rounds k * scale
//   to bf16 before the product, so the scale cannot move onto dq.
// * The dk/dv block (K4's flash_bwd_merged_kernel and K5's first pass,
//   flash_bwd_dkv_kernel: two bodies). A block owns 128 keys of one (batch,
//   head), keeps their dk and dv in fp32 registers and sweeps q tiles of 64
//   rows; 384 threads: warpgroup 0 is the producer (24 registers after
//   setmaxnreg; one thread issues every load), warpgroups 1 and 2 are
//   consumers (240 registers) owning 64 keys each. k and v arrive once by
//   TMA; the q', q_s and dO tiles and the statistics stream through a ring
//   of two stages. s^T = k q'^T and dp^T = v dO^T (m64n64, both operands in
//   shared memory) leave p^T and ds^T in the accumulator layout, which is
//   the register A operand of dv += p^T dO and dk += ds^T q_s (m64n128, dO
//   and q_s read with B's transpose bit). K5's body stops there: four
//   products a cell, one stage barrier pair, and each stage returns to the
//   producer once its products have retired.
// * K4 adds dq = bf16(ds) k_s (k_s formed once per block in shared memory):
//   each warpgroup computes 64 of the 128 features of a q tile's dq over all
//   128 keys (m64n64), reading the whole bf16 [128 keys x 64 q] ds^T tile as
//   A with the transpose bit. Per q tile i, each consumer warpgroup:
//     1. waits for stage i, issues s^T and dp^T and waits for them;
//     2. forms p and ds and packs them to bf16 A fragments (the statistics
//        from the stage, exp2 on the multi-function unit);
//     3. waits for tile i - 1's ds^T to be whole (both halves stored a
//        tile ago), issues its dq product, then dv and dk of tile i;
//     4. while dv and dk are in flight: waits for that dq product alone,
//        stores its fp32 64 x 64 share into the warpgroup's own staging
//        tile (once the writer has freed it), waits for the other
//        warpgroup's s^T to retire (q' is then dead), stores bf16(ds^T) of
//        tile i into stage i's q' buffer, one proxy fence for both, and
//        signals the writer and the other warpgroup;
//     5. waits for dv and dk.
//   A warp arrives for a barrier's phase i only after that barrier's phase
//   i - 1 has completed in its own view: the barriers count arrivals.
//   The dq product runs a tile behind so that no warpgroup waits for the
//   other's ds^T; it is issued after the softmax, not during it, because
//   its 32-register accumulator beside s, dp, dk and dv would leave the
//   wgmma pipeline too few of the 240 registers (ptxas C7512 then
//   serialises every product). Lane 0 of producer warp 1 + c adds warpgroup
//   c's staged share to the fp32 [B*N, Lq, 128] dq with two TMA reduce-adds
//   (boxes of 32 features x 64 rows; rows past Lq are clipped) and frees the
//   staging tile once they have read it, off the consumers' path. A stage
//   returns in two parts: q_s, dO and the statistics when dv and dk have
//   retired (the end of tile i: their reload for tile i + 2 runs a whole
//   tile ahead), q' (then ds^T) when both dq products have read it (midway
//   through tile i + 1). The order of the adds across blocks changes from
//   run to run: K4's dq is not bitwise deterministic.
// * Short key ranges (the text cross-attention, 4 key tiles a head): the
//   wrapper splits each key tile's q sweep over `kv_splits` blocks so that
//   the grid fills the SMs; each split writes fp32 dk/dv partials, which
//   the wrapper sums in a fixed order.
// * K5's dq pass, in the shape of the forward (flash_fwd.cu): a persistent
//   grid over (batch*head, key split, q tile of 128 rows), the q' and dO
//   tiles resident in shared memory, k, v and k_s streamed by TMA through
//   three stages of 64 keys. Per key tile each consumer warpgroup (64 q
//   rows) issues s = q' k^T and dp = dO v^T (m64n64, shared x shared),
//   then dq += bf16(ds) k_s of the previous key tile (m64n128, ds from
//   registers, k_s read with B's transpose bit, as p v reads v in the
//   forward), and waits for the first two alone: p and ds of this tile are
//   formed while that dq product is in flight. 64-key tiles keep s, dp and
//   dq (32 + 32 + 64 fp32) and the ds fragments under the 240 registers.
//   dq leaves the registers once per q tile, as fp32: no atomics and no
//   reduce-adds, so K5's dq is bitwise deterministic. When the q tiles
//   alone leave SMs idle (lq 1,024: 96 tiles for 132 SMs), the wrapper
//   splits each q tile's key range over `dq_splits` blocks, each writing an
//   fp32 partial that the wrapper sums in a fixed order.
// * Shared memory: K4 k, v, k_s 3 x 32 KB, two fp32 dq staging tiles of 16
//   KB, two stages of q' (then ds^T), q_s, dO (16 KB each), their statistics
//   (512 B each) and barriers: 226 KB with the alignment slack (a block may
//   have 227). K5's dk/dv pass: k, v, 48 KB it leaves unused, two stages of
//   q', q_s, dO and statistics: 211 KB. dq pass: q' and dO 2 x 32 KB, three stages of k, v, k_s (16 KB
//   each): 209 KB.
#include <type_traits>

#include "sm90.cuh"
#include "tensor_core.cuh"

namespace {

using namespace hyv::sm90;

constexpr int kD = 128;
constexpr int kBlockN = 128;  // keys per dk/dv block, 64 per consumer warpgroup
constexpr int kBlockM = 64;   // q rows per dk/dv stage, and per statistics tile
constexpr int kThreads = 384;
constexpr float kLog2e = 1.4426950408889634f;

// Tile sizes, and K5's dk/dv shared memory (byte offsets from a
// 1024-aligned base); every tile is two 64-feature halves of
// 128-byte-swizzled rows. K5 leaves k_s and ds^T unused: without them its
// SASS would no longer be that of the kernel PERF.md timed
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

struct KvArgs {
  const float* stats;  // [B*N, n_qt, 2, 64]: lse * log2e, delta
  const int* valid;    // null, or [B*N] key counts
  __nv_bfloat16* dk;   // splits == 1: bf16 by strides
  __nv_bfloat16* dv;
  float* part;         // splits > 1: [2, splits, B*N, Lk, 128] fp32 dk, dv
  long long dk_sb, dk_sh, dk_sl, dv_sb, dv_sh, dv_sl;
  int N, Lk, n_qt, splits;
  float scale;
};

// The dk/dv epilogue of a block's consumer thread (key rows row0 and
// row0 + 8 of its (batch, head)): rows past Lk are dropped; one split writes
// bf16 dk (head-major) and dv (token-major), several write fp32 partials
__device__ __forceinline__ void write_dkdv(const float (&dk)[64], const float (&dv)[64],
                                           const KvArgs& args, int b, int h, int bh, int split,
                                           int row0, int q_lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = row0 + 8 * half;
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

// ---- K4: the merged dk/dv/dq block ----------------------------------------

// shared memory, byte offsets from a 1024-aligned base: k, v, k_s; one fp32
// dq staging tile per consumer warpgroup; two stages of q', q_s, dO (the q'
// buffer holds the tile's bf16 ds^T once both warpgroups' s^T products have
// retired); the two stages' statistics; barriers
constexpr uint32_t kMDqTile = kBlockM * 64 * 4;  // 64 q x 64 features fp32: 16 KB
constexpr uint32_t kMOffDq = 3 * kKvTile;
constexpr uint32_t kMOffStage = kMOffDq + 2 * kMDqTile;
constexpr uint32_t kMStageBytes = 3 * kQTile;  // q' (then ds^T), q_s, dO
constexpr uint32_t kMOffStat = kMOffStage + 2 * kMStageBytes;
constexpr uint32_t kMOffBar = kMOffStat + 2 * kStatBytes;
constexpr int kMSmemBytes = kMOffBar + 128 + 1024;  // + barriers + alignment slack
static_assert(kMSmemBytes <= 232448, "K4's shared memory exceeds a block's 227 KB");
// barriers, 8 B each, two of a kind indexed by stage or warpgroup: a stage
// full; its q_s/dO/statistics and its q' free; a staging tile full and
// free; k/v full; both warpgroups' s^T retired (q' may take ds^T); the ds^T
// tile whole
constexpr uint32_t kMFull = 0, kMQdEmpty = 16, kMQpEmpty = 32, kMDqFull = 48, kMDqEmpty = 64,
                   kMKvFull = 80, kMAdone = 88, kMDsFull = 96;

// K4's block: 128 keys of one (batch, head), their dk and dv in registers,
// dq of each q tile added to the global fp32 dq by TMA reductions
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_merged_kernel(const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const __grid_constant__ CUtensorMap qpmap,
                        const __grid_constant__ CUtensorMap qsmap,
                        const __grid_constant__ CUtensorMap domap,
                        const __grid_constant__ CUtensorMap dqmap, const KvArgs args) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t bar = base + kMOffBar;

  const int bh = blockIdx.y, b = bh / args.N, h = bh - b * args.N;
  const int kt = blockIdx.x / args.splits, split = blockIdx.x - kt * args.splits;
  const int n0 = kt * kBlockN;
  const int lk = args.valid != nullptr ? min(args.valid[bh], args.Lk) : args.Lk;
  const int qt0 = (int)((long long)split * args.n_qt / args.splits);
  const int qt1 = (int)((long long)(split + 1) * args.n_qt / args.splits);
  const int n_tiles = n0 < lk ? qt1 - qt0 : 0;  // all keys masked: write zeros

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(bar + kMFull + 8 * i, 1);
      // one lane per consumer warp of both warpgroups
      mbar_init(bar + kMQdEmpty + 8 * i, 8);
      mbar_init(bar + kMQpEmpty + 8 * i, 8);
      // one lane per warp of warpgroup i; its writer
      mbar_init(bar + kMDqFull + 8 * i, 4);
      mbar_init(bar + kMDqEmpty + 8 * i, 1);
    }
    mbar_init(bar + kMKvFull, 1);
    mbar_init(bar + kMAdone, 8);
    mbar_init(bar + kMDsFull, 8);
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
  const int lane = threadIdx.x & 31;
  if (wg == 0) {
    // ---- producer warpgroup: lane 0 of warp 0 issues every load; lane 0
    // of warp 1 + c adds consumer warpgroup c's dq ----
    reg_dealloc<24>();
    const int warp = threadIdx.x >> 5;
    if (lane != 0 || warp > 2 || n_tiles == 0) return;
    if (warp == 0) {
      mbar_expect_tx(bar + kMKvFull, 2 * kKvTile);
      tma_load_4d(base + kOffK, &kmap, bar + kMKvFull, 0, n0, h, b);
      tma_load_4d(base + kOffK + kKvHalf, &kmap, bar + kMKvFull, 64, n0, h, b);
      tma_load_4d(base + kOffV, &vmap, bar + kMKvFull, 0, n0, h, b);
      tma_load_4d(base + kOffV + kKvHalf, &vmap, bar + kMKvFull, 64, n0, h, b);
      // not unrolled: the loop must fit the producer's 24 registers
#pragma unroll 1
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it & 1, qt = qt0 + it, m0 = qt * kBlockM;
        const uint32_t parity = ((it >> 1) & 1) ^ 1;
        const uint32_t sb = base + kMOffStage + st * kMStageBytes, full = bar + kMFull + 8 * st;
        // q_s, dO and the statistics once the stage's dv and dk products
        // have retired, q' once its ds^T has been read by the dq products
        mbar_wait(bar + kMQdEmpty + 8 * st, parity);
        mbar_expect_tx(full, 3 * kQTile + kStatBytes);
        tma_load_4d(sb + kSQs, &qsmap, full, 0, m0, h, b);
        tma_load_4d(sb + kSQs + kQHalf, &qsmap, full, 64, m0, h, b);
        tma_load_4d(sb + kSDo, &domap, full, 0, m0, h, b);
        tma_load_4d(sb + kSDo + kQHalf, &domap, full, 64, m0, h, b);
        bulk_load(base + kMOffStat + st * kStatBytes,
                  args.stats + ((long long)bh * args.n_qt + qt) * (2 * kBlockM), kStatBytes, full);
        mbar_wait(bar + kMQpEmpty + 8 * st, parity);
        tma_load_4d(sb + kSQp, &qpmap, full, 0, m0, h, b);
        tma_load_4d(sb + kSQp + kQHalf, &qpmap, full, 64, m0, h, b);
      }
    } else {
      const int c = warp - 1;
      const uint32_t stg = base + kMOffDq + c * kMDqTile;
#pragma unroll 1
      for (int it = 0; it < n_tiles; ++it) {
        mbar_wait(bar + kMDqFull + 8 * c, it & 1);
        const int m0 = (qt0 + it) * kBlockM;
        tma_reduce_add_4d(&dqmap, stg, c * 64, m0, h, b);
        tma_reduce_add_4d(&dqmap, stg + kMDqTile / 2, c * 64 + 32, m0, h, b);
        bulk_commit();
        bulk_wait_read();
        mbar_arrive(bar + kMDqEmpty + 8 * c);
      }
      bulk_wait();
    }
    return;
  }

  // ---- consumers: warpgroups 1 and 2, 64 keys each ----
  reg_alloc<240>();
  const int cw = wg - 1;             // consumer warpgroup, 0 or 1
  const int wt = threadIdx.x & 127;  // thread in the warpgroup
  // this thread's key rows in the block (accumulator rows): key_row, key_row + 8
  const int key_row = cw * 64 + (wt >> 5) * 16 + (lane >> 2);
  const int q_lane = (lane & 3) * 2;  // its first q (or feature) column in a group of 8

  float dk[64], dv[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;

  if (n_tiles > 0) {
    // k_s = bf16(k * scale) over this warpgroup's 64 keys, in k's layout;
    // the other warpgroup's dq products read it after their first ds^T wait
    mbar_wait(bar + kMKvFull, 0);
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
    fence_proxy_async();
  }

  // dq = bf16(ds) k_s over all 128 keys, this warpgroup's 64 features, for
  // the tile whose ds^T lies in stage `stage`'s q' buffer
  float dq[32];
  auto issue_dq = [&](int stage) {
    const uint32_t ds = base + kMOffStage + stage * kMStageBytes + kSQp;
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk)
      wgmma_m64n64k16_ss<1, 1>(dq, desc_sw128(ds + kk * 2048, 1, 64),
                               desc_sw128(base + kOffKs + cw * kKvHalf + kk * 2048, 1, 64),
                               kk > 0);
    wgmma_commit();
  };
  // dq of tile `it` (fp32, 64 q x 64 features) into this warpgroup's staging
  // tile as two 128-byte-swizzled boxes of 32 features, for its writer
  // (after a proxy fence, with kMDqFull); tile it - 1's reduction must have
  // read the tile first
  auto store_dq = [&](int it) {
    mbar_wait(bar + kMDqEmpty + 8 * cw, (it & 1) ^ 1);
    const uint32_t wrow = (wt >> 5) * 16 + (lane >> 2);
    const uint32_t stg = base + kMOffDq + cw * kMDqTile + wrow * 128 + (lane & 1) * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint32_t chunk = 2 * (j & 3) + ((lane & 3) >> 1);
        const uint32_t addr =
            stg + (j >> 2) * (kMDqTile / 2) + half * 1024 + ((chunk ^ (wrow & 7)) << 4);
        asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr),
                     "f"(dq[4 * j + 2 * half]), "f"(dq[4 * j + 2 * half + 1])
                     : "memory");
      }
  };

  // The accumulators live across the loop and only wgmma writes them
  // while a product is in flight; every register write between an issue
  // and its wait would serialise the wgmma pipeline (ptxas note C7513).
  float s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = dq[i] = 0.f;
  const bool tail = n0 + kBlockN > lk;
  // one q tile; `after_first` (a std::true_type past tile 0) adds the
  // previous tile's dq, so no product is issued under a branch
  auto tile = [&](const int it, auto after_first) {
    constexpr bool kPrev = decltype(after_first)::value;
    const int st = it & 1;
    const uint32_t sb = base + kMOffStage + st * kMStageBytes;
    const float* stat = reinterpret_cast<const float*>(smem + kMOffStat + st * kStatBytes);
    mbar_wait(bar + kMFull + 8 * st, (it >> 1) & 1);

    // s^T = k q'^T and dp^T = v dO^T (this warpgroup's 64 keys x 64 q rows)
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
    wgmma_wait<0>();
    reg_fence(s);
    reg_fence(dp);
    // this warp is done with q': the other warpgroup may write its ds^T there
    if (lane == 0) mbar_arrive(bar + kMAdone);

    // p = exp2(s - lse * log2e); keys at or past lk get p = 0 (q rows past
    // Lq have lse * log2e = +inf, so p = 0 there too); ds^T = p^T (dp^T -
    // delta); then bf16(p^T) and bf16(ds^T), pair by pair: the accumulator
    // fragments of q columns 16kk..16kk+15 are the A operand of k-step kk;
    // [kk][i] holds q columns 16kk + 8(i / 2).. of key row key_row + 8(i % 2)
    uint32_t pf[4][4], dsf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 8 * kk + 2 * i + e, q = (x >> 2) * 8 + q_lane + e;
          p[e] = exp2_mufu(s[x] - stat[q]);
          if (tail && n0 + key_row + 8 * (i & 1) >= lk) p[e] = 0.f;
          ds[e] = p[e] * (dp[x] - stat[kBlockM + q]);
        }
        pf[kk][i] = hyv::pack_bf16x2(p[0], p[1]);
        dsf[kk][i] = hyv::pack_bf16x2(ds[0], ds[1]);
      }

    // the previous tile's dq (its ds^T whole by now), then dv += bf16(p)^T dO
    // and dk += bf16(ds)^T q_s. (In flight during the softmax, dq's
    // accumulator would leave the wgmma pipeline too few registers: ptxas
    // note C7512.)
    if constexpr (kPrev) mbar_wait(bar + kMDsFull, (it - 1) & 1);
    wgmma_fence();
    if constexpr (kPrev) issue_dq(st ^ 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n128k16_rs<1>(dv, pf[kk], desc_sw128(sb + kSDo + kk * 2048, kQHalf >> 4, 64), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n128k16_rs<1>(dk, dsf[kk], desc_sw128(sb + kSQs + kk * 2048, kQHalf >> 4, 64), 1);
    wgmma_commit();

    if constexpr (kPrev) {
      // the previous tile's dq has retired: its q' buffer (its ds^T) is free
      // of this warp, and its dq goes to the writer
      wgmma_wait<1>();
      reg_fence(dq);
      if (lane == 0) mbar_arrive(bar + kMQpEmpty + 8 * (st ^ 1));
      store_dq(it - 1);
    }

    // bf16(ds^T) into this warpgroup's 64 key rows of the [128 keys x 64 q]
    // tile in the stage's q' buffer, once both warpgroups' s^T have read q';
    // one proxy fence for both tiles' stores
    mbar_wait(bar + kMAdone, it & 1);
    const uint32_t dsb = sb + kSQp + key_row * 128 + (lane & 3) * 4;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t addr = dsb + (i & 1) * 1024 + (((2 * kk + (i >> 1)) ^ (key_row & 7)) << 4);
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(dsf[kk][i]) : "memory");
      }
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) {
      if constexpr (kPrev) mbar_arrive(bar + kMDqFull + 8 * cw);
      mbar_arrive(bar + kMDsFull);
    }

    // dv and dk have retired: q_s, dO and the statistics return to the
    // producer
    wgmma_wait<0>();
    reg_fence(dk);
    reg_fence(dv);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      reg_fence(pf[kk]);
      reg_fence(dsf[kk]);
    }
    if (lane == 0) mbar_arrive(bar + kMQdEmpty + 8 * st);
  };
  if (n_tiles > 0) {
    tile(0, std::false_type{});
    for (int it = 1; it < n_tiles; ++it) tile(it, std::true_type{});
    // the last tile's dq
    mbar_wait(bar + kMDsFull, (n_tiles - 1) & 1);
    wgmma_fence();
    issue_dq((n_tiles - 1) & 1);
    wgmma_wait<0>();
    reg_fence(dq);
    store_dq(n_tiles - 1);
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(bar + kMDqFull + 8 * cw);
  }
  write_dkdv(dk, dv, args, b, h, bh, split, n0 + key_row, q_lane);
}

// ---- K5's dk/dv pass ------------------------------------------------------

// K5's first pass: a block owns 128 keys, as K4's, and computes dk and dv
// alone (four products a cell); each stage returns to the producer once
// its products have retired
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap qpmap,
                     const __grid_constant__ CUtensorMap qsmap,
                     const __grid_constant__ CUtensorMap domap, const KvArgs args) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bar = base + kOffBar;
  uint8_t* smem = smem_raw + (base - raw);

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
      mbar_init(bar + kEmpty + 8 * i, 8);  // one lane per consumer warp
    }
    mbar_init(bar + kKvFull, 1);
    fence_barrier_init();
    prefetch_map(&kmap);
    prefetch_map(&vmap);
    prefetch_map(&qpmap);
    prefetch_map(&qsmap);
    prefetch_map(&domap);
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
  if (n_tiles > 0) mbar_wait(bar + kKvFull, 0);

  // The accumulators live across the loop and only wgmma writes them
  // while a product is in flight; every register write between an issue
  // and its wait would serialise the wgmma pipeline (ptxas note C7513).
  float s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  const bool tail = n0 + kBlockN > lk;
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
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

    // dv += bf16(p)^T dO and dk += bf16(ds)^T q_s
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n128k16_rs<1>(dv, pf[kk], desc_sw128(sb + kSDo + kk * 2048, kQHalf >> 4, 64), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n128k16_rs<1>(dk, dsf[kk], desc_sw128(sb + kSQs + kk * 2048, kQHalf >> 4, 64), 1);
    wgmma_commit();
    // the stage's last readers have retired: return it to the producer
    wgmma_wait<0>();
    reg_fence(dk);
    reg_fence(dv);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      reg_fence(pf[kk]);
      reg_fence(dsf[kk]);
    }
    if (lane == 0) mbar_arrive(bar + kEmpty + 8 * st);
  }
  write_dkdv(dk, dv, args, b, h, bh, split, n0 + key_row, q_lane);
}

// ---- K5's dq pass ---------------------------------------------------------

constexpr int kDqBlockM = 128;  // q rows per tile, 64 per consumer warpgroup
constexpr int kDqBlockN = 64;   // keys per stage
constexpr int kDqStages = 3;
constexpr uint32_t kDqQTile = kDqBlockM * kD * 2;  // q' or dO: 32 KB
constexpr uint32_t kDqQHalf = kDqQTile / 2;        // one 64-feature box
constexpr uint32_t kDqKTile = kDqBlockN * kD * 2;  // k, v or k_s: 16 KB
constexpr uint32_t kDqKHalf = kDqKTile / 2;
constexpr uint32_t kDqOffDo = kDqQTile, kDqOffStage = 2 * kDqQTile;
constexpr uint32_t kDqStageBytes = 3 * kDqKTile;  // k, v, k_s
constexpr uint32_t kDqOffBar = kDqOffStage + kDqStages * kDqStageBytes;
// barriers: q full and empty, then full and empty per stage
constexpr uint32_t kDqQFull = 0, kDqQEmpty = 8, kDqFull = 16, kDqEmpty = 16 + 8 * kDqStages;
constexpr int kDqSmemBytes = kDqOffBar + 128 + 1024;

struct DqArgs {
  const float* stats;  // [B*N, n_qt, 2, 64] (64-row tiles, as the dk/dv pass)
  const int* valid;    // null, or [B*N] key counts
  float* dq;           // [splits, B*N, Lq, 128] fp32
  int BN, N, Lq, Lk, n_qt, n_qt128, splits, n_tiles;
};

struct DqTile {
  int b, h, bh, qt, split, j0, j1, lk;
};

// tiles in (batch*head, split, q tile) order: the blocks in flight share
// one head's key range in L2
__device__ __forceinline__ DqTile dq_decode(int tile, const DqArgs& a) {
  DqTile t;
  const int per_head = a.splits * a.n_qt128;
  t.bh = tile / per_head;
  const int rem = tile - t.bh * per_head;
  t.split = rem / a.n_qt128;
  t.qt = rem - t.split * a.n_qt128;
  t.b = t.bh / a.N;
  t.h = t.bh - t.b * a.N;
  t.lk = a.valid != nullptr ? min(a.valid[t.bh], a.Lk) : a.Lk;
  const int nk = (t.lk + kDqBlockN - 1) / kDqBlockN;
  t.j0 = (int)((long long)t.split * nk / a.splits);
  t.j1 = (int)((long long)(t.split + 1) * nk / a.splits);
  return t;
}

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap qpmap,
                    const __grid_constant__ CUtensorMap domap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap ksmap, const DqArgs args) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar = base + kDqOffBar;

  if (threadIdx.x == 0) {
    mbar_init(bar + kDqQFull, 1);
    mbar_init(bar + kDqQEmpty, 8);  // one lane per consumer warp
    for (int i = 0; i < kDqStages; ++i) {
      mbar_init(bar + kDqFull + 8 * i, 1);
      mbar_init(bar + kDqEmpty + 8 * i, 8);
    }
    fence_barrier_init();
    prefetch_map(&qpmap);
    prefetch_map(&domap);
    prefetch_map(&kmap);
    prefetch_map(&vmap);
    prefetch_map(&ksmap);
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
    for (int tile = blockIdx.x; tile < args.n_tiles; tile += gridDim.x, ++it) {
      const DqTile t = dq_decode(tile, args);
      const int m0 = t.qt * kDqBlockM;
      mbar_wait(bar + kDqQEmpty, (it & 1) ^ 1);
      mbar_expect_tx(bar + kDqQFull, 2 * kDqQTile);
      tma_load_4d(base, &qpmap, bar + kDqQFull, 0, m0, t.h, t.b);
      tma_load_4d(base + kDqQHalf, &qpmap, bar + kDqQFull, 64, m0, t.h, t.b);
      tma_load_4d(base + kDqOffDo, &domap, bar + kDqQFull, 0, m0, t.h, t.b);
      tma_load_4d(base + kDqOffDo + kDqQHalf, &domap, bar + kDqQFull, 64, m0, t.h, t.b);
      for (int j = t.j0; j < t.j1; ++j) {
        const uint32_t sb = base + kDqOffStage + st * kDqStageBytes, full = bar + kDqFull + 8 * st;
        const int n0 = j * kDqBlockN;
        mbar_wait(bar + kDqEmpty + 8 * st, ph ^ 1);
        mbar_expect_tx(full, kDqStageBytes);
        tma_load_4d(sb, &kmap, full, 0, n0, t.h, t.b);
        tma_load_4d(sb + kDqKHalf, &kmap, full, 64, n0, t.h, t.b);
        tma_load_4d(sb + kDqKTile, &vmap, full, 0, n0, t.h, t.b);
        tma_load_4d(sb + kDqKTile + kDqKHalf, &vmap, full, 64, n0, t.h, t.b);
        tma_load_4d(sb + 2 * kDqKTile, &ksmap, full, 0, n0, t.h, t.b);
        tma_load_4d(sb + 2 * kDqKTile + kDqKHalf, &ksmap, full, 64, n0, t.h, t.b);
        if (++st == kDqStages) {
          st = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroups 1 and 2, 64 q rows each ----
  reg_alloc<240>();
  const int cw = wg - 1;
  const int wt = threadIdx.x & 127;
  const int lane = threadIdx.x & 31;
  const int wrow = (wt >> 5) * 16 + (lane >> 2);  // this thread's rows in its 64: wrow, wrow + 8
  const int key_lane = (lane & 3) * 2;             // its first key column in a group of 8
  const float inf = __int_as_float(0x7f800000);

  float s[32], dp[32], dq[64];
  uint32_t dsf[4][4];  // bf16(ds) of the previous key tile: the A fragments of dq += ds k_s
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) dsf[kk][0] = dsf[kk][1] = dsf[kk][2] = dsf[kk][3] = 0u;
  int st = 0;
  uint32_t ph = 0;
  int it = 0;
  for (int tile = blockIdx.x; tile < args.n_tiles; tile += gridDim.x, ++it) {
    const DqTile t = dq_decode(tile, args);
    // this warpgroup's 64 rows are statistics tile 2 qt + cw; rows past Lq
    // (and a tile past the last) have lse * log2e = +inf, so p = 0
    const int t64 = 2 * t.qt + cw;
    float lse2[2] = {inf, inf}, dlt[2] = {0.f, 0.f};
    if (t64 < args.n_qt) {
      const float* sp = args.stats + ((long long)t.bh * args.n_qt + t64) * (2 * kBlockM);
      lse2[0] = sp[wrow];
      lse2[1] = sp[wrow + 8];
      dlt[0] = sp[kBlockM + wrow];
      dlt[1] = sp[kBlockM + wrow + 8];
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) dq[i] = 0.f;
    mbar_wait(bar + kDqQFull, it & 1);
    const uint32_t sq = base + cw * 64 * 128, sdo = base + kDqOffDo + cw * 64 * 128;

    int prev = 0;
    // dq += bf16(ds) k_s for the key tile in stage `stage`
    auto issue_dq = [&](int stage) {
      const uint32_t sks = base + kDqOffStage + stage * kDqStageBytes + 2 * kDqKTile;
#pragma unroll
      for (int kk = 0; kk < kDqBlockN / 16; ++kk)
        wgmma_m64n128k16_rs<1>(dq, dsf[kk], desc_sw128(sks + kk * 2048, kDqKHalf >> 4, 64), 1);
      wgmma_commit();
    };
    for (int j = t.j0; j < t.j1; ++j) {
      const uint32_t sb = base + kDqOffStage + st * kDqStageBytes;
      mbar_wait(bar + kDqFull + 8 * st, ph);
      // s = q' k^T and dp = dO v^T over this tile's 64 keys; then dq of the
      // previous tile, in flight while p and ds are formed
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        wgmma_m64n64k16_ss<0, 0>(s, desc_sw128(sq + (kk >> 2) * kDqQHalf + (kk & 3) * 32, 1, 64),
                                 desc_sw128(sb + (kk >> 2) * kDqKHalf + (kk & 3) * 32, 1, 64),
                                 kk > 0);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        wgmma_m64n64k16_ss<0, 0>(
            dp, desc_sw128(sdo + (kk >> 2) * kDqQHalf + (kk & 3) * 32, 1, 64),
            desc_sw128(sb + kDqKTile + (kk >> 2) * kDqKHalf + (kk & 3) * 32, 1, 64), kk > 0);
      wgmma_commit();
      if (j > t.j0) issue_dq(prev);
      if (j > t.j0)
        wgmma_wait<1>();
      else
        wgmma_wait<0>();
      reg_fence(s);
      reg_fence(dp);

      // p = exp2(s - lse * log2e), keys at or past lk (only in the last
      // tile) at p = 0; ds = p (dp - delta), in place of dp
      const bool tail = j * kDqBlockN + kDqBlockN > t.lk;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int half = (i >> 1) & 1;
        float p = exp2_mufu(s[i] - lse2[half]);
        if (tail && j * kDqBlockN + (i >> 2) * 8 + key_lane + (i & 1) >= t.lk) p = 0.f;
        dp[i] = p * (dp[i] - dlt[half]);
      }

      // dq of the previous tile has retired: its stage returns to the
      // producer, and the A fragments are free to write
      wgmma_wait<0>();
      reg_fence(dq);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) reg_fence(dsf[kk]);
      if (j > t.j0 && lane == 0) mbar_arrive(bar + kDqEmpty + 8 * prev);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dsf[kk][i] = hyv::pack_bf16x2(dp[8 * kk + 2 * i], dp[8 * kk + 2 * i + 1]);
      prev = st;
      if (++st == kDqStages) {
        st = 0;
        ph ^= 1;
      }
    }
    if (t.j1 > t.j0) {
      wgmma_fence();
      issue_dq(prev);
      wgmma_wait<0>();
      reg_fence(dq);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) reg_fence(dsf[kk]);
      if (lane == 0) mbar_arrive(bar + kDqEmpty + 8 * prev);
    }
    // every product of the tile has retired: q' and dO return to the producer
    if (lane == 0) mbar_arrive(bar + kDqQEmpty);

    // dq (fp32) straight from the accumulator, rows past Lq dropped
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = t.qt * kDqBlockM + cw * 64 + wrow + 8 * half;
      if (row >= args.Lq) continue;
      float* dst =
          args.dq + (((long long)t.split * args.BN + t.bh) * args.Lq + row) * kD + key_lane;
#pragma unroll
      for (int jd = 0; jd < kD / 8; ++jd)
        *reinterpret_cast<float2*>(dst + 8 * jd) =
            make_float2(dq[4 * jd + 2 * half], dq[4 * jd + 2 * half + 1]);
    }
  }
}

// ---- prologue: q', q_s and the row statistics, one warp per q row; K5
// also k_s, one warp per key row, in the blocks past the q rows' ----

struct PrologueArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  const __nv_bfloat16* k;
  const float* lse;   // [B*N, Lq], natural units
  __nv_bfloat16* qp;  // [2, B*N, Lq, 128]: q', q_s
  __nv_bfloat16* ks;  // K5: [B*N, Lk, 128] k_s
  float* stats;       // [B*N, n_qt, 2, 64]
  long long q_sb, q_sh, q_sl, o_sb, o_sh, o_sl, do_sb, do_sh, do_sl, k_sb, k_sh, k_sl;
  int N, Lq, Lk, n_qt, q_blocks;
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

template <bool kSplit>
__global__ void __launch_bounds__(kPrologueWarps * 32)
flash_bwd_prologue_kernel(const PrologueArgs a) {
  const int lane = threadIdx.x & 31;
  const int bh = blockIdx.y, b = bh / a.N, h = bh - b * a.N;
  const int c = lane * 4;  // this lane's 4 features
  float f[4], g[4], t[4];
  if (kSplit && (int)blockIdx.x >= a.q_blocks) {
    // k_s = bf16(k * scale)
    const int n = ((int)blockIdx.x - a.q_blocks) * kPrologueWarps + (threadIdx.x >> 5);
    if (n >= a.Lk) return;
    unpack4(*reinterpret_cast<const uint2*>(a.k + b * a.k_sb + h * a.k_sh + n * a.k_sl + c), f);
#pragma unroll
    for (int e = 0; e < 4; ++e) t[e] = __fmul_rn(f[e], a.scale);
    *reinterpret_cast<uint2*>(a.ks + ((long long)bh * a.Lk + n) * kD + c) = pack4(t);
    return;
  }
  const int m = blockIdx.x * kPrologueWarps + (threadIdx.x >> 5);
  if (m >= a.n_qt * kBlockM) return;
  float lse2 = __int_as_float(0x7f800000), delta = 0.f;  // rows past Lq: p = 0
  if (m < a.Lq) {
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

struct Strides7 {  // element strides (batch, head, row) of q, k, v, o, dO, dk, dv
  long long q[3], k[3], v[3], o[3], dout[3], dk[3], dv[3];
};

// The prologue, then the dk/dv kernel (K4's with dq when merged, K5's first
// pass otherwise); dq is K4's fp32 accumulator (zeroed by the caller), and
// is not read by K5's pass. ks: K5's k_s scratch, formed by the prologue.
template <bool kMerged>
cudaError_t launch_prologue_and_kv(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, const void* valid,
                                   void* dq, void* dk, void* dv, void* qp, void* ks, void* stats,
                                   void* part, int B, int N, int Lq, int Lk, int splits,
                                   const Strides7& s, float qscale, float scale,
                                   cudaStream_t st) {
  const int BN = B * N, n_qt = (Lq + kBlockM - 1) / kBlockM;
  const int q_blocks = n_qt * kBlockM / kPrologueWarps;
  const int k_blocks = kMerged ? 0 : (Lk + kPrologueWarps - 1) / kPrologueWarps;
  const PrologueArgs pa{(const __nv_bfloat16*)q, (const __nv_bfloat16*)o,
                        (const __nv_bfloat16*)dout, (const __nv_bfloat16*)k, (const float*)lse,
                        (__nv_bfloat16*)qp, (__nv_bfloat16*)ks, (float*)stats,
                        s.q[0], s.q[1], s.q[2], s.o[0], s.o[1], s.o[2],
                        s.dout[0], s.dout[1], s.dout[2], s.k[0], s.k[1], s.k[2],
                        N, Lq, Lk, n_qt, q_blocks, qscale, scale};
  flash_bwd_prologue_kernel<!kMerged>
      <<<dim3(q_blocks + k_blocks, BN), kPrologueWarps * 32, 0, st>>>(pa);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const long long row = kD, head = (long long)Lq * kD, batch = (long long)N * Lq * kD;
  const __nv_bfloat16* qs = (const __nv_bfloat16*)qp + (long long)BN * Lq * kD;
  CUtensorMap kmap, vmap, qpmap, qsmap, domap, dqmap;
  if ((err = encode_bf16_rows(&kmap, k, Lk, N, B, s.k[2], s.k[1], s.k[0], kBlockN)) ||
      (err = encode_bf16_rows(&vmap, v, Lk, N, B, s.v[2], s.v[1], s.v[0], kBlockN)) ||
      (err = encode_bf16_rows(&qpmap, qp, Lq, N, B, row, head, batch, kBlockM)) ||
      (err = encode_bf16_rows(&qsmap, qs, Lq, N, B, row, head, batch, kBlockM)) ||
      (err = encode_bf16_rows(&domap, dout, Lq, N, B, s.dout[2], s.dout[1], s.dout[0],
                              kBlockM)))
    return err;
  if (kMerged && (err = encode_f32_rows(&dqmap, dq, Lq, N, B, row, head, batch, kBlockM)))
    return err;
  const KvArgs args{(const float*)stats, (const int*)valid, (__nv_bfloat16*)dk,
                    (__nv_bfloat16*)dv, (float*)part, s.dk[0], s.dk[1], s.dk[2],
                    s.dv[0], s.dv[1], s.dv[2], N, Lk, n_qt, splits, scale};
  const dim3 grid(((Lk + kBlockN - 1) / kBlockN) * splits, BN);
  if constexpr (kMerged) {
    err = cudaFuncSetAttribute(flash_bwd_merged_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMSmemBytes);
    if (err != cudaSuccess) return err;
    flash_bwd_merged_kernel<<<grid, kThreads, kMSmemBytes, st>>>(kmap, vmap, qpmap, qsmap,
                                                                 domap, dqmap, args);
  } else {
    err = cudaFuncSetAttribute(flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_kernel<<<grid, kThreads, kSmemBytes, st>>>(kmap, vmap, qpmap, qsmap, domap,
                                                             args);
  }
  return cudaGetLastError();
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
  const Strides7 s{{q_sb, q_sh, q_sl}, {k_sb, k_sh, k_sl}, {v_sb, v_sh, v_sl},
                   {o_sb, o_sh, o_sl}, {do_sb, do_sh, do_sl}, {dk_sb, dk_sh, dk_sl},
                   {dv_sb, dv_sh, dv_sl}};
  return (int)launch_prologue_and_kv<true>(q, k, v, o, dout, lse, valid, dq, dk, dv, qp, nullptr,
                                           stats, part, B, N, Lq, Lk, splits, s, qscale, scale,
                                           (cudaStream_t)stream);
}

// K5. Arguments as hyv_flash_bwd_merged's, but dq is [dq_splits, B*N, Lq,
// 128] fp32, written (not accumulated): one partial per split of the key
// range, for the caller to sum; kv_splits is the dk/dv pass's split of the
// q sweep (hyv_flash_bwd_merged's splits). Scratch: also ks [B*N, Lk, 128]
// bf16.
extern "C" int hyv_flash_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, const void* valid, void* dq, void* dk, void* dv, void* qp, void* ks,
    void* stats, void* part, int B, int N, int Lq, int Lk, int kv_splits, int dq_splits,
    long long q_sb, long long q_sh, long long q_sl,
    long long k_sb, long long k_sh, long long k_sl,
    long long v_sb, long long v_sh, long long v_sl,
    long long o_sb, long long o_sh, long long o_sl,
    long long do_sb, long long do_sh, long long do_sl,
    long long dk_sb, long long dk_sh, long long dk_sl,
    long long dv_sb, long long dv_sh, long long dv_sl,
    float qscale, float scale, void* stream) {
  if (Lk <= 0 || Lq <= 0 || kv_splits < 1 || dq_splits < 1) return (int)cudaErrorInvalidValue;
  if (B * N == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const Strides7 s{{q_sb, q_sh, q_sl}, {k_sb, k_sh, k_sl}, {v_sb, v_sh, v_sl},
                   {o_sb, o_sh, o_sl}, {do_sb, do_sh, do_sl}, {dk_sb, dk_sh, dk_sl},
                   {dv_sb, dv_sh, dv_sl}};
  cudaError_t err = launch_prologue_and_kv<false>(q, k, v, o, dout, lse, valid, nullptr, dk, dv,
                                                  qp, ks, stats, part, B, N, Lq, Lk, kv_splits,
                                                  s, qscale, scale, st);
  if (err != cudaSuccess) return (int)err;

  const int BN = B * N;
  const long long row = kD, head = (long long)Lq * kD, batch = (long long)N * Lq * kD;
  const long long khead = (long long)Lk * kD, kbatch = (long long)N * Lk * kD;
  CUtensorMap qpmap, domap, kmap, vmap, ksmap;
  if ((err = encode_bf16_rows(&qpmap, qp, Lq, N, B, row, head, batch, kDqBlockM)) ||
      (err = encode_bf16_rows(&domap, dout, Lq, N, B, do_sl, do_sh, do_sb, kDqBlockM)) ||
      (err = encode_bf16_rows(&kmap, k, Lk, N, B, k_sl, k_sh, k_sb, kDqBlockN)) ||
      (err = encode_bf16_rows(&vmap, v, Lk, N, B, v_sl, v_sh, v_sb, kDqBlockN)) ||
      (err = encode_bf16_rows(&ksmap, ks, Lk, N, B, row, khead, kbatch, kDqBlockN)))
    return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kDqSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int n_qt128 = (Lq + kDqBlockM - 1) / kDqBlockM;
  const int n_tiles = BN * dq_splits * n_qt128;
  const DqArgs args{(const float*)stats, (const int*)valid, (float*)dq, BN, N, Lq, Lk,
                    (Lq + kBlockM - 1) / kBlockM, n_qt128, dq_splits, n_tiles};
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  flash_bwd_dq_kernel<<<n_tiles < sms ? n_tiles : sms, kThreads, kDqSmemBytes, st>>>(
      qpmap, domap, kmap, vmap, ksmap, args);
  return (int)cudaGetLastError();
}

// the dynamic shared memory each block of the dk/dv kernel (K4, K5's first
// pass) and of K5's dq pass asks for, for reports
extern "C" int hyv_flash_bwd_merged_smem() { return kMSmemBytes; }
extern "C" int hyv_flash_bwd_dq_smem() { return kDqSmemBytes; }

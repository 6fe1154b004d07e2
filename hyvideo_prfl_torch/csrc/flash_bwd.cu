// K5: the split flash-attention backward, head_dim 128.
//
// Replaces hyvideo_prfl_tpu/ops/flash_attention.py _dq_kernel (:371;
// pallas_call at :775) and _dkv_kernel (:407; pallas_call at :798), both
// from _flash_bwd (:752): the split backward, a dq pass and a dk/dv pass.
// The route between it and the merged backward K4 (flash_bwd_merged.cu) is
// the JAX rule (flash_attention.py:763), taken by the Python wrapper: K4
// when the padded q range holds at least four of JAX's backward q blocks,
// K5 otherwise. Per (batch, head), both compute from the saved lse (the
// backward always recomputes, so the bounded and the shifted forward share
// it):
//
//   q' = bf16(q * scale * log2e),  s = q' k^T (fp32),  p = exp2(s - lse * log2e)
//   dv += bf16(p)^T dO,   dp = dO v^T,   ds = p * (dp - delta)
//   dk += bf16(ds)^T bf16(q * scale),   dq += bf16(ds) bf16(k * scale)
//
// with delta = rowsum(dO * o) computed by the caller from the bf16 o the
// forward wrote. Keys past lk and q rows past lq contribute nothing: their
// rows are zero-filled and their p is forced to 0 (the TPU zero-pads and
// lets pad rows carry harmless values instead). An optional int32 [B*N]
// valid length per (batch, head), the key mask of the shifted forward
// (the TPU's "user" mask, _apply_mask in :389, :429, :483), lowers lk for
// that head: p = 0 past it, so the gradients of masked keys are exactly 0,
// a dk/dv block whose keys are all masked writes zeros and stops, and the
// dq pass ends its key loop at the last valid tile.
//
// Bound on the H100: tensor-core math (seven products: the dq pass
// recomputes s and dp).
//
// Design (FlashAttention-2's backward on mma.sync m16n8k16, bf16 in, fp32
// accumulate; it keeps its first form, and the JAX rule sends no full-width
// call here):
// * dk/dv pass: a block of 8 warps owns 128 keys of one (batch, head) and
//   keeps their dk and dv in registers (each warp 16 keys x 128 features of
//   each) while it loops over all q tiles of 64 rows. It computes the
//   transposed products s^T = k q'^T and dp^T = v dO^T, so the fp32
//   accumulator fragments of p^T and ds^T are the A operands of dv and dk
//   directly, with no trip through shared memory.
// * dq pass: a block of 8 warps owns 128 q rows (16 per warp, q' fragments
//   in registers) and loops over key tiles of 64, recomputing s and dp; it
//   writes dq once, so K5 is deterministic.
// * q and k are read head-major [B, N, L, 128], v, dO token-major
//   [B, L, N, 128], all through strides with no transposes; q' and the two
//   scaled copies bf16(q * scale), bf16(k * scale) are formed in shared
//   memory from the raw tiles. The next q tile (or key tile) streams in by
//   cp.async while the current one computes.
#include "tensor_core.cuh"

namespace {

using hyv::acc_to_a;
using hyv::cp_async16;
using hyv::cp_async_commit;
using hyv::cp_async_wait;
using hyv::ldsm_x4;
using hyv::ldsm_x4_t;
using hyv::mma;
using hyv::pack_bf16x2;
using hyv::swz;

constexpr int kD = 128;
constexpr int kRowBytes = kD * 2;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {  // element strides of (batch, head, row); the feature stride is 1
  long long b, h, l;
};

struct BwdArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* lse;    // [B*N, Lq], natural units
  const float* delta;  // [B*N, Lq]
  const int* valid;    // null, or [B*N] key counts
  float* dq;           // [B*N, Lq, 128] fp32
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int N, Lq, Lk;
  Strides qs, ks, vs, dos, dks, dvs;
  float qscale;  // fp32(scale * log2e)
  float scale;   // fp32(scale)
};

// ---- dk/dv pass ---------------------------------------------------------

constexpr int kKvBlockN = 128;  // keys per block
constexpr int kKvBlockM = 64;   // q rows per iteration
constexpr int kKTile = kKvBlockN * kRowBytes;  // 32 KB
constexpr int kQTile = kKvBlockM * kRowBytes;  // 16 KB
// smem: K, V, Q', Qs, 2 x raw Q, 2 x dO, lse2/delta [64] each
constexpr int kOffK = 0;
constexpr int kOffV = kOffK + kKTile;
constexpr int kOffQ = kOffV + kKTile;
constexpr int kOffQs = kOffQ + kQTile;
constexpr int kOffQraw = kOffQs + kQTile;
constexpr int kOffDO = kOffQraw + 2 * kQTile;
constexpr int kOffLse = kOffDO + 2 * kQTile;
constexpr int kOffDelta = kOffLse + kKvBlockM * 4;
constexpr int kSmemDkv = kOffDelta + kKvBlockM * 4;

// acc[16 rows x 64 cols] (8 n-tiles) += A rows [16 x 128] . B rows [64 x 128]^T,
// both operands row-major tiles of 256 B rows in shared memory
__device__ __forceinline__ void gemm_rows_nt(uint32_t sA, int a_row0, uint32_t sB,
                                             int lane, float (*acc)[4]) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(sA + swz(a_row0 + (lane & 15), kk * 2 + (lane >> 4)), a[0], a[1], a[2], a[3]);
#pragma unroll
    for (int nn = 0; nn < 4; ++nn) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4(sB + swz(nn * 16 + (lane & 7) + ((lane >> 4) << 3), kk * 2 + ((lane >> 3) & 1)),
              b0, b1, b2, b3);
      mma(acc[2 * nn], a, b0, b1);
      mma(acc[2 * nn + 1], a, b2, b3);
    }
  }
}

// acc[16 rows x 128 features] (16 n-tiles) += P (fragments of 16 rows x 64,
// reduction over the 64) . B [64 x 128] held row-major in shared memory
__device__ __forceinline__ void gemm_frag_nn(const float (*p)[4], uint32_t sB, int lane,
                                             float (*acc)[4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    acc_to_a(p[2 * kk], p[2 * kk + 1], a);
#pragma unroll
    for (int dd = 0; dd < kD / 16; ++dd) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4_t(sB + swz(kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3), dd * 2 + (lane >> 4)),
                b0, b1, b2, b3);
      mma(acc[2 * dd], a, b0, b1);
      mma(acc[2 * dd + 1], a, b2, b3);
    }
  }
}

// bf16(x * scale) over 16 B chunks: src and dst tiles of 256 B rows
__device__ __forceinline__ void scale_chunk(const uint8_t* src, uint8_t* dst, float scale) {
  float f[8];
  hyv::unpack8(*reinterpret_cast<const uint4*>(src), f);
#pragma unroll
  for (int e = 0; e < 8; ++e) f[e] = __fmul_rn(f[e], scale);
  *reinterpret_cast<uint4*>(dst) = hyv::pack8(f);
}

__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dkv_kernel(BwdArgs args) {
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t sK = base + kOffK, sV = base + kOffV, sQ = base + kOffQ, sQs = base + kOffQs;
  float* sLse = reinterpret_cast<float*>(smem + kOffLse);
  float* sDelta = reinterpret_cast<float*>(smem + kOffDelta);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, b = bh / args.N, h = bh - b * args.N;
  const int n0 = blockIdx.x * kKvBlockN;
  const int Lq = args.Lq, Lk = args.Lk;
  const __nv_bfloat16* qp = args.q + b * args.qs.b + h * args.qs.h;
  const __nv_bfloat16* kp = args.k + b * args.ks.b + h * args.ks.h;
  const __nv_bfloat16* vp = args.v + b * args.vs.b + h * args.vs.h;
  const __nv_bfloat16* dop = args.dout + b * args.dos.b + h * args.dos.h;
  const float* lsep = args.lse + (long long)bh * Lq;
  const float* deltap = args.delta + (long long)bh * Lq;
  const int lk = args.valid != nullptr ? min(args.valid[bh], Lk) : Lk;
  if (n0 >= lk) {
    // every key of this block is masked: its dk and dv are zero
#pragma unroll
    for (int i = 0; i < kKvBlockN * 16 / kThreads; ++i) {
      const int idx = tid + i * kThreads, r = idx >> 4, c = idx & 15;
      if (n0 + r >= Lk) continue;
      const long long key = n0 + r;
      *reinterpret_cast<uint4*>(args.dk + b * args.dks.b + h * args.dks.h + key * args.dks.l +
                                c * 8) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(args.dv + b * args.dvs.b + h * args.dvs.h + key * args.dvs.l +
                                c * 8) = make_uint4(0, 0, 0, 0);
    }
    return;
  }

  // k, v tiles of this block (rows past Lk zero-filled)
#pragma unroll
  for (int i = 0; i < kKvBlockN * 16 / kThreads; ++i) {
    const int idx = tid + i * kThreads, r = idx >> 4, c = idx & 15;
    const bool valid = n0 + r < Lk;
    const long long key = valid ? n0 + r : 0;
    cp_async16(sK + swz(r, c), kp + key * args.ks.l + c * 8, valid);
    cp_async16(sV + swz(r, c), vp + key * args.vs.l + c * 8, valid);
  }
  cp_async_commit();

  const int n_qt = (Lq + kKvBlockM - 1) / kKvBlockM;
  auto load_q = [&](int qt, int stage) {
    const int m0 = qt * kKvBlockM;
#pragma unroll
    for (int i = 0; i < kKvBlockM * 16 / kThreads; ++i) {
      const int idx = tid + i * kThreads, r = idx >> 4, c = idx & 15;
      const bool valid = m0 + r < Lq;
      const long long row = valid ? m0 + r : 0;
      cp_async16(base + kOffQraw + stage * kQTile + swz(r, c), qp + row * args.qs.l + c * 8, valid);
      cp_async16(base + kOffDO + stage * kQTile + swz(r, c), dop + row * args.dos.l + c * 8, valid);
    }
  };
  // lse * log2e and delta of the next q tile, one row per thread of warps 0-1;
  // rows past Lq get +inf (so p = 0) and 0
  float lse_next = 0.f, delta_next = 0.f;
  auto fetch_stats = [&](int qt) {
    const int row = qt * kKvBlockM + tid;
    if (tid < kKvBlockM) {
      const bool valid = row < Lq;
      lse_next = valid ? __fmul_rn(lsep[row], kLog2e) : __int_as_float(0x7f800000);
      delta_next = valid ? deltap[row] : 0.f;
    }
  };
  load_q(0, 0);
  cp_async_commit();
  fetch_stats(0);

  const int kr0 = warp * 16;  // this warp's 16 keys inside the block's 128
  float dk[kD / 8][4], dv[kD / 8][4];
#pragma unroll
  for (int t = 0; t < kD / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[t][e] = dv[t][e] = 0.f;

  for (int qt = 0; qt < n_qt; ++qt) {
    const int st = qt & 1;
    cp_async_wait<0>();
    __syncthreads();  // this tile landed; every warp is done with the last one
#pragma unroll
    for (int i = 0; i < kKvBlockM * 16 / kThreads; ++i) {
      const int idx = tid + i * kThreads, r = idx >> 4, c = idx & 15;
      const uint8_t* raw = smem + kOffQraw + st * kQTile + swz(r, c);
      scale_chunk(raw, smem + kOffQ + swz(r, c), args.qscale);
      scale_chunk(raw, smem + kOffQs + swz(r, c), args.scale);
    }
    if (tid < kKvBlockM) {
      sLse[tid] = lse_next;
      sDelta[tid] = delta_next;
    }
    if (qt + 1 < n_qt) {
      load_q(qt + 1, st ^ 1);
      fetch_stats(qt + 1);
    }
    cp_async_commit();
    __syncthreads();

    const uint32_t sDO = base + kOffDO + st * kQTile;
    // s^T = k q'^T: this warp's 16 keys x the tile's 64 q rows
    float p[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t) p[t][0] = p[t][1] = p[t][2] = p[t][3] = 0.f;
    gemm_rows_nt(sK, kr0, sQ, lane, p);
    const int key_hi = n0 + kr0 + (lane >> 2);  // fragment row of e < 2; +8 for e >= 2
#pragma unroll
    for (int t = 0; t < 8; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = t * 8 + (lane & 3) * 2 + (e & 1);
        float pv = exp2f(p[t][e] - sLse[qc]);
        if (key_hi + 8 * (e >> 1) >= lk) pv = 0.f;
        p[t][e] = pv;
      }
    }
    // dv += bf16(p)^T dO
    gemm_frag_nn(p, sDO, lane, dv);
    // dp^T = v dO^T, then ds^T = p^T (dp^T - delta)
    float ds[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t) ds[t][0] = ds[t][1] = ds[t][2] = ds[t][3] = 0.f;
    gemm_rows_nt(sV, kr0, sDO, lane, ds);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = t * 8 + (lane & 3) * 2 + (e & 1);
        ds[t][e] = p[t][e] * (ds[t][e] - sDelta[qc]);
      }
    }
    // dk += bf16(ds)^T bf16(q * scale)
    gemm_frag_nn(ds, sQs, lane, dk);
  }

  // epilogue: dk head-major, dv token-major, bf16; rows past Lk are dropped
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = n0 + kr0 + (lane >> 2) + 8 * half;
    if (key >= Lk) continue;
    __nv_bfloat16* dkr = args.dk + b * args.dks.b + h * args.dks.h + key * args.dks.l;
    __nv_bfloat16* dvr = args.dv + b * args.dvs.b + h * args.dvs.h + key * args.dvs.l;
#pragma unroll
    for (int t = 0; t < kD / 8; ++t) {
      const int d = t * 8 + (lane & 3) * 2;
      *reinterpret_cast<uint32_t*>(dkr + d) = pack_bf16x2(dk[t][2 * half], dk[t][2 * half + 1]);
      *reinterpret_cast<uint32_t*>(dvr + d) = pack_bf16x2(dv[t][2 * half], dv[t][2 * half + 1]);
    }
  }
}

// ---- K5's dq pass ---------------------------------------------------------

constexpr int kDqBlockM = 128;  // q rows per block, 16 per warp
constexpr int kDqBlockN = 64;   // keys per iteration
constexpr int kKvTile = kDqBlockN * kRowBytes;  // 16 KB
constexpr int kDqOffQ = 0;
constexpr int kDqOffDO = kDqOffQ + kDqBlockM * kRowBytes;
constexpr int kDqOffK = kDqOffDO + kDqBlockM * kRowBytes;  // 2 stages
constexpr int kDqOffV = kDqOffK + 2 * kKvTile;             // 2 stages
constexpr int kDqOffKs = kDqOffV + 2 * kKvTile;
constexpr int kSmemDq = kDqOffKs + kKvTile;

__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq_kernel(BwdArgs args) {
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t sQ = base + kDqOffQ, sDO = base + kDqOffDO, sKs = base + kDqOffKs;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, b = bh / args.N, h = bh - b * args.N;
  const int m0 = blockIdx.x * kDqBlockM;
  const int Lq = args.Lq, Lk = args.Lk;
  const __nv_bfloat16* qp = args.q + b * args.qs.b + h * args.qs.h;
  const __nv_bfloat16* kp = args.k + b * args.ks.b + h * args.ks.h;
  const __nv_bfloat16* vp = args.v + b * args.vs.b + h * args.vs.h;
  const __nv_bfloat16* dop = args.dout + b * args.dos.b + h * args.dos.h;

  auto load_kv = [&](int tile, int stage) {
    const int n0 = tile * kDqBlockN;
#pragma unroll
    for (int i = 0; i < kDqBlockN * 16 / kThreads; ++i) {
      const int idx = tid + i * kThreads, r = idx >> 4, c = idx & 15;
      const bool valid = n0 + r < Lk;
      const long long key = valid ? n0 + r : 0;
      cp_async16(base + kDqOffK + stage * kKvTile + swz(r, c), kp + key * args.ks.l + c * 8, valid);
      cp_async16(base + kDqOffV + stage * kKvTile + swz(r, c), vp + key * args.vs.l + c * 8, valid);
    }
  };
  // dO rows by cp.async, q rows through registers into q'
#pragma unroll
  for (int i = 0; i < kDqBlockM * 16 / kThreads; ++i) {
    const int idx = tid + i * kThreads, r = idx >> 4, c = idx & 15;
    const bool valid = m0 + r < Lq;
    const long long row = valid ? m0 + r : 0;
    cp_async16(sDO + swz(r, c), dop + row * args.dos.l + c * 8, valid);
  }
  load_kv(0, 0);
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < kDqBlockM * 16 / kThreads; ++i) {
    const int idx = tid + i * kThreads, r = idx >> 4, c = idx & 15;
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (m0 + r < Lq) {
      hyv::unpack8(*reinterpret_cast<const uint4*>(qp + (long long)(m0 + r) * args.qs.l + c * 8), f);
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = __fmul_rn(f[e], args.qscale);
    }
    *reinterpret_cast<uint4*>(smem + kDqOffQ + swz(r, c)) = hyv::pack8(f);
  }

  const int wr = warp * 16;
  float lse2[2], dlt[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = m0 + wr + (lane >> 2) + 8 * half;
    const bool valid = row < Lq;
    lse2[half] = valid ? __fmul_rn(args.lse[(long long)bh * Lq + row], kLog2e)
                       : __int_as_float(0x7f800000);
    dlt[half] = valid ? args.delta[(long long)bh * Lq + row] : 0.f;
  }
  __syncthreads();
  uint32_t qf[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    ldsm_x4(sQ + swz(wr + (lane & 15), kk * 2 + (lane >> 4)), qf[kk][0], qf[kk][1], qf[kk][2],
            qf[kk][3]);

  float acc[kD / 8][4];
#pragma unroll
  for (int t = 0; t < kD / 8; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

  const int lk = args.valid != nullptr ? min(args.valid[bh], Lk) : Lk;
  const int n_tiles = (lk + kDqBlockN - 1) / kDqBlockN;
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile j landed; every warp is done with tile j-1
    const uint32_t sK = base + kDqOffK + st * kKvTile, sV = base + kDqOffV + st * kKvTile;
#pragma unroll
    for (int i = 0; i < kDqBlockN * 16 / kThreads; ++i) {
      const int idx = tid + i * kThreads, r = idx >> 4, c = idx & 15;
      scale_chunk(smem + kDqOffK + st * kKvTile + swz(r, c), smem + kDqOffKs + swz(r, c),
                  args.scale);
    }
    if (j + 1 < n_tiles) load_kv(j + 1, st ^ 1);
    cp_async_commit();
    __syncthreads();

    // s = q' k^T: 16 q rows x 64 keys per warp
    float p[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t) p[t][0] = p[t][1] = p[t][2] = p[t][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(sK + swz(nn * 16 + (lane & 7) + ((lane >> 4) << 3), kk * 2 + ((lane >> 3) & 1)),
                b0, b1, b2, b3);
        mma(p[2 * nn], qf[kk], b0, b1);
        mma(p[2 * nn + 1], qf[kk], b2, b3);
      }
    }
    const int key0 = j * kDqBlockN + (lane & 3) * 2;
    const bool tail = j * kDqBlockN + kDqBlockN > lk;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pv = exp2f(p[t][e] - lse2[e >> 1]);
        if (tail && key0 + t * 8 + (e & 1) >= lk) pv = 0.f;
        p[t][e] = pv;
      }
    }
    // dp = dO v^T, ds = p (dp - delta)
    float ds[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t) ds[t][0] = ds[t][1] = ds[t][2] = ds[t][3] = 0.f;
    gemm_rows_nt(sDO, wr, sV, lane, ds);
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[t][e] = p[t][e] * (ds[t][e] - dlt[e >> 1]);
    // dq += bf16(ds) bf16(k * scale)
    gemm_frag_nn(ds, sKs, lane, acc);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = m0 + wr + (lane >> 2) + 8 * half;
    if (row >= Lq) continue;
    float* dst = args.dq + ((long long)bh * Lq + row) * kD + (lane & 3) * 2;
#pragma unroll
    for (int t = 0; t < kD / 8; ++t)
      *reinterpret_cast<float2*>(dst + t * 8) = make_float2(acc[t][2 * half], acc[t][2 * half + 1]);
  }
}

template <typename K>
cudaError_t launch(K kernel, dim3 grid, int smem_bytes, cudaStream_t st, const BwdArgs& args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem_bytes, st>>>(args);
  return cudaGetLastError();
}

}  // namespace

// q [B, N, Lq, 128], k [B, N, Lk, 128] head-major; v [B, Lk, N, 128], dO
// [B, Lq, N, 128] token-major; all bf16 by element strides (feature stride
// 1, rows 16 B aligned). lse, delta [B*N, Lq] fp32. dq [B*N, Lq, 128] fp32,
// written. dk [B, N, Lk, 128] and dv [B, Lk, N, 128] bf16 by strides.
// valid: null, or int32 [B*N] key counts (>= 1), the forward's key mask.
extern "C" int hyv_flash_bwd(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dq, void* dk, void* dv, const void* valid,
    int B, int N, int Lq, int Lk,
    long long q_sb, long long q_sh, long long q_sl,
    long long k_sb, long long k_sh, long long k_sl,
    long long v_sb, long long v_sh, long long v_sl,
    long long do_sb, long long do_sh, long long do_sl,
    long long dk_sb, long long dk_sh, long long dk_sl,
    long long dv_sb, long long dv_sh, long long dv_sl,
    float qscale, float scale, void* stream) {
  if (Lk <= 0 || Lq <= 0) return (int)cudaErrorInvalidValue;
  if (B * N == 0) return 0;
  BwdArgs args{(const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
               (const __nv_bfloat16*)dout, (const float*)lse, (const float*)delta,
               (const int*)valid, (float*)dq, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, N, Lq, Lk,
               Strides{q_sb, q_sh, q_sl}, Strides{k_sb, k_sh, k_sl}, Strides{v_sb, v_sh, v_sl},
               Strides{do_sb, do_sh, do_sl}, Strides{dk_sb, dk_sh, dk_sl},
               Strides{dv_sb, dv_sh, dv_sl}, qscale, scale};
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid_kv((Lk + kKvBlockN - 1) / kKvBlockN, B * N);
  cudaError_t err = launch(flash_bwd_dkv_kernel, grid_kv, kSmemDkv, st, args);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_q((Lq + kDqBlockM - 1) / kDqBlockM, B * N);
  return (int)launch(flash_bwd_dq_kernel, grid_q, kSmemDq, st, args);
}

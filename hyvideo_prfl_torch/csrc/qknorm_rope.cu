// K6: fused qk-RMSNorm (+ rolled-half RoPE) forward, head-major output.
//
// Replaces hyvideo_prfl_tpu/ops/qknorm_rope.py _fwd_kernel (pallas_call at
// qknorm_rope.py:155, launched by _fwd_call), both modes: with rope for
// self-attention q/k (rmsnorm_rope) and without for the cross-attention
// q/k norms (rmsnorm_only). Math, per token row of M = N * 128 features:
//
//   r   = rsqrt(mean(x^2 over all M) + eps)              fp32
//   t   = bf16(bf16(x * r) * bf16(w))
//   out = bf16(f32(t) * C[l] + roll(f32(t), 64) * S[l])  (rope mode)
//
// and out is written as [B, N, L, 128], the attention kernel's q/k layout.
//
// Bound on the H100: bytes. One bf16 read and one bf16 write per element,
// plus the [L, 128] fp32 tables, which rows of the batch share through L2.
//
// Design: the row layouts of row_norm.cuh over 16 B chunks (8 features) of
// the row, M / 8 = 16 N chunks. Narrow rows (N <= 16) take one warp each,
// four rows to a block; wide rows (16 < N <= 64, the 14B width N = 40 among
// them) a block of 8 warps each. Thread t of a row keeps chunks
// t + kRowThreads i in registers, so x is read once: the sum of squares
// is one row sum. Because a head is 16 chunks and kRowThreads is a
// multiple of 16, a thread's chunks all sit at chunk t % 16 of their heads,
// and the rope partner at +64 features is chunk (t % 16) ^ 8 of the same
// head: lane ^ 8 holds it, one shuffle away. An odd N leaves the upper 16
// lanes of a warp without a chunk in the last pass; they shuffle zeros and
// store nothing. The chunk count is a runtime bound under a ceiling of
// 2, 4, 6 or 8 chunks a lane (narrow, the smallest that holds the row) or
// 4 a thread (wide), fixed at compile time where the row fills a narrow
// ceiling (N 4, 8, 12, 16), as in K8. Stores are 16 B per lane into the
// head-major output.
#include "row_norm.cuh"

namespace {

template <int W, int kCmax, bool kExact, bool kRope>
__global__ void __launch_bounds__(hyv::RowLayout<W>::kThreads)
rmsnorm_rope_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ ctab, const float* __restrict__ stab,
                    __nv_bfloat16* __restrict__ out, long long rows, int L, int n_arg,
                    float eps) {
  using Layout = hyv::RowLayout<W>;
  const int N = kExact ? kCmax * Layout::kRowThreads / 16 : n_arg;
  __shared__ __align__(16) float red[Layout::kRedFloats];
  const int M = N * 128, n_chunks = N * 16;
  const int tg = Layout::thread_in_row();
  const long long row = (long long)blockIdx.x * Layout::kRows + Layout::row_in_block();
  if (row >= rows) return;  // narrow only: a wide block is one row
  const long long b = row / L;
  const int l = (int)(row - b * L);
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * M);

  uint4 raw[kCmax];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kCmax; ++i) {
    const int chunk = tg + Layout::kRowThreads * i;
    raw[i] = kExact || chunk < n_chunks ? __ldcs(xr + chunk) : make_uint4(0u, 0u, 0u, 0u);
    float f[8];
    hyv::unpack8(raw[i], f);
#pragma unroll
    for (int e = 0; e < 8; ++e) ss += f[e] * f[e];
  }
  int par = 0;
  const float r = 1.0f / sqrtf(Layout::row_sum(ss, red, par) * (1.0f / M) + eps);

  const int d0 = (tg & 15) * 8;  // feature offset inside the head
  float cs[8], sn[8];
  if constexpr (kRope) {
    const float4* cr = reinterpret_cast<const float4*>(ctab + (long long)l * 128 + d0);
    const float4* sr = reinterpret_cast<const float4*>(stab + (long long)l * 128 + d0);
    const float4 c0 = __ldg(cr), c1 = __ldg(cr + 1), s0 = __ldg(sr), s1 = __ldg(sr + 1);
    cs[0] = c0.x; cs[1] = c0.y; cs[2] = c0.z; cs[3] = c0.w;
    cs[4] = c1.x; cs[5] = c1.y; cs[6] = c1.z; cs[7] = c1.w;
    sn[0] = s0.x; sn[1] = s0.y; sn[2] = s0.z; sn[3] = s0.w;
    sn[4] = s1.x; sn[5] = s1.y; sn[6] = s1.z; sn[7] = s1.w;
  }
#pragma unroll
  for (int i = 0; i < kCmax; ++i) {
    const int chunk = tg + Layout::kRowThreads * i;
    const bool mine = kExact || chunk < n_chunks;
    const int h = chunk >> 4;
    float f[8], tv[8];
    hyv::unpack8(raw[i], f);
    // predicated, not branched: the pass's loads issue together
    const float4* wr = reinterpret_cast<const float4*>(w + chunk * 8);
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 w0 = mine ? __ldg(wr) : zero, w1 = mine ? __ldg(wr + 1) : zero;
    const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
    for (int e = 0; e < 8; ++e)
      tv[e] = hyv::bf16_round(__fmul_rn(hyv::bf16_round(__fmul_rn(f[e], r)),
                                        hyv::bf16_round(wv[e])));
    uint4 o;
    if constexpr (kRope) {
      uint4 mine_raw = hyv::pack8(tv);  // exact: tv already holds bf16 values
      uint4 other;
      other.x = __shfl_xor_sync(0xffffffffu, mine_raw.x, 8);
      other.y = __shfl_xor_sync(0xffffffffu, mine_raw.y, 8);
      other.z = __shfl_xor_sync(0xffffffffu, mine_raw.z, 8);
      other.w = __shfl_xor_sync(0xffffffffu, mine_raw.w, 8);
      float pv[8], y[8];
      hyv::unpack8(other, pv);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        y[e] = __fadd_rn(__fmul_rn(tv[e], cs[e]), __fmul_rn(pv[e], sn[e]));
      o = hyv::pack8(y);
    } else {
      o = hyv::pack8(tv);
    }
    // an explicit 16 B store: left to the compiler, the uint4 copy was
    // split into four 4 B stores, which cost K6 3.7% at width 1536 on an H100
    uint4* dst = reinterpret_cast<uint4*>(out + ((b * N + h) * (long long)L + l) * 128 + d0);
    if (mine) __stwb(dst, o);
  }
}

template <int W, int kCmax, bool kExact>
cudaError_t launch(const void* x, const void* w, const void* c, const void* s,
                   void* out, long long rows, int L, int N, float eps, int rope,
                   cudaStream_t st) {
  using Layout = hyv::RowLayout<W>;
  const dim3 grid((unsigned)((rows + Layout::kRows - 1) / Layout::kRows));
  const auto* xp = (const __nv_bfloat16*)x;
  auto* op = (__nv_bfloat16*)out;
  if (rope) {
    rmsnorm_rope_kernel<W, kCmax, kExact, true><<<grid, Layout::kThreads, 0, st>>>(
        xp, (const float*)w, (const float*)c, (const float*)s, op, rows, L, N, eps);
  } else {
    rmsnorm_rope_kernel<W, kCmax, kExact, false><<<grid, Layout::kThreads, 0, st>>>(
        xp, (const float*)w, nullptr, nullptr, op, rows, L, N, eps);
  }
  return cudaGetLastError();
}

// a narrow tier: the row fills it exactly (compile-time chunk count, no
// guards) or not
template <int kCmax>
cudaError_t launch_tier(const void* x, const void* w, const void* c, const void* s,
                        void* out, long long rows, int L, int N, float eps, int rope,
                        cudaStream_t st) {
  return N == 2 * kCmax ? launch<1, kCmax, true>(x, w, c, s, out, rows, L, N, eps, rope, st)
                        : launch<1, kCmax, false>(x, w, c, s, out, rows, L, N, eps, rope, st);
}

}  // namespace

// x [B, L, N*128] bf16; w [N*128] fp32; c, s [L, 128] fp32 (ignored unless
// rope); out [B, N, L, 128] bf16. N from 1 to 64.
extern "C" int hyv_rmsnorm_rope(const void* x, const void* w, const void* c,
                                const void* s, void* out, int B, int L, int N,
                                int D, float eps, int rope, void* stream) {
  if (D != 128 || N < 1 || N > 64) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * L;
  cudaStream_t st = (cudaStream_t)stream;
  if (rows == 0) return 0;
  const int cl = (N + 1) / 2;  // chunks per lane of one warp
  if (cl <= 2) return launch_tier<2>(x, w, c, s, out, rows, L, N, eps, rope, st);
  if (cl <= 4) return launch_tier<4>(x, w, c, s, out, rows, L, N, eps, rope, st);
  if (cl <= 6) return launch_tier<6>(x, w, c, s, out, rows, L, N, eps, rope, st);
  if (cl <= 8) return launch_tier<8>(x, w, c, s, out, rows, L, N, eps, rope, st);
  return launch<hyv::kWideWarps, 4, false>(x, w, c, s, out, rows, L, N, eps, rope, st);
}

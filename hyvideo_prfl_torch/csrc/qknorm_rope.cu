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
// Design: one warp per token row. A lane owns 16-byte chunks
// lane + 32 i (8 features each) and keeps them in registers, so x is read
// once: the sum of squares is one warp-shuffle reduction. Because a head
// is 16 chunks and 32 i is a multiple of 16, a lane's chunks all sit at
// chunk lane % 16 of their heads, and the rope partner at +64 features is
// chunk (lane % 16) ^ 8 of the same head: lane ^ 8 holds it, one shuffle
// away. Stores are 16 B per lane into the head-major output.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;

template <int C, bool kRope>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_rope_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ ctab, const float* __restrict__ stab,
                    __nv_bfloat16* __restrict__ out, long long rows, int L, int N,
                    float eps) {
  constexpr int M = C * 256;  // C chunks of 8 per lane, 32 lanes
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + warp;
  if (row >= rows) return;
  const long long b = row / L;
  const int l = (int)(row - b * L);
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * M);

  uint4 raw[C];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    raw[i] = __ldcs(xr + lane + 32 * i);
    float f[8];
    hyv::unpack8(raw[i], f);
#pragma unroll
    for (int e = 0; e < 8; ++e) ss += f[e] * f[e];
  }
  const float r = 1.0f / sqrtf(hyv::warp_sum(ss) * (1.0f / M) + eps);

  const int d0 = (lane & 15) * 8;  // feature offset inside the head
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
  for (int i = 0; i < C; ++i) {
    const int chunk = lane + 32 * i;
    const int h = chunk >> 4;
    float f[8], tv[8];
    hyv::unpack8(raw[i], f);
    const float4* wr = reinterpret_cast<const float4*>(w + chunk * 8);
    const float4 w0 = __ldg(wr), w1 = __ldg(wr + 1);
    const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
    for (int e = 0; e < 8; ++e)
      tv[e] = hyv::bf16_round(__fmul_rn(hyv::bf16_round(__fmul_rn(f[e], r)),
                                        hyv::bf16_round(wv[e])));
    uint4 o;
    if constexpr (kRope) {
      uint4 mine = hyv::pack8(tv);  // exact: tv already holds bf16 values
      uint4 other;
      other.x = __shfl_xor_sync(0xffffffffu, mine.x, 8);
      other.y = __shfl_xor_sync(0xffffffffu, mine.y, 8);
      other.z = __shfl_xor_sync(0xffffffffu, mine.z, 8);
      other.w = __shfl_xor_sync(0xffffffffu, mine.w, 8);
      float pv[8], y[8];
      hyv::unpack8(other, pv);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        y[e] = __fadd_rn(__fmul_rn(tv[e], cs[e]), __fmul_rn(pv[e], sn[e]));
      o = hyv::pack8(y);
    } else {
      o = hyv::pack8(tv);
    }
    __nv_bfloat16* dst = out + (((b * N + h) * (long long)L + l) * 128 + d0);
    *reinterpret_cast<uint4*>(dst) = o;
  }
}

template <int C>
cudaError_t launch(const void* x, const void* w, const void* c, const void* s,
                   void* out, long long rows, int L, int N, float eps, int rope,
                   cudaStream_t st) {
  const dim3 grid((unsigned)((rows + kWarps - 1) / kWarps));
  const auto* xp = (const __nv_bfloat16*)x;
  auto* op = (__nv_bfloat16*)out;
  if (rope) {
    rmsnorm_rope_kernel<C, true><<<grid, kWarps * 32, 0, st>>>(
        xp, (const float*)w, (const float*)c, (const float*)s, op, rows, L, N, eps);
  } else {
    rmsnorm_rope_kernel<C, false><<<grid, kWarps * 32, 0, st>>>(
        xp, (const float*)w, nullptr, nullptr, op, rows, L, N, eps);
  }
  return cudaGetLastError();
}

}  // namespace

// x [B, L, N*128] bf16; w [N*128] fp32; c, s [L, 128] fp32 (ignored unless
// rope); out [B, N, L, 128] bf16.
extern "C" int hyv_rmsnorm_rope(const void* x, const void* w, const void* c,
                                const void* s, void* out, int B, int L, int N,
                                int D, float eps, int rope, void* stream) {
  if (D != 128) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * L;
  cudaStream_t st = (cudaStream_t)stream;
  if (rows == 0) return 0;
  switch (N) {  // chunks per lane = N * 128 / 256
    case 2: return launch<1>(x, w, c, s, out, rows, L, N, eps, rope, st);
    case 4: return launch<2>(x, w, c, s, out, rows, L, N, eps, rope, st);
    case 8: return launch<4>(x, w, c, s, out, rows, L, N, eps, rope, st);
    case 12: return launch<6>(x, w, c, s, out, rows, L, N, eps, rope, st);
    case 16: return launch<8>(x, w, c, s, out, rows, L, N, eps, rope, st);
    case 40: return launch<20>(x, w, c, s, out, rows, L, N, eps, rope, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

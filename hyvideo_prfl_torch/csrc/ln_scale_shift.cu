// K8: fused LayerNorm + scale/shift forward, out = LN(x) * s[b] + t[b].
//
// Replaces hyvideo_prfl_tpu/ops/stream.py _fwd_kernel (pallas_call at
// stream.py:130, launched by _fwd_call). The DiT runs it three times per
// block on the fp32 residual stream (bf16 out) and once at the head (fp32
// out).
//
// Bound on the H100: bytes. Per row it reads D fp32 and writes D outputs
// and does ~10 flops per element, far under the ~295 flop/byte line, so
// the floor is one read of x plus one write at 3.35 TB/s.
//
// Design: one warp per row. Each lane keeps its D/128 float4 chunks in
// registers, so x is read from device memory once: the mean and the
// variance are two warp-shuffle reductions over the registers (two-pass
// variance, as the TPU kernel and its XLA reference compute it), then the
// normalise/modulate pass writes straight out. Loads are 16 B per lane on
// neighbouring addresses. No shared memory, no block-level sync.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;

template <int V, typename OutT>
__global__ void __launch_bounds__(kWarps * 32)
ln_scale_shift_kernel(const float* __restrict__ x, const float* __restrict__ s,
                      const float* __restrict__ t, OutT* __restrict__ out,
                      long long rows, int L, float eps) {
  constexpr int D = V * 128;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + warp;
  if (row >= rows) return;
  const long long b = row / L;
  const float4* xr = reinterpret_cast<const float4*>(x + row * D);

  float4 v[V];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    v[i] = __ldcs(xr + lane + 32 * i);  // read once: stream past L2
    sum += (v[i].x + v[i].y) + (v[i].z + v[i].w);
  }
  const float mean = hyv::warp_sum(sum) * (1.0f / D);
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    v[i].x -= mean; v[i].y -= mean; v[i].z -= mean; v[i].w -= mean;
    sq += (v[i].x * v[i].x + v[i].y * v[i].y) + (v[i].z * v[i].z + v[i].w * v[i].w);
  }
  const float rstd = 1.0f / sqrtf(hyv::warp_sum(sq) * (1.0f / D) + eps);

  const float4* sr = reinterpret_cast<const float4*>(s + b * D);
  const float4* tr = reinterpret_cast<const float4*>(t + b * D);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = lane + 32 * i;
    const float4 sv = __ldg(sr + c), tv = __ldg(tr + c);
    // (xc * rstd) * s + t with no fused multiply-add, as the reference rounds
    float y[4];
    y[0] = __fadd_rn(__fmul_rn(__fmul_rn(v[i].x, rstd), sv.x), tv.x);
    y[1] = __fadd_rn(__fmul_rn(__fmul_rn(v[i].y, rstd), sv.y), tv.y);
    y[2] = __fadd_rn(__fmul_rn(__fmul_rn(v[i].z, rstd), sv.z), tv.z);
    y[3] = __fadd_rn(__fmul_rn(__fmul_rn(v[i].w, rstd), sv.w), tv.w);
    if constexpr (sizeof(OutT) == 4) {
      reinterpret_cast<float4*>(out + row * D)[c] = make_float4(y[0], y[1], y[2], y[3]);
    } else {
      uint2 pk;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&pk);
      h[0] = __floats2bfloat162_rn(y[0], y[1]);
      h[1] = __floats2bfloat162_rn(y[2], y[3]);
      reinterpret_cast<uint2*>(out + row * D)[c] = pk;
    }
  }
}

template <int V>
cudaError_t launch(const void* x, const void* s, const void* t, void* out,
                   long long rows, int L, float eps, int out_bf16,
                   cudaStream_t st) {
  const dim3 grid((unsigned)((rows + kWarps - 1) / kWarps));
  if (out_bf16) {
    ln_scale_shift_kernel<V, __nv_bfloat16><<<grid, kWarps * 32, 0, st>>>(
        (const float*)x, (const float*)s, (const float*)t, (__nv_bfloat16*)out,
        rows, L, eps);
  } else {
    ln_scale_shift_kernel<V, float><<<grid, kWarps * 32, 0, st>>>(
        (const float*)x, (const float*)s, (const float*)t, (float*)out,
        rows, L, eps);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* hyv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// x [B, L, D] fp32; s, t [B, D] fp32; out [B, L, D] bf16 (out_bf16) or fp32.
extern "C" int hyv_ln_scale_shift(const void* x, const void* s, const void* t,
                                  void* out, int B, int L, int D, float eps,
                                  int out_bf16, void* stream) {
  const long long rows = (long long)B * L;
  cudaStream_t st = (cudaStream_t)stream;
  if (rows == 0) return 0;
  switch (D) {
    case 128: return launch<1>(x, s, t, out, rows, L, eps, out_bf16, st);
    case 256: return launch<2>(x, s, t, out, rows, L, eps, out_bf16, st);
    case 512: return launch<4>(x, s, t, out, rows, L, eps, out_bf16, st);
    case 1024: return launch<8>(x, s, t, out, rows, L, eps, out_bf16, st);
    case 1536: return launch<12>(x, s, t, out, rows, L, eps, out_bf16, st);
    case 2048: return launch<16>(x, s, t, out, rows, L, eps, out_bf16, st);
    case 5120: return launch<40>(x, s, t, out, rows, L, eps, out_bf16, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

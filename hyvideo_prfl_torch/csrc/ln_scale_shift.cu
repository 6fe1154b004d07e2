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
// Design: a row of D = 128 c features is c float4 chunks per lane of one
// warp. Narrow rows (D <= 2048) take one warp each, four rows to a block
// of 4 warps: each lane keeps its c float4 chunks in registers, so x is
// read from device memory once and the mean and the variance are two
// warp-shuffle reductions over the registers (two-pass variance, as the
// TPU kernel and its XLA reference compute it); then the normalise /
// modulate pass writes straight out. Wide rows (2048 < D <= 8192, the 14B
// width 5120 among them) would need 4 D / 128 registers a lane that way,
// so a block of 8 warps takes one row: thread t holds chunks t + 256 i,
// and the two row sums go through shared memory (each warp's shuffle sum,
// then the 8 partials in a fixed order). In both layouts c is a runtime
// bound under a compile-time ceiling (kVmax chunks a thread: 4, 8, 12 or
// 16 narrow, the smallest that holds the row; 8 wide), so every multiple
// of 128 takes one of a few instances; a width that fills its narrow
// ceiling (512, 1024, 1536, 2048) takes an instance with the count fixed
// at compile time (kExact), whose guards fold away: the runtime guards
// cost the backward kernels 14-19% at width 1536 on an H100 when they took
// these layouts too. Guards are predicates,
// not branches, so a pass's loads issue together. Loads are 16 B per lane
// on neighbouring addresses.
#include "row_norm.cuh"

namespace {

template <int W, int kVmax, bool kExact, typename OutT>
__global__ void __launch_bounds__(hyv::RowLayout<W>::kThreads)
ln_scale_shift_kernel(const float* __restrict__ x, const float* __restrict__ s,
                      const float* __restrict__ t, OutT* __restrict__ out,
                      long long rows, int L, int d_arg, float eps) {
  using Layout = hyv::RowLayout<W>;
  const int D = kExact ? kVmax * 4 * Layout::kRowThreads : d_arg;
  __shared__ __align__(16) float red[Layout::kRedFloats];
  const int tg = Layout::thread_in_row();
  const long long row = (long long)blockIdx.x * Layout::kRows + Layout::row_in_block();
  if (row >= rows) return;  // narrow only: a wide block is one row
  const long long b = row / L;
  const int n4 = D / 4;
  const float4* xr = reinterpret_cast<const float4*>(x + row * D);

  float4 v[kVmax];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kVmax; ++i) {
    const int c = tg + Layout::kRowThreads * i;
    v[i] = kExact || c < n4 ? __ldcs(xr + c) : make_float4(0.f, 0.f, 0.f, 0.f);  // read once
    sum += (v[i].x + v[i].y) + (v[i].z + v[i].w);
  }
  int par = 0;
  const float mean = Layout::row_sum(sum, red, par) * (1.0f / D);
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kVmax; ++i) {
    if (kExact || tg + Layout::kRowThreads * i < n4) {
      v[i].x -= mean; v[i].y -= mean; v[i].z -= mean; v[i].w -= mean;
      sq += (v[i].x * v[i].x + v[i].y * v[i].y) + (v[i].z * v[i].z + v[i].w * v[i].w);
    }
  }
  const float rstd = 1.0f / sqrtf(Layout::row_sum(sq, red, par) * (1.0f / D) + eps);

  const float4* sr = reinterpret_cast<const float4*>(s + b * D);
  const float4* tr = reinterpret_cast<const float4*>(t + b * D);
#pragma unroll
  for (int i = 0; i < kVmax; ++i) {
    const int c = tg + Layout::kRowThreads * i;
    const bool mine = kExact || c < n4;  // predicates, not branches
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 sv = mine ? __ldg(sr + c) : zero, tv = mine ? __ldg(tr + c) : zero;
    // (xc * rstd) * s + t with no fused multiply-add, as the reference rounds
    float y[4];
    y[0] = __fadd_rn(__fmul_rn(__fmul_rn(v[i].x, rstd), sv.x), tv.x);
    y[1] = __fadd_rn(__fmul_rn(__fmul_rn(v[i].y, rstd), sv.y), tv.y);
    y[2] = __fadd_rn(__fmul_rn(__fmul_rn(v[i].z, rstd), sv.z), tv.z);
    y[3] = __fadd_rn(__fmul_rn(__fmul_rn(v[i].w, rstd), sv.w), tv.w);
    if constexpr (sizeof(OutT) == 4) {
      if (mine) reinterpret_cast<float4*>(out + row * D)[c] = make_float4(y[0], y[1], y[2], y[3]);
    } else {
      uint2 pk;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&pk);
      h[0] = __floats2bfloat162_rn(y[0], y[1]);
      h[1] = __floats2bfloat162_rn(y[2], y[3]);
      if (mine) reinterpret_cast<uint2*>(out + row * D)[c] = pk;
    }
  }
}

template <int W, int kVmax, bool kExact>
cudaError_t launch(const void* x, const void* s, const void* t, void* out,
                   long long rows, int L, int D, float eps, int out_bf16,
                   cudaStream_t st) {
  using Layout = hyv::RowLayout<W>;
  const dim3 grid((unsigned)((rows + Layout::kRows - 1) / Layout::kRows));
  if (out_bf16) {
    ln_scale_shift_kernel<W, kVmax, kExact, __nv_bfloat16><<<grid, Layout::kThreads, 0, st>>>(
        (const float*)x, (const float*)s, (const float*)t, (__nv_bfloat16*)out,
        rows, L, D, eps);
  } else {
    ln_scale_shift_kernel<W, kVmax, kExact, float><<<grid, Layout::kThreads, 0, st>>>(
        (const float*)x, (const float*)s, (const float*)t, (float*)out,
        rows, L, D, eps);
  }
  return cudaGetLastError();
}

// a narrow tier: the row fills it exactly (compile-time chunk count, no
// guards) or not
template <int kVmax>
cudaError_t launch_tier(const void* x, const void* s, const void* t, void* out,
                        long long rows, int L, int D, float eps, int out_bf16,
                        cudaStream_t st) {
  return D == kVmax * 128 ? launch<1, kVmax, true>(x, s, t, out, rows, L, D, eps, out_bf16, st)
                          : launch<1, kVmax, false>(x, s, t, out, rows, L, D, eps, out_bf16, st);
}

}  // namespace

extern "C" const char* hyv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// x [B, L, D] fp32; s, t [B, D] fp32; out [B, L, D] bf16 (out_bf16) or fp32.
// D a multiple of 128 up to 8192.
extern "C" int hyv_ln_scale_shift(const void* x, const void* s, const void* t,
                                  void* out, int B, int L, int D, float eps,
                                  int out_bf16, void* stream) {
  const long long rows = (long long)B * L;
  cudaStream_t st = (cudaStream_t)stream;
  if (D <= 0 || D % 128 != 0 || D > 8192) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const int c = D / 128;  // float4 chunks per lane of one warp
  if (c <= 4) return launch_tier<4>(x, s, t, out, rows, L, D, eps, out_bf16, st);
  if (c <= 8) return launch_tier<8>(x, s, t, out, rows, L, D, eps, out_bf16, st);
  if (c <= 12) return launch_tier<12>(x, s, t, out, rows, L, D, eps, out_bf16, st);
  if (c <= 16) return launch_tier<16>(x, s, t, out, rows, L, D, eps, out_bf16, st);
  return launch<hyv::kWideWarps, 8, false>(x, s, t, out, rows, L, D, eps, out_bf16, st);
}

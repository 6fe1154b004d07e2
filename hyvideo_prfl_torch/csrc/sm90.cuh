// Hopper (sm_90a) building blocks for the warp-specialised kernels
// (flash_fwd.cu, flash_fwd_qk8.cu, flash_bwd.cu, qknorm_rope_bwd.cu,
// int8_probe.cu): mbarriers, TMA tensor loads, stores and reduce-adds, bulk
// copies, wgmma (bf16 with the A operand in registers or in shared memory,
// int8 with both in shared memory), register reallocation between
// warpgroups, thread-block clusters and their distributed shared memory,
// and the host-side tensor-map encode.
//
// Shared-memory tiles that TMA fills or drains use the 128-byte swizzle:
// rows of 128 B, 16 B chunk c of row r stored at chunk c ^ (r & 7), every
// tile 1024 B aligned, so hyv::swz128(row, chunk) addresses them and a
// wgmma descriptor of layout type B128 reads them as they lie.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encode goes through the runtime

#include "common.cuh"

namespace hyv::sm90 {

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of TMA traffic to wait for
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// TMA: box at coordinates (c0, c1, c2, c3) of a rank-4 map -> shared memory,
// completing on `bar`; elements out of the tensor's bounds arrive as zeros
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// TMA: box at coordinates (c0, c1) of a rank-2 map -> shared memory
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// TMA: shared memory -> the box at (c0, c1, c2, c3); elements out of bounds
// are not written
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.tile.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// TMA: shared memory fp32 tile added element by element into the box at
// (c0, c1, c2, c3) of an fp32 map; elements out of bounds are not written
__device__ __forceinline__ void tma_reduce_add_4d(const CUtensorMap* map, uint32_t src, int c0,
                                                  int c1, int c2, int c3) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.4d.global.shared::cta.add.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// bulk copy of `bytes` contiguous bytes (a multiple of 16, both ends 16 B
// aligned) from global to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the committed stores have finished reading shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// the committed stores are complete
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// orders this thread's shared-memory writes before later async-proxy
// (TMA, wgmma) reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// counts this warp's arrival at a named barrier without waiting for it
__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// stmatrix: the inverse of ldmatrix x4 at the same lane addresses
__device__ __forceinline__ void stsm_x4(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2,
                                        uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

template <int kRegs>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// this block's rank in its cluster
__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every block of the cluster: the shared-memory writes
// before it are visible to the cluster's reads after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the shared::cluster address of `addr` (a shared::cta address of this
// block's layout) in the shared memory of the cluster's block `rank`
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// 16 B from distributed shared memory (an address from mapa)
__device__ __forceinline__ uint4 ld_cluster_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Pins values that an asynchronous wgmma reads or writes to this point of
// the program: the compiler reads no accumulator before the wait that
// completes it, and keeps an operand live until the wait that retires its
// product. (ptxas assigns the registers; see flash_fwd.cu for what
// it does with A operands across a loop.)
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// 2^x on the multi-function unit alone (exp2f adds a rescue of denormal
// results, which the softmax sums cannot see); 2^-inf = 0
__device__ __forceinline__ float exp2_mufu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Shared-memory matrix descriptor of a 128-byte-swizzled operand:
// start address, leading and stride byte offsets, all in 16 B units.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo16, uint32_t sbo16) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)(lbo16 & 0x3FFF) << 16) |
         ((uint64_t)(sbo16 & 0x3FFF) << 32) | (1ull << 62);
}

// d (64 x 128 fp32, the m64n128 accumulator fragment) (+)= a (64 x 16 bf16,
// in registers: per warp the mma.sync m16n8k16 A fragment of its 16 rows)
// * b (16 x 128 bf16, read from shared memory through `desc`; kTransB = 0
// when b's 16-deep reduction dimension is contiguous, 1 when its 128 columns
// are). accumulate = 0 overwrites d.
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate), "n"(kTransB));
}

// d (64 x 128 fp32) (+)= a (64 x 16) * b (16 x 128), both bf16 in shared
// memory through descriptors, each with its 16-deep reduction dimension
// contiguous (K-major).
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a,
                                                    uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 64 fp32, the m64n64 accumulator fragment) (+)= a (64 x 16) * b
// (16 x 64), both bf16 in shared memory through descriptors. kTransA = 0
// when a's 16-deep reduction dimension is contiguous, 1 when its 64 rows
// are; kTransB likewise for b's reduction dimension and its 64 columns.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(kTransA), "n"(kTransB));
}

// d (64 x 128 int32, the m64n128 accumulator fragment, in the fp32 one's
// register layout) (+)= a (64 x 32) * b (32 x 128), both int8 in shared
// memory through descriptors, each with its 32-deep reduction dimension
// contiguous (K-major: the only layout wgmma takes for 8-bit types). A
// 128-byte-swizzled row holds 128 int8, so one k32 step advances the
// descriptor by 32 B, as a bf16 k16 step does. The int32 sums are exact.
__device__ __forceinline__ void wgmma_m64n128k32_s8_ss(uint32_t (&d)[64], uint64_t desc_a,
                                                       uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// cuTensorMapEncodeTiled: a tensor of `rank` dimensions (dims[0]
// contiguous; strides in bytes of dimensions 1 .. rank-1), boxes of `box`
// elements, elements out of bounds read as zeros. The encode function is
// looked up through the CUDA runtime, so the library links no libcuda.
inline cudaError_t encode_tiled(CUtensorMap* map, CUtensorMapDataType type, int rank,
                                const void* base, const cuuint64_t* dims,
                                const cuuint64_t* strides, const cuuint32_t* box,
                                CUtensorMapSwizzle swizzle) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<Encode>(fn);
  }
  // The encode fails without a current context, and a thread that has made
  // no CUDA call yet (PyTorch's autograd workers may not) has none: make
  // the current device's primary context current.
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaSetDevice(dev);
  if (err != cudaSuccess) return err;
  const cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  const CUresult res = encode(map, type, rank, const_cast<void*>(base), dims, strides, box,
                              elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A tensor addressed as rank 4 (features, rows, heads, batch): 128
// contiguous features, the other three by element strides in any order;
// boxes of box_inner features (128 B) x box_rows rows with the 128-byte
// swizzle.
inline cudaError_t encode_rows(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
                               const void* base, int rows, int heads, int batch, long long s_row,
                               long long s_head, long long s_batch, int box_inner,
                               int box_rows) {
  const cuuint64_t dims[4] = {128, (cuuint64_t)rows, (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)(s_row * elem_bytes),
                                 (cuuint64_t)(s_head * elem_bytes),
                                 (cuuint64_t)(s_batch * elem_bytes)};
  const cuuint32_t box[4] = {(cuuint32_t)box_inner, (cuuint32_t)box_rows, 1, 1};
  return encode_tiled(map, type, 4, base, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// bf16 rows: boxes of 64 features
inline cudaError_t encode_bf16_rows(CUtensorMap* map, const void* base, int rows, int heads,
                                    int batch, long long s_row, long long s_head,
                                    long long s_batch, int box_rows) {
  return encode_rows(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, rows, heads, batch, s_row,
                     s_head, s_batch, 64, box_rows);
}

// int8 rows: boxes of all 128 features (128 B). TMA moves bytes, so the
// unsigned 8-bit type serves signed data.
inline cudaError_t encode_i8_rows(CUtensorMap* map, const void* base, int rows, int heads,
                                  int batch, long long s_row, long long s_head,
                                  long long s_batch, int box_rows) {
  return encode_rows(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, base, rows, heads, batch, s_row,
                     s_head, s_batch, 128, box_rows);
}

// fp32 rows: boxes of 32 features
inline cudaError_t encode_f32_rows(CUtensorMap* map, const void* base, int rows, int heads,
                                   int batch, long long s_row, long long s_head,
                                   long long s_batch, int box_rows) {
  return encode_rows(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, rows, heads, batch, s_row,
                     s_head, s_batch, 32, box_rows);
}

// streaming multiprocessors of the current device (cached per device)
inline int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0)
    cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  return counts[dev];
}

}  // namespace hyv::sm90

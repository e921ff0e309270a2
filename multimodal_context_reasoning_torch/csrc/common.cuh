// Helpers shared by the port's attention kernels (spec_attention.cu,
// fused_attention.cu, flash_bwd.cu), each of which includes this header with
// quotes.  ops/build.py hashes it into every kernel's rebuild key.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Shared-memory row stride of K and V in elements: one extra 32-bit word per
// row, so lanes that read different keys at the same d hit different banks.
template <typename T>
__host__ __device__ constexpr int row_pad() { return 4 / sizeof(T); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The FP32-pipe kernels' head widths.  Their staged variants take heads up
// to kMaxDh.  Their streaming variants keep a row of q (and dO) in shared
// memory and MaxDh / 32 output columns per lane, MaxDh a template parameter
// instantiated at kNarrowDh (heads up to 128, the registers they always had)
// and at kMaxDh (heads from 129 to 256).  A head wider than kMaxDh runs the
// kMaxDh streaming instance in slabs (its Slabs flag): one block per slab of
// kMaxDh output columns, the scores over the whole head, q (and dO) read
// through L1 for them and only the slab's columns staged.
constexpr int kMaxDh = 256;
constexpr int kNarrowDh = 128;

__host__ __device__ constexpr int ceil_div(int n, int d) { return (n + d - 1) / d; }

// True when one block may opt in to `smem` bytes of dynamic shared memory on
// the current device (227 KB on an H100); the FP32-pipe kernels stage K and
// V there while this holds and stream them from device memory beyond it.
inline bool fits_smem(size_t smem) {
  constexpr int kMaxDevices = 64;
  static int limit[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return false;
  int lim = dev < kMaxDevices ? limit[dev] : 0;
  if (lim == 0) {
    if (cudaDeviceGetAttribute(&lim, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
        cudaSuccess) {
      cudaGetLastError();
      return false;
    }
    if (dev < kMaxDevices) limit[dev] = lim;
  }
  return smem <= size_t(lim);
}

// Opt `Kernel` in to `smem` bytes of dynamic shared memory on the current
// device, once: the size is set again only when a launch needs more.  A size
// beyond the card's per-block limit fails here; the error is cleared so that
// it is not reported again by a later launch's cudaGetLastError().
template <auto Kernel>
cudaError_t reserve_smem(size_t smem) {
  constexpr int kMaxDevices = 64;
  static size_t reserved[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && smem <= reserved[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  if (dev < kMaxDevices) reserved[dev] = smem;
  return cudaSuccess;
}

// ---- tensor-core helpers of the bf16 kernels (mma.sync, ldmatrix, cp.async)

// The head widths the bf16 kernels take (bf16_width in ops/fused_attention.py,
// whose launchers zero-pad every head to one of them): 64 and 128, their
// Dh template parameter, and any multiple of kSlabDh above, which the slab
// instances run in slabs of kSlabDh output columns (one block per slab, the
// scores summed over every slab of the head).
constexpr int kSlabDh = 128;
__host__ __device__ constexpr bool mma_head_dim(int dh) { return dh == 64 || dh == 128; }
// The slab count of a head the slab instances take, 0 for any other.
__host__ __device__ constexpr int mma_slabs(int dh) {
  return dh > kSlabDh && dh % kSlabDh == 0 ? dh / kSlabDh : 0;
}

__host__ __device__ constexpr int pad16(int n) { return (n + 15) & ~15; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when `valid` is false.
__device__ __forceinline__ void cp_async16(const void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Close the group of copies issued so far, and wait until at most `N` of the
// closed groups are still in flight.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lane l gives the address of row (l & 7) of matrix
// l >> 3.  Register r holds matrix r: row lane / 4, columns 2 (lane % 4) + {0, 1}
// (with .trans: rows 2 (lane % 4) + {0, 1}, column lane / 4).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// c += a (16x16, row) * b (16x8, col); bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Reductions over the four lanes of a quad, which share accumulator rows.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace

// Helpers shared by the port's attention kernels (spec_attention.cu,
// fused_attention.cu, flash_bwd.cu), each of which includes this header with
// quotes.  ops/build.py hashes it into every kernel's rebuild key.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

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

}  // namespace

// Shared helpers of the GAM attention kernels: paired stores along the head
// dimension from f32, and cp.async copies.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace gam {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Asynchronous copies from global into shared memory (a short copy
// zero-fills the rest when full is false).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(full ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace gam

// Shared helpers of the port's hand-written Hopper kernels: element-type
// conversions to and from fp32, the NEG_INF mask value of the reference
// kernels, and the dtype codes the ctypes wrappers pass in.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {

// Same large-but-finite mask value as the JAX kernels (-2**30): a masked
// score stays finite, so exp(s - m) of a masked entry is exactly 0 once any
// real score has been seen.
constexpr float kNegInf = -1073741824.0f;

// dtype codes shared with kernels/_build.py
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

template <typename T>
__device__ __forceinline__ float to_f32(T x);

template <>
__device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}

template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);

template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace repro_torch

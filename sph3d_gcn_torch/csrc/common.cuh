// Helpers shared by the sph3d_gcn_torch kernels.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sph3d {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kTile = 128;  // query rows per tile, window rows per block

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch .to()
}

// (a*a + b*b) + c*c, rounded after every operation: nvcc may not contract
// these into FMAs, so distances equal PyTorch's and XLA's bit for bit.
__device__ __forceinline__ float sum_sq3(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)),
                   __fmul_rn(c, c));
}

}  // namespace sph3d

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

// --- the dense conv's map decode (K3 and K5) ---

constexpr int kMaxDevices = 16;  // devices whose shared-memory limit is kept

// One bit per byte of v (4 bytes) that holds a hit: 1 <= byte <= F
// (fmax4: F in every byte; a negative int8 is >= 128 unsigned).
__device__ __forceinline__ unsigned hit_bits4(unsigned v, unsigned fmax4) {
  const unsigned m = __vcmpgeu4(v, 0x01010101u) & __vcmpleu4(v, fmax4);
  return ((m >> 7) & 1u) | ((m >> 14) & 2u) | ((m >> 21) & 4u) |
         ((m >> 28) & 8u);
}

// Bit i: byte i of the 16-byte word holds a hit.
__device__ __forceinline__ unsigned hit_bits16(uint4 v, unsigned fmax4) {
  return hit_bits4(v.x, fmax4) | (hit_bits4(v.y, fmax4) << 4) |
         (hit_bits4(v.z, fmax4) << 8) | (hit_bits4(v.w, fmax4) << 12);
}

__device__ __forceinline__ int word_byte(uint4 v, int i) {
  const unsigned w = i < 8 ? (i < 4 ? v.x : v.y) : (i < 12 ? v.z : v.w);
  return static_cast<int>((w >> (8 * (i & 3))) & 0xffu);
}

// Exclusive prefix sum over the warp's lanes, and the warp's total.
__device__ __forceinline__ int warp_scan(int v, int lane, int* total) {
  int inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFullMask, inc, d);
    if (lane >= d) inc += y;
  }
  *total = __shfl_sync(kFullMask, inc, 31);
  return inc - v;
}

// A list entry: query row t (7 bits), bin f (7 bits), window column w.
__device__ __forceinline__ int pack_hit(int t, int f, int w) {
  return t | (f << 7) | (w << 14);
}

// The r terms (c*r + j, j < R) of one channel, in f32: adjacent in
// memory, and for R = 2 read as one aligned pair (the row stride C*r and
// the offset c*r are even).
template <int R>
__device__ __forceinline__ void load_terms(const float* p, float (&v)[R]) {
  if constexpr (R == 2) {
    const float2 u = *reinterpret_cast<const float2*>(p);
    v[0] = u.x;
    v[1] = u.y;
  } else {
    v[0] = *p;
  }
}

template <int R>
__device__ __forceinline__ void load_terms(const __nv_bfloat16* p,
                                           float (&v)[R]) {
  if constexpr (R == 2) {
    const __nv_bfloat162 u = *reinterpret_cast<const __nv_bfloat162*>(p);
    v[0] = __low2float(u);
    v[1] = __high2float(u);
  } else {
    v[0] = __bfloat162float(*p);
  }
}

// A 16-byte copy from global into shared memory that bypasses L1 (and a
// 4-byte one through L1), and their group commit and wait (cp.async).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Raise a kernel's dynamic shared memory limit where a launch needs more
// than was set before on this device (the host call costs more than a
// small launch). allowed: the limit set so far on each device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem,
                       size_t (&allowed)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && smem <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev] = smem;
  return err;
}

}  // namespace sph3d

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


// Let a kernel use all the shared memory the device lends one block, less
// its static arrays; set once a device (allowed: the devices done). The
// attribute is a ceiling: occupancy follows each launch's own dynamic
// shared memory.
template <typename Kernel>
cudaError_t allow_all_smem(Kernel kernel, bool (&allowed)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && allowed[dev]) return cudaSuccess;
  int optin = 0;
  cudaFuncAttributes fa;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - static_cast<int>(fa.sharedSizeBytes));
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev] = true;
  return err;
}

// --- the dense queries' row walk (K2 and K7) ---

constexpr int kQueryWarps = 8;     // warps a block; each walks whole rows
constexpr int kQueryStep = 128;    // window columns a warp step: 4 a lane

// The live columns of a tile's window: u_end chunks of 128, clamped to
// [1, W/128].
__device__ __forceinline__ int live_columns(int64_t u_end, int window) {
  const int64_t chunks = u_end < 1 ? 1 : u_end;
  const int64_t most = window / kTile;
  return static_cast<int>(chunks < most ? chunks : most) * kTile;
}

// Stages the first `live` database rows at dbw (x, y, z interleaved) in
// shared memory as x, y and z planes of `live` floats each.
__device__ __forceinline__ void stage_window(const float* __restrict__ dbw,
                                             int live, float* win) {
  for (int i = threadIdx.x; i < 3 * live; i += blockDim.x) {
    win[(i % 3) * live + i / 3] = dbw[i];
  }
}

// Four consecutive window columns seen from one query: the offsets
// (database - query) and s = (dx*dx + dy*dy) + dz*dz, rounded as the plain
// version rounds them (sum_sq3).
struct Cols4 {
  float dx[4], dy[4], dz[4], s[4];
};

__device__ __forceinline__ Cols4 cols4(const float* win, int live, int w,
                                       float qx, float qy, float qz) {
  const float4 x = *reinterpret_cast<const float4*>(win + w);
  const float4 y = *reinterpret_cast<const float4*>(win + live + w);
  const float4 z = *reinterpret_cast<const float4*>(win + 2 * live + w);
  const float xs[4] = {x.x, x.y, x.z, x.w};
  const float ys[4] = {y.x, y.y, y.z, y.w};
  const float zs[4] = {z.x, z.y, z.z, z.w};
  Cols4 c;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    c.dx[j] = xs[j] - qx;
    c.dy[j] = ys[j] - qy;
    c.dz[j] = zs[j] - qz;
    c.s[j] = sum_sq3(c.dx[j], c.dy[j], c.dz[j]);
  }
  return c;
}

// Zeros of a map row (and its distance row) from column c0, a multiple of
// 128, to the row's end: 16-byte stores, 512 map columns a warp store.
template <bool kDist>
__device__ __forceinline__ void zero_row(int8_t* orow, float* drow, int c0,
                                         int window, int lane) {
  for (int c = c0 + 16 * lane; c < window; c += 512) {
    *reinterpret_cast<uint4*>(orow + c) = make_uint4(0u, 0u, 0u, 0u);
  }
  if (kDist) {
    for (int c = c0 + 4 * lane; c < window; c += 128) {
      *reinterpret_cast<float4*>(drow + c) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// A warp's list of one step's selected columns, and the step's map bytes
// and distances, in shared memory (walk_row's list mode).
struct StepList {
  uint8_t col[kQueryStep];   // the selected columns, in rank order
  union {
    uint8_t byte[kQueryStep];
    unsigned word[kQueryStep / 4];
  };
  float dist[kQueryStep];
};

// One warp writes one query row of a map: the window columns with
// s < t_in are in range, ranked in window order (1, 2, ...); the first k
// are selected, every other byte of the row is 0. A step tests 128 live
// columns, lane i columns 4i..4i+3, and stores one 4-byte word of the map
// a lane (and one float4 of the distance map); a column's rank is the
// in-range count of the steps before (off, warp-uniform) plus four
// ballots' counts of the lanes before plus the lane's own. The walk stops
// after the step in which the row reaches k, and the rest of the row is
// zero-filled. Returns the in-range columns counted (at least k when the
// walk stopped early).
//
// Without kList a selected byte is its rank, set in the lane's word. With
// kList (a bin map, or a distance map) the step's selected columns go into
// the warp's list (col), and lane i takes entries i, i + 32, ...: it
// recomputes the column's offsets and s and writes value(rank, dx, dy,
// dz, s) into the step's bytes (and, with kDist, sqrtf(sqrtf(s)) into its
// distances) for the owners to store; so the costly value of a sparse
// step takes one pass of the warp, not one a column slot in which any
// lane selects.
template <bool kDist, bool kList, typename Value>
__device__ __forceinline__ int walk_row(const float* win, int live,
                                        int window, float qx, float qy,
                                        float qz, float t_in, int k,
                                        int8_t* orow, float* drow,
                                        StepList* list, Value value) {
  const int lane = threadIdx.x & 31;
  const unsigned before = (1u << lane) - 1u;  // the lanes before this one
  int off = 0;
  int c0 = 0;
  for (; c0 < live && off < k; c0 += kQueryStep) {  // warp-uniform
    const int w = c0 + 4 * lane;
    const Cols4 c = cols4(win, live, w, qx, qy, qz);
    bool in[4];
    int rank = off;
    int total = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      in[j] = c.s[j] < t_in;
      const unsigned bal = __ballot_sync(kFullMask, in[j]);
      rank += __popc(bal & before);
      total += __popc(bal);
    }
    if (!kList) {
      unsigned word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (in[j] && ++rank <= k) {
          word |= static_cast<unsigned>(rank) << (8 * j);
        }
      }
      *reinterpret_cast<unsigned*>(orow + w) = word;
    } else if (total == 0) {  // warp-uniform: a step with no selection
      *reinterpret_cast<unsigned*>(orow + w) = 0u;
      if (kDist) {
        *reinterpret_cast<float4*>(drow + w) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (in[j] && ++rank <= k) list->col[rank - off - 1] = 4 * lane + j;
      }
      list->word[lane] = 0u;
      if (kDist) {
        reinterpret_cast<float4*>(list->dist)[lane] =
            make_float4(0.f, 0.f, 0.f, 0.f);
      }
      __syncwarp();
      const int n_sel = min(total, k - off);
      for (int i = lane; i < n_sel; i += 32) {
        const int cc = list->col[i];
        const int wc = c0 + cc;
        const float dx = win[wc] - qx;
        const float dy = win[live + wc] - qy;
        const float dz = win[2 * live + wc] - qz;
        const float s = sum_sq3(dx, dy, dz);
        list->byte[cc] =
            static_cast<uint8_t>(value(off + i + 1, dx, dy, dz, s));
        if (kDist) list->dist[cc] = sqrtf(sqrtf(s));
      }
      __syncwarp();
      *reinterpret_cast<unsigned*>(orow + w) = list->word[lane];
      if (kDist) {
        *reinterpret_cast<float4*>(drow + w) =
            reinterpret_cast<const float4*>(list->dist)[lane];
      }
      __syncwarp();  // the next step rewrites the list
    }
    off += total;
  }
  zero_row<kDist>(orow, drow, c0, window, lane);
  return off;
}

}  // namespace sph3d

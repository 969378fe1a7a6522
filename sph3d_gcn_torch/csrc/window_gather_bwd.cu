// K9: backward of K8 with respect to the features: a deterministic segment
// sum of edge gradients into their source rows.
//
// Replaces the TPU kernel sph3d_gcn_tpu/ops/windowed.py:71
// (_onehot_matmul_t_kernel, launched at :126) and the block-granular
// scatter that XLA derived after it. Plain PyTorch twin:
// sph3d_gcn_torch/ops/windowed.py::window_gather_bwd_plain.
//
//   dfeats[b, n, :] = sum over valid edges (m, k) with idx[b, m, k] = n
//                     of dg[b, m, k, :]
//
// summed in f32, in (m, k) order, and rounded once to dg's dtype. The TPU
// kernel accumulated per-tile window gradients as transposed one-hot
// products and rounded them to dg's dtype between edge chunks; here every
// target row is summed straight into (B, N, C).
//
// Design: the inverse edge lists come in from the wrapper (a stable sort
// of the edges by target row, ops/windowed.py::edge_lists): order[] holds
// the padded edge ids grouped by target row, each group in (m, k) order,
// and starts[r] .. starts[r + 1] is row r's group. One warp owns one
// target row and walks its group in that fixed order, lane = channel, four
// 32-channel slots per pass, with four edges' loads in flight before their
// adds (the adds stay in list order). No float atomics: bitwise
// reproducible, and exact for every index (no window).
//
// What bounds it on the H100: reading dg once (each valid edge belongs to
// one target row) and writing dfeats; the lists add 8 bytes per edge.
#include "common.cuh"

namespace {

constexpr int kSlots = 4;     // 32-channel slots per pass
constexpr int kInFlight = 4;  // edges loaded before their adds

template <typename T>
__global__ void window_gather_bwd_kernel(const T* __restrict__ dg,
                                         const int* __restrict__ order,
                                         const int* __restrict__ starts,
                                         T* __restrict__ dx, int rows,
                                         int c) {
  const int r = static_cast<int>(
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const int e0 = starts[r];
  const int e1 = starts[r + 1];
  for (int c0 = 0; c0 < c; c0 += 32 * kSlots) {
    float acc[kSlots];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) acc[j] = 0.f;
    int e = e0;
    for (; e + kInFlight <= e1; e += kInFlight) {
      float v[kInFlight][kSlots];
#pragma unroll
      for (int q = 0; q < kInFlight; ++q) {
        const int64_t base = static_cast<int64_t>(order[e + q]) * c;
#pragma unroll
        for (int j = 0; j < kSlots; ++j) {
          const int ch = c0 + lane + 32 * j;
          v[q][j] = ch < c ? sph3d::to_float(dg[base + ch]) : 0.f;
        }
      }
#pragma unroll
      for (int q = 0; q < kInFlight; ++q) {
#pragma unroll
        for (int j = 0; j < kSlots; ++j) acc[j] += v[q][j];
      }
    }
    for (; e < e1; ++e) {
      const int64_t base = static_cast<int64_t>(order[e]) * c;
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        const int ch = c0 + lane + 32 * j;
        if (ch < c) acc[j] += sph3d::to_float(dg[base + ch]);
      }
    }
    T* out = dx + static_cast<int64_t>(r) * c;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int ch = c0 + lane + 32 * j;
      if (ch < c) out[ch] = sph3d::from_float<T>(acc[j]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* dg, const int* order, const int* starts,
                   void* dx, int rows, int c, cudaStream_t stream) {
  constexpr int kThreads = 256;  // 8 target rows per block
  const int64_t blocks = (static_cast<int64_t>(rows) * 32 + kThreads - 1) /
                         kThreads;
  if (blocks == 0) return cudaSuccess;
  window_gather_bwd_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                                stream>>>(static_cast<const T*>(dg), order,
                                          starts, static_cast<T*>(dx), rows,
                                          c);
  return cudaGetLastError();
}

}  // namespace

// dg: (B, M_pad, K, C); order: (B * M_pad * K,) int32 edge ids grouped by
// target row; starts: (B * N + 1,) int32; dx: (B, N, C) in dg's dtype.
extern "C" int sph3d_window_gather_bwd_launch(const void* dg,
                                              const int* order,
                                              const int* starts, void* dx,
                                              int rows, int c, int is_bf16,
                                              void* stream) {
  if (rows < 0 || c < 1) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch<__nv_bfloat16>(dg, order, starts, dx, rows, c, st);
  }
  return launch<float>(dg, order, starts, dx, rows, c, st);
}

// K4: max pooling from rank-valued neighbor maps (forward).
//
// Replaces the TPU kernel sph3d_gcn_tpu/ops/dense.py:1953
// (_rank_pool_fwd_kernel, via _rank_window_max_for) and, behind
// dense_max_pool3d(with_index=True), sph3d_gcn_tpu/ops/dense.py:1792
// (_dense_pool_fwd_kernel: the masked max over every selected window
// column with its first attaining column, on rank and bin maps alike;
// the pool's counts select every nonzero entry of a bin map). Plain
// PyTorch twin: sph3d_gcn_torch/ops/dense.py::rank_pool_plain.
//
//   out[t, c] = max x[s_blk*128 + w, c] over the window columns w of query
//               row t whose rank pk lies in 1..count[t]; 0 if there is none
//   arg[t, c] = the FIRST such column w attaining the max, -1 if none
//               (only when the caller asks for it: the backward's input)
//
// Design: one warp per (query row, 256-channel chunk; the chunk is the
// grid's y index, C <= 512) walks the row's window in 32-column steps; a
// ballot finds the selected columns and the warp folds each selected
// neighbor's feature row into a running max per channel (chunk*256 + lane
// + 32*slot). The TPU kernel compacted the window to K rows with a one-hot
// rank matmul and took one max over composite int32 (value, rank) keys;
// here a strict `>` in window order keeps the first attaining column,
// which is the smallest rank (ranks count the selected columns in window
// order). -0 is folded to +0 as the TPU kernel does, so -0 and +0 tie;
// the max of bf16 values is exact, so f32 and bf16 outputs (and arg)
// equal the plain version's exactly. Inference launches the values-only
// instance (fmaxf, no arg registers).
//
// What bounds it on the H100: the gathered feature reads, B*M*K*C
// elements mostly from L2, and the map read, B*M*W bytes (once per
// channel chunk).
#include <math_constants.h>

#include "common.cuh"

namespace {

using sph3d::kFullMask;
using sph3d::kTile;

constexpr int kWarps = 8;
constexpr int kSlots = 8;  // 32-lane channel slots per chunk
constexpr int kChunk = kSlots * 32;  // channels per chunk (grid y)
constexpr int kMaxC = 2 * kChunk;    // C <= 512

template <typename T, bool kArg>
__global__ void __launch_bounds__(kWarps * 32)
    rank_pool_kernel(const int8_t* __restrict__ packed,
                     const int* __restrict__ s_blk,
                     const int* __restrict__ counts,
                     const T* __restrict__ x, T* __restrict__ out,
                     int* __restrict__ arg, int rows_total, int n_t, int n,
                     int c, int window) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows_total) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int ch0 = blockIdx.y * kChunk + lane;  // this lane's first channel
  const int g = row / kTile;
  const int b = g / n_t;
  const int base = s_blk[g] * kTile;
  const int cnt = counts[row];
  const int8_t* prow = packed + static_cast<size_t>(row) * window;
  const T* xb = x + static_cast<size_t>(b) * n * c;

  float best[kSlots];
  int best_w[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    best[s] = -CUDART_INF_F;
    best_w[s] = -1;
  }
  bool any = false;
  for (int c0 = 0; c0 < window; c0 += 32) {
    const int pk = prow[c0 + lane];
    unsigned bal = __ballot_sync(kFullMask, pk >= 1 && pk <= cnt);
    while (bal) {
      const int src = __ffs(bal) - 1;
      bal &= bal - 1;
      const int w = base + c0 + src;
      if (w >= n) continue;  // padding rows are never selected
      any = true;
      const T* xr = xb + static_cast<size_t>(w) * c;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int ch = ch0 + 32 * s;
        if (ch < c) {
          // + 0.0f folds -0 to +0 (not an identity without fast-math)
          const float v = sph3d::to_float(xr[ch]) + 0.0f;
          if (kArg) {
            if (v > best[s]) {  // strict: ties keep the earlier column
              best[s] = v;
              best_w[s] = c0 + src;
            }
          } else {
            best[s] = fmaxf(best[s], v);
          }
        }
      }
    }
  }
  T* orow = out + static_cast<size_t>(row) * c;
  int* arow = kArg ? arg + static_cast<size_t>(row) * c : nullptr;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int ch = ch0 + 32 * s;
    if (ch < c) {
      orow[ch] = sph3d::from_float<T>(any ? best[s] : 0.0f);
      if (kArg) arow[ch] = best_w[s];
    }
  }
}

template <typename T, bool kArg>
cudaError_t launch_impl(const int8_t* packed, const int* s_blk,
                        const int* counts, const void* x, void* out, int* arg,
                        int rows_total, int n_t, int n, int c, int window,
                        cudaStream_t stream) {
  const dim3 grid((rows_total + kWarps - 1) / kWarps,
                  (c + kChunk - 1) / kChunk);
  rank_pool_kernel<T, kArg><<<grid, kWarps * 32, 0, stream>>>(
      packed, s_blk, counts, static_cast<const T*>(x), static_cast<T*>(out),
      arg, rows_total, n_t, n, c, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const int8_t* packed, const int* s_blk, const int* counts,
                   const void* x, void* out, int* arg, int rows_total,
                   int n_t, int n, int c, int window, cudaStream_t stream) {
  return arg != nullptr
      ? launch_impl<T, true>(packed, s_blk, counts, x, out, arg, rows_total,
                             n_t, n, c, window, stream)
      : launch_impl<T, false>(packed, s_blk, counts, x, out, arg, rows_total,
                              n_t, n, c, window, stream);
}

}  // namespace

// arg: (B, M_pad, C) int32 to receive the first attaining column, or null
// for the values-only launch.
extern "C" int sph3d_rank_pool_launch(const int8_t* packed, const int* s_blk,
                                      const int* counts, const void* x,
                                      void* out, int* arg, int batch,
                                      int n_t, int n, int c, int window,
                                      int is_bf16, void* stream) {
  if (c < 1 || c > kMaxC) return cudaErrorInvalidValue;
  const int rows = batch * n_t * kTile;
  const auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch<__nv_bfloat16>(packed, s_blk, counts, x, out, arg, rows,
                                 n_t, n, c, window, st);
  }
  return launch<float>(packed, s_blk, counts, x, out, arg, rows, n_t, n, c,
                       window, st);
}

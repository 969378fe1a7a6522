// K3: depthwise spherical conv from packed bin maps.
//
// Replaces BOTH TPU kernels sph3d_gcn_tpu/ops/dense.py:611
// (_dense_conv_fwd_kernel, via _dense_conv_for, C_in <= 128) and
// sph3d_gcn_tpu/ops/dense.py:1132 (_dense_conv_rm_fwd_kernel, via
// _dense_conv_rm_for, C_in > 128): they compute one function in two TPU
// layouts. Plain PyTorch twin: sph3d_gcn_torch/ops/dense.py::
// dense_conv_plain.
//
//   out[t, c*r + j] = inv[t] * sum_w x[s_blk*128 + w, c] * filt_b[pk-1, c, j]
//   over the window columns w of query row t whose map entry pk is nonzero
//
// filt_b is the per-cloud filter (B, F, C, r) in f32, its bin rows already
// in the map's (possibly sort-grouped) order; inv[t] = 1 / max(count, 1).
// Sums are f32; the output is cast once to the feature dtype (f32 or
// bf16), after the scale, as the TPU's C <= 128 kernel does.
//
// Design: one warp per (query row, 256-channel chunk) walks the row's
// window in 32-column steps; a ballot finds the (at most K) selected
// columns and the warp then reads each selected neighbor's feature row
// with coalesced channel loads (chunk*256 + lane + 32*slot), accumulating
// r products per channel in registers. The chunk is the grid's y index
// (C <= 1024: up to 4 chunks), so the per-warp work and the registers
// (acc[8][r]) stay those of a 256-channel row; wider rows walk their map
// once per chunk. No one-hot matrix, no zone split, no lane padding: the
// TPU's MXU formulation did ~F*W/K times the useful multiply-adds to keep
// its matrix unit busy; here only the K selected entries of a row cost
// arithmetic.
//
// What bounds it on the H100: the gathered feature reads, B*M*K*C
// elements, mostly from L2 (a tile's window of rows is shared by its 128
// rows), and the map read, B*M*W bytes from device memory (once per
// channel chunk, the later reads mostly from L2).
#include "common.cuh"

namespace {

using sph3d::kFullMask;
using sph3d::kTile;

constexpr int kWarps = 8;
constexpr int kSlots = 8;  // 32-lane channel slots per chunk
constexpr int kChunk = kSlots * 32;  // channels per chunk (grid y)
constexpr int kMaxC = 4 * kChunk;    // C <= 1024

template <typename T, int R>
__global__ void __launch_bounds__(kWarps * 32)
    dense_conv_kernel(const int8_t* __restrict__ packed,
                      const int* __restrict__ s_blk,
                      const T* __restrict__ x, const float* __restrict__ filt,
                      const float* __restrict__ inv, T* __restrict__ out,
                      int rows_total, int n_t, int n, int c, int f_bins,
                      int window) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows_total) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int ch0 = blockIdx.y * kChunk + lane;  // this lane's first channel
  const int g = row / kTile;  // b * n_t + tile
  const int b = g / n_t;
  const int base = s_blk[g] * kTile;
  const int8_t* prow = packed + static_cast<size_t>(row) * window;
  const T* xb = x + static_cast<size_t>(b) * n * c;
  const float* fb = filt + static_cast<size_t>(b) * f_bins * c * R;

  float acc[kSlots][R];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
#pragma unroll
    for (int j = 0; j < R; ++j) acc[s][j] = 0.f;
  }
  for (int c0 = 0; c0 < window; c0 += 32) {
    const int pk = prow[c0 + lane];
    unsigned bal = __ballot_sync(kFullMask, pk != 0);
    while (bal) {
      const int src = __ffs(bal) - 1;
      bal &= bal - 1;
      const int f = __shfl_sync(kFullMask, pk, src) - 1;
      const int w = base + c0 + src;
      if (w >= n) continue;  // padding rows are never selected
      const T* xr = xb + static_cast<size_t>(w) * c;
      const float* fr = fb + static_cast<size_t>(f) * c * R;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int ch = ch0 + 32 * s;
        if (ch < c) {
          const float xv = sph3d::to_float(xr[ch]);
#pragma unroll
          for (int j = 0; j < R; ++j) {
            acc[s][j] = fmaf(xv, fr[ch * R + j], acc[s][j]);
          }
        }
      }
    }
  }
  const float iv = inv[row];
  T* orow = out + static_cast<size_t>(row) * c * R;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int ch = ch0 + 32 * s;
    if (ch < c) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        orow[ch * R + j] = sph3d::from_float<T>(acc[s][j] * iv);
      }
    }
  }
}

template <typename T, int R>
cudaError_t launch(const int8_t* packed, const int* s_blk, const void* x,
                   const float* filt, const float* inv, void* out,
                   int rows_total, int n_t, int n, int c, int f_bins,
                   int window, cudaStream_t stream) {
  const dim3 grid((rows_total + kWarps - 1) / kWarps,
                  (c + kChunk - 1) / kChunk);
  dense_conv_kernel<T, R><<<grid, kWarps * 32, 0, stream>>>(
      packed, s_blk, static_cast<const T*>(x), filt, inv,
      static_cast<T*>(out), rows_total, n_t, n, c, f_bins, window);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sph3d_dense_conv_launch(const int8_t* packed, const int* s_blk,
                                       const void* x, const float* filt,
                                       const float* inv, void* out,
                                       int batch, int n_t, int n, int c,
                                       int f_bins, int window, int mult,
                                       int is_bf16, void* stream) {
  if (c < 1 || c > kMaxC || (mult != 1 && mult != 2)) {
    return cudaErrorInvalidValue;
  }
  const int rows = batch * n_t * kTile;
  const auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return mult == 1
        ? launch<__nv_bfloat16, 1>(packed, s_blk, x, filt, inv, out, rows,
                                   n_t, n, c, f_bins, window, st)
        : launch<__nv_bfloat16, 2>(packed, s_blk, x, filt, inv, out, rows,
                                   n_t, n, c, f_bins, window, st);
  }
  return mult == 1
      ? launch<float, 1>(packed, s_blk, x, filt, inv, out, rows, n_t, n, c,
                         f_bins, window, st)
      : launch<float, 2>(packed, s_blk, x, filt, inv, out, rows, n_t, n, c,
                         f_bins, window, st);
}

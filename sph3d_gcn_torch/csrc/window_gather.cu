// K8: the edge gather of the per-edge engine, with invalid lanes zeroed.
//
// Replaces the TPU kernel sph3d_gcn_tpu/ops/windowed.py:59
// (_onehot_matmul_kernel, launched at :100 by windowed_gather_padded).
// Plain PyTorch twin: sph3d_gcn_torch/ops/windowed.py::window_gather_plain.
//
//   g[b, m, k, :] = feats[b, idx[b, m, k], :]   if m < M and k < count[b, m]
//                 = 0                           otherwise
//
// for m < M_pad (M rounded up to 128). The TPU kernel multiplied a one-hot
// of the window-relative index by a gathered window of rows on the matrix
// unit, because the TPU's per-index gather is slow; it also needed a window
// certificate and a fallback for indices outside the window. The GPU reads
// a row by its index, so this kernel is a plain gather: exact for every
// index, with no window at all.
//
// Design: the output is treated as rows of raw bytes, copied in units of
// U bytes (16, 8, 4 or 2: the widest that divides the row and both base
// addresses, chosen by the wrapper). Thread i writes unit i of the flat
// output, so a warp writes 32 consecutive units (coalesced) and reads the
// same units of its source rows; a row's index and count are read once per
// unit from L1. Indices are clamped into [0, N) so a bad index cannot read
// outside the features (the callers' indices are always in range). Flat
// positions are 32-bit: an output of 2^31 copy units or more is refused
// (the largest call of the ModelNet path writes 3.6e8 units).
//
// What bounds it on the H100: the bytes it writes, B * M_pad * K * C
// elements, and the gathered rows it reads (each valid edge reads one row;
// rows are re-read across edges from L2, the features of one level being
// at most a few MB).
#include "common.cuh"

namespace {

template <typename U>
__global__ void window_gather_kernel(const U* __restrict__ feats,
                                     const int64_t* __restrict__ idx,
                                     const int64_t* __restrict__ count,
                                     U* __restrict__ out, int n, int m,
                                     int m_pad, int k, int units,
                                     int total) {
  // 32-bit index math: the launcher refuses outputs near 2^31 units
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int e = i / units;  // edge (b, m', k') of the padded layout
    const int u = i - e * units;
    const int row = e / k;    // b * m_pad + m'
    const int kk = e - row * k;
    const int b = row / m_pad;
    const int mm = row - b * m_pad;
    U v{};
    if (mm < m) {
      const int64_t q = static_cast<int64_t>(b) * m + mm;
      if (kk < count[q]) {
        int64_t src = idx[q * k + kk];
        src = src < 0 ? 0 : (src >= n ? n - 1 : src);
        v = feats[(static_cast<int64_t>(b) * n + src) * units + u];
      }
    }
    out[i] = v;
  }
}

template <typename U>
cudaError_t launch(const void* feats, const int64_t* idx,
                   const int64_t* count, void* out, int batch, int n, int m,
                   int m_pad, int k, int row_bytes, cudaStream_t stream) {
  const int units = row_bytes / static_cast<int>(sizeof(U));
  const int64_t total = static_cast<int64_t>(batch) * m_pad * k * units;
  if (total == 0) return cudaSuccess;
  constexpr int kThreads = 256;
  const int64_t want = (total + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 132 * 64 ? want : 132 * 64);
  // i + stride must not overflow the 32-bit loop index
  if (total > INT32_MAX - static_cast<int64_t>(blocks) * kThreads) {
    return cudaErrorInvalidValue;
  }
  window_gather_kernel<U><<<blocks, kThreads, 0, stream>>>(
      static_cast<const U*>(feats), idx, count, static_cast<U*>(out), n, m,
      m_pad, k, units, static_cast<int>(total));
  return cudaGetLastError();
}

}  // namespace

// feats: (B, N, C) rows of row_bytes bytes; idx: (B, M, K) int64;
// count: (B, M) int64; out: (B, M_pad, K, C). unit_bytes in {2, 4, 8, 16}
// divides row_bytes and both base addresses.
extern "C" int sph3d_window_gather_launch(const void* feats,
                                          const int64_t* idx,
                                          const int64_t* count, void* out,
                                          int batch, int n, int m, int m_pad,
                                          int k, int row_bytes,
                                          int unit_bytes, void* stream) {
  if (n < 1 || m > m_pad || k < 1 || row_bytes < 1 ||
      row_bytes % unit_bytes != 0) {
    return cudaErrorInvalidValue;
  }
  const auto st = static_cast<cudaStream_t>(stream);
  switch (unit_bytes) {
    case 16:
      return launch<uint4>(feats, idx, count, out, batch, n, m, m_pad, k,
                           row_bytes, st);
    case 8:
      return launch<uint2>(feats, idx, count, out, batch, n, m, m_pad, k,
                           row_bytes, st);
    case 4:
      return launch<uint32_t>(feats, idx, count, out, batch, n, m, m_pad, k,
                              row_bytes, st);
    case 2:
      return launch<uint16_t>(feats, idx, count, out, batch, n, m, m_pad, k,
                              row_bytes, st);
    default:
      return cudaErrorInvalidValue;
  }
}

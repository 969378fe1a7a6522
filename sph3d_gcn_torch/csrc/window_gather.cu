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
// Design: the output is a sequence of edges (b, m, k), C elements each,
// written in 16-byte chunks whatever C is (a block's rows are a multiple
// of 16 bytes: 8 query rows hold 8*K*C elements of 2 or 4 bytes). A
// block takes `rows` query rows
// (ops/windowed.py::gather_rows): it stages each of their edges' source
// row (b*N + idx, clamped into [0, N)) or -1 for an invalid edge in
// shared memory, reading idx and count once, then each thread writes every
// blockDim-th chunk of the block's output with a streaming store, so that
// L2 keeps the feature rows, which the edges re-read. A chunk's elements
// come from one edge, or from several where it crosses an edge boundary
// (C*elem not a multiple of 16); each piece is read by aligned 4-byte
// loads of exactly the words that hold its bytes, shifted into place by
// a funnel shift (a piece of a bf16 row may start 2 bytes into a word),
// or by one 16-byte load where the piece is the whole chunk and the
// source is 16-byte aligned (C*elem a multiple of 16). A zero piece loads
// nothing. A thread's chunk moves by blockDim*16 bytes a step, so its
// (edge, channel) position advances without a division. Indices are
// clamped so a bad index cannot read outside the features (the callers'
// indices are always in range).
//
// What bounds it on the H100: the bytes it writes, B * M_pad * K * C
// elements, and the gathered rows it reads (each valid edge reads one row;
// rows are re-read across edges from L2, the features of one level being
// at most a few MB).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// Merges the `len` bytes of one piece, read from `src` (2-byte aligned),
// into bytes [pos, pos + len) of the chunk's four words. Only the aligned
// words that hold a byte of the piece are loaded.
__device__ __forceinline__ void merge_piece(unsigned (&w)[4],
                                            const unsigned char* src,
                                            int pos, int len) {
  // chunk byte j of the piece is source byte v + j: v = src - pos
  const uintptr_t v = reinterpret_cast<uintptr_t>(src) - pos;
  const unsigned* a = reinterpret_cast<const unsigned*>(v & ~uintptr_t{3});
  const int sh = static_cast<int>(v & 3u);  // 0 or 2 bytes
  unsigned x[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    // word j holds chunk bytes [4j - sh, 4j - sh + 4)
    const int lo = 4 * j - sh;
    x[j] = (lo + 4 > pos && lo < pos + len) ? a[j] : 0u;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned val = __funnelshift_r(x[i], x[i + 1], 8 * sh);
    // the bytes of word i inside [pos, pos + len)
    const int b0 = max(pos - 4 * i, 0);
    const int b1 = min(pos + len - 4 * i, 4);
    if (b0 < b1) {
      const unsigned hi = b1 == 4 ? ~0u : (1u << (8 * b1)) - 1u;
      const unsigned mask = hi & ~((1u << (8 * b0)) - 1u);
      w[i] = (w[i] & ~mask) | (val & mask);
    }
  }
}

template <int kElem>
__global__ void __launch_bounds__(kThreads)
    window_gather_kernel(const unsigned char* __restrict__ feats,
                         const int64_t* __restrict__ idx,
                         const int64_t* __restrict__ count,
                         unsigned char* __restrict__ out, int n, int m,
                         int m_pad, int k, int c, int rows) {
  extern __shared__ int src_row[];  // rows * k: b*N + idx, or -1
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows;
  const int b = static_cast<int>(r0 / m_pad);  // rows divides m_pad
  const int m0 = static_cast<int>(r0 - static_cast<int64_t>(b) * m_pad);
  const int edges = rows * k;
  for (int i = threadIdx.x; i < edges; i += kThreads) {
    const int r = i / k;
    const int kk = i - r * k;
    int s = -1;
    if (m0 + r < m) {
      const int64_t q = static_cast<int64_t>(b) * m + m0 + r;
      if (kk < count[q]) {
        const int64_t j = idx[q * k + kk];
        s = b * n + static_cast<int>(j < 0 ? 0 : (j >= n ? n - 1 : j));
      }
    }
    src_row[i] = s;
  }
  __syncthreads();

  constexpr int kPer = 16 / kElem;  // elements a chunk
  const int row_bytes = c * kElem;
  const int chunks = edges * row_bytes / 16;
  uint4* dst = reinterpret_cast<uint4*>(out + r0 * k * row_bytes);
  // this thread's first chunk, and the step between its chunks
  int edge = threadIdx.x * kPer / c;
  int ch = threadIdx.x * kPer - edge * c;
  const int step_edges = kThreads * kPer / c;
  const int step_ch = kThreads * kPer - step_edges * c;
  for (int q = threadIdx.x; q < chunks; q += kThreads) {
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    int e = edge;
    int off = ch;
    for (int pos = 0; pos < 16; ++e, off = 0) {
      const int len = min(16 - pos, (c - off) * kElem);
      const int s = src_row[e];
      if (s >= 0) {
        const unsigned char* p =
            feats + (static_cast<int64_t>(s) * c + off) * kElem;
        if (len == 16 && (reinterpret_cast<uintptr_t>(p) & 15u) == 0) {
          v = *reinterpret_cast<const uint4*>(p);
        } else {
          unsigned w[4] = {v.x, v.y, v.z, v.w};
          merge_piece(w, p, pos, len);
          v = make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
      pos += len;
    }
    __stcs(dst + q, v);
    edge += step_edges;
    ch += step_ch;
    if (ch >= c) {
      ch -= c;
      ++edge;
    }
  }
}

}  // namespace

// feats: (B, N, C) of elem_bytes (2 or 4) each, elem_bytes-aligned; idx:
// (B, M, K) int64; count: (B, M) int64; out: (B, M_pad, K, C), 16-byte
// aligned. rows (8 to 128, a power of two) divides m_pad: the query rows a
// block writes.
extern "C" int sph3d_window_gather_launch(const void* feats,
                                          const int64_t* idx,
                                          const int64_t* count, void* out,
                                          int batch, int n, int m, int m_pad,
                                          int k, int c, int elem_bytes,
                                          int rows, void* stream) {
  if (n < 1 || m > m_pad || k < 1 || c < 1 ||
      (elem_bytes != 2 && elem_bytes != 4) || rows < 8 || rows > 128 ||
      (rows & (rows - 1)) != 0 || m_pad % rows != 0 ||
      static_cast<int64_t>(batch) * n >= INT32_MAX ||
      static_cast<int64_t>(rows) * k * c * elem_bytes >= INT32_MAX ||
      reinterpret_cast<uintptr_t>(feats) % elem_bytes != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  const int64_t blocks = static_cast<int64_t>(batch) * m_pad / rows;
  if (blocks == 0) return cudaSuccess;
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(rows) * k * sizeof(int);
  const auto st = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2) {
    static size_t allowed[sph3d::kMaxDevices] = {};
    auto kernel = window_gather_kernel<2>;
    const cudaError_t err = sph3d::allow_smem(kernel, smem, allowed);
    if (err != cudaSuccess) return err;
    kernel<<<static_cast<int>(blocks), kThreads, smem, st>>>(
        static_cast<const unsigned char*>(feats), idx, count,
        static_cast<unsigned char*>(out), n, m, m_pad, k, c, rows);
  } else {
    static size_t allowed[sph3d::kMaxDevices] = {};
    auto kernel = window_gather_kernel<4>;
    const cudaError_t err = sph3d::allow_smem(kernel, smem, allowed);
    if (err != cudaSuccess) return err;
    kernel<<<static_cast<int>(blocks), kThreads, smem, st>>>(
        static_cast<const unsigned char*>(feats), idx, count,
        static_cast<unsigned char*>(out), n, m, m_pad, k, c, rows);
  }
  return cudaGetLastError();
}

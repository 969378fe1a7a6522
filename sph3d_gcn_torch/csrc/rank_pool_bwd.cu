// K6: backward of the max pool from rank-valued neighbor maps.
//
// Replaces the TPU kernel sph3d_gcn_tpu/ops/dense.py:2035
// (_rank_pool_bwd_kernel, via _rank_window_max_for) and, behind
// dense_max_pool3d(with_index=True), sph3d_gcn_tpu/ops/dense.py:1826
// (_dense_pool_bwd_kernel: the same routing of each output gradient to
// its first maximal window column, followed there by the window gather's
// block scatter, here by the owner's sum). Plain PyTorch twin:
// sph3d_gcn_torch/ops/dense.py::rank_pool_bwd_plain.
//
//   dx[n, c] = sum over query rows t with arg[t, c] >= 0 and
//              s_blk*128 + arg[t, c] = n of dout[t, c]
//
// where arg is K4's first attaining window column (-1 for an empty row,
// which gives nothing). Sums are f32, rounded once to the feature dtype.
//
// Design: pool windows of neighbouring query tiles overlap, so a feature
// row may receive from several tiles. Every 128-row block of x has ONE
// owner for each 256-channel chunk instead of a scatter with float
// atomics: a thread block per (x block, cloud, channel chunk; the chunk
// is the grid's z index, C <= 512), one warp per 32-channel slot (lane =
// channel), walks the query tiles whose window covers its block in tile
// order, and each thread adds its channel's dout values to its own column
// of a (128, chunk) f32 accumulator in shared memory (128 KB at most), in
// the fixed order (tile, query row): bitwise reproducible, whatever the
// chunking. The TPU kernel re-expanded arg into a one-hot
// rank matrix and multiplied it back through the (128, W) rank map; the
// column index is already all that is needed.
//
// What bounds it on the H100: reading arg (int32) and dout for every
// covering tile, about W/128 / (tile stride) tiles per block, coalesced
// over channels.
#include "common.cuh"

namespace {

using sph3d::kTile;

constexpr int kChunk = 256;       // channels per block (grid z)
constexpr int kMaxC = 2 * kChunk;  // C <= 512

template <typename T>
__global__ void rank_pool_bwd_kernel(const int* __restrict__ s_blk,
                                     const int* __restrict__ arg,
                                     const T* __restrict__ dout,
                                     T* __restrict__ dx, int n_t, int n,
                                     int c, int window) {
  extern __shared__ float acc_s[];  // (128, cw)
  const int nb = blockIdx.x;
  const int b = blockIdx.y;
  const int c0 = blockIdx.z * kChunk;
  const int cw = min(kChunk, c - c0);  // channels of this chunk
  const int chl = threadIdx.x;         // one thread per channel
  const int ch = c0 + chl;
  const bool live = chl < cw;
  const int nbw = window / kTile;
  const int row0 = nb * kTile;
  const int rows = min(kTile, n - row0);
  if (live) {
    for (int i = 0; i < kTile; ++i) acc_s[i * cw + chl] = 0.f;
  }
  for (int tile = 0; tile < n_t; ++tile) {
    const int g = b * n_t + tile;
    const int sb = s_blk[g];
    if (nb < sb || nb >= sb + nbw || !live) continue;
    const int shift = (sb - nb) * kTile;  // block row of window column 0
    const size_t base = static_cast<size_t>(g) * kTile * c + ch;
    for (int t = 0; t < kTile; ++t) {
      const size_t e = base + static_cast<size_t>(t) * c;
      const int a = arg[e];
      const int r = shift + a;
      if (a >= 0 && r >= 0 && r < kTile) {
        acc_s[r * cw + chl] += sph3d::to_float(dout[e]);
      }
    }
  }
  if (live) {
    T* dxb = dx + (static_cast<size_t>(b) * n + row0) * c;
    for (int i = 0; i < rows; ++i) {
      dxb[i * c + ch] = sph3d::from_float<T>(acc_s[i * cw + chl]);
    }
  }
}

template <typename T>
cudaError_t launch(const int* s_blk, const int* arg, const void* dout,
                   void* dx, int batch, int n_t, int n, int c, int window,
                   cudaStream_t stream) {
  const int n_blk = (n + kTile - 1) / kTile;
  const int width = c < kChunk ? c : kChunk;  // the widest chunk
  const size_t smem = static_cast<size_t>(kTile) * width * sizeof(float);
  auto kernel = rank_pool_bwd_kernel<T>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int threads = ((width + 31) / 32) * 32;
  const dim3 grid(n_blk, batch, (c + kChunk - 1) / kChunk);
  kernel<<<grid, threads, smem, stream>>>(
      s_blk, arg, static_cast<const T*>(dout), static_cast<T*>(dx), n_t, n,
      c, window);
  return cudaGetLastError();
}

}  // namespace

// arg, dout: (B, M_pad, C); dx: (B, N, C) in the feature dtype.
extern "C" int sph3d_rank_pool_bwd_launch(const int* s_blk, const int* arg,
                                          const void* dout, void* dx,
                                          int batch, int n_t, int n, int c,
                                          int window, int is_bf16,
                                          void* stream) {
  if (c < 1 || c > kMaxC || window % kTile != 0) {
    return cudaErrorInvalidValue;
  }
  const auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch<__nv_bfloat16>(s_blk, arg, dout, dx, batch, n_t, n, c,
                                 window, st);
  }
  return launch<float>(s_blk, arg, dout, dx, batch, n_t, n, c, window, st);
}

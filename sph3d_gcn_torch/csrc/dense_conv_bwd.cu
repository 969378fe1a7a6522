// K5: backward of the depthwise spherical conv from packed bin maps.
//
// Replaces BOTH TPU kernels sph3d_gcn_tpu/ops/dense.py:692
// (_dense_conv_bwd_kernel, the backward of the C_in <= 128 conv) and
// sph3d_gcn_tpu/ops/dense.py:1183 (_dense_conv_rm_bwd_kernel, C_in > 128):
// one function in two TPU layouts, as K3 (dense_conv.cu) serves both
// forwards. Plain PyTorch twin: sph3d_gcn_torch/ops/dense.py::
// dense_conv_bwd_plain.
//
// With g[t, c, j] = inv[t] * dout[t, c*r + j] and the map entry pk of
// query row t at window column w (0: not selected, else bin + 1):
//
//   dx[n, c]          = sum over (t, w) with pk != 0 and s_blk*128 + w = n
//                       of sum_j g[t, c, j] * filt_b[pk - 1, c, j]
//   dfilt_b[b, f, c, j] = sum over (t, w) of cloud b with pk = f + 1
//                       of g[t, c, j] * x[s_blk*128 + w, c]
//
// Sums are f32; dx is rounded once to the feature dtype, dfilt stays f32.
//
// Design: the windows of neighbouring query tiles overlap, so a feature
// row receives gradient from several tiles. Instead of scattering (float
// atomics: run-to-run different sums), every 128-row block of x has ONE
// owner for each channel chunk: a thread block per (x block, cloud,
// channel chunk). It walks the query tiles whose window covers its block
// in tile order; for each it stages the tile's 128 x 128 map slice (the
// columns over its block), its chunk of the dout rows and the inverse
// counts in shared memory. Its warps are (channel slot, column group)
// pairs: lane = channel, and the G column groups take the block's columns
// i = g, g + G, ... Each warp scans its columns (a ballot over 32 query
// rows at a time), accumulating the column's dx in a register and its
// group's dfilt partial in shared memory; the G partials are summed in
// group order at the end. Every sum runs in one fixed order (tile,
// column, query row; then group), so the result is bitwise reproducible;
// chunking the channels changes no channel's order. The per-block dfilt
// partials (B, n_blk, F, C, r) are reduced over blocks by the caller, in
// a fixed order too.
//
// Shared memory holds the chunk's filter and G partials (F x chunk x r
// f32 each), so it grows with the chunk width: a row of up to 256
// channels stays in one block when it fits with at least two column
// groups (every ModelNet conv); a wider row (the S3DIS convs reach
// C_in = 1024, all with r = 2) is cut into chunks of 64 channels (the
// grid's z index), which fit with four groups in bf16 and f32 alike (at
// most 196 KB).
//
// No S stash, no one-hot matmul: the TPU kernels re-contracted a one-hot
// (F*128, W) bin matrix per tile to feed its matrix unit; here only the
// selected entries cost arithmetic. What bounds it on the H100: the
// per-warp serial scan of the covering slices (about W/128 tiles x
// 128/G columns x 4 ballots per warp), repeated once per channel chunk,
// and the few warps a block's shared memory leaves resident per SM.
#include "common.cuh"

namespace {

using sph3d::kFullMask;
using sph3d::kTile;

constexpr int kRowPad = kTile + 4;  // map slice row stride: no bank conflicts

constexpr int kMaxGroups = 4;
constexpr size_t kMaxSmem = 227 * 1024;
constexpr int kMaxC = 1024;
constexpr int kRowChunk = 256;   // widest row kept in one block
constexpr int kWideChunk = 64;   // chunk width of wider rows

// Dynamic shared memory of one block with a chunk of cw channels and G
// column groups: f32 filter (F, cw, R) and G dfilt partials of that
// shape, f32 dx accumulator (128, cw), 1/count (128,), the tile's dout
// rows (128, cw*R) in the feature dtype and its map slice (128, 132) int8.
size_t smem_bytes(int cw, int f_bins, int r, int elem, int groups) {
  return ((1 + groups) * static_cast<size_t>(f_bins) * cw * r + kTile * cw +
          kTile) * 4 +
         static_cast<size_t>(kTile) * cw * r * elem + kTile * kRowPad;
}

template <typename T, int R>
__global__ void dense_conv_bwd_kernel(
    const int8_t* __restrict__ packed, const int* __restrict__ s_blk,
    const T* __restrict__ x, const float* __restrict__ filt,
    const float* __restrict__ inv, const T* __restrict__ dout,
    T* __restrict__ dx, float* __restrict__ dfilt_part, int n_t, int n,
    int c, int cc, int f_bins, int window, int n_blk, int groups) {
  extern __shared__ float smem[];
  const int c0 = blockIdx.z * cc;         // this block's first channel
  const int cw = min(cc, c - c0);         // channels of this chunk
  const int fcr = f_bins * cw * R;        // the chunk's filter entries
  const int cwr = cw * R;
  const int cr = c * R;
  float* filt_s = smem;                  // (F, cw, R) this cloud's filter
  float* part_s = filt_s + fcr;          // (G, F, cw, R) the groups' dfilt
  float* acc_s = part_s + groups * fcr;  // (128, cw) dx of the block's rows
  float* inv_s = acc_s + kTile * cw;     // (128,) the tile's 1/count
  T* dout_s = reinterpret_cast<T*>(inv_s + kTile);           // (128, cw*R)
  int8_t* pk_s = reinterpret_cast<int8_t*>(dout_s + kTile * cwr);

  const int nb = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int slots = cc / 32;
  const int grp = (tid >> 5) / slots;     // this warp's column group
  const int chl = ((tid >> 5) % slots) * 32 + lane;  // channel in the chunk
  const int ch = c0 + chl;                // channel in the row
  const bool live = chl < cw;
  float* dfilt_s = part_s + grp * fcr;    // (F, cw, R) this group's partial
  const int m_pad = n_t * kTile;
  const int nbw = window / kTile;
  const int row0 = nb * kTile;
  const int rows = min(kTile, n - row0);
  const T* xb = x + (static_cast<size_t>(b) * n + row0) * c;

  const float* fb = filt + static_cast<size_t>(b) * f_bins * cr + c0 * R;
  for (int k = tid; k < fcr; k += blockDim.x) {
    const int f = k / cwr;
    filt_s[k] = fb[static_cast<size_t>(f) * cr + (k - f * cwr)];
  }
  for (int k = tid; k < groups * fcr; k += blockDim.x) part_s[k] = 0.f;
  for (int k = tid; k < kTile * cw; k += blockDim.x) acc_s[k] = 0.f;

  for (int tile = 0; tile < n_t; ++tile) {
    const int g = b * n_t + tile;
    const int sb = s_blk[g];
    if (nb < sb || nb >= sb + nbw) continue;  // uniform across the block
    const int off = (nb - sb) * kTile;        // window column of block row 0
    __syncthreads();  // the previous tile's operands are no longer read
    const int* src = reinterpret_cast<const int*>(
        packed + static_cast<size_t>(g) * kTile * window + off);
    for (int k = tid; k < kTile * (kTile / 4); k += blockDim.x) {
      const int t = k / (kTile / 4);
      const int q = k % (kTile / 4);
      reinterpret_cast<int*>(pk_s + t * kRowPad)[q] =
          src[static_cast<size_t>(t) * (window / 4) + q];
    }
    const size_t qrow = static_cast<size_t>(b) * m_pad + tile * kTile;
    for (int k = tid; k < kTile; k += blockDim.x) inv_s[k] = inv[qrow + k];
    const T* db = dout + qrow * cr + c0 * R;
    for (int k = tid; k < kTile * cwr; k += blockDim.x) {
      const int t = k / cwr;
      dout_s[k] = db[static_cast<size_t>(t) * cr + (k - t * cwr)];
    }
    __syncthreads();

    for (int i = grp; i < rows; i += groups) {
      const float xv = live ? sph3d::to_float(xb[i * c + ch]) : 0.f;
      float acc = 0.f;
#pragma unroll
      for (int t0 = 0; t0 < kTile; t0 += 32) {
        const int pk = pk_s[(t0 + lane) * kRowPad + i];
        unsigned bal = __ballot_sync(kFullMask, pk != 0);
        while (bal) {
          const int src_lane = __ffs(bal) - 1;
          bal &= bal - 1;
          const int f = __shfl_sync(kFullMask, pk, src_lane) - 1;
          const int t = t0 + src_lane;
          if (live) {
            const float iv = inv_s[t];
            const T* dr = dout_s + t * cwr + chl * R;
            const float* fr = filt_s + (f * cw + chl) * R;
            float* pr = dfilt_s + (f * cw + chl) * R;
#pragma unroll
            for (int j = 0; j < R; ++j) {
              const float gv = iv * sph3d::to_float(dr[j]);
              acc = fmaf(gv, fr[j], acc);
              pr[j] = fmaf(gv, xv, pr[j]);
            }
          }
        }
      }
      if (live) acc_s[i * cw + chl] += acc;
    }
  }

  // the accumulators were zeroed by other threads than their readers,
  // and group 0 reads every group's partial
  __syncthreads();
  if (live) {
    T* dxb = dx + (static_cast<size_t>(b) * n + row0) * c;
    for (int i = grp; i < rows; i += groups) {
      dxb[i * c + ch] = sph3d::from_float<T>(acc_s[i * cw + chl]);
    }
  }
  if (live && grp == 0) {
    float* part = dfilt_part +
                  (static_cast<size_t>(b) * n_blk + nb) * f_bins * cr;
    for (int f = 0; f < f_bins; ++f) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int k = (f * cw + chl) * R + j;
        float sum = part_s[k];
        for (int g = 1; g < groups; ++g) sum += part_s[g * fcr + k];
        part[(f * c + ch) * R + j] = sum;
      }
    }
  }
}

// The most column groups (at least min_groups) whose shared memory for a
// chunk of cw channels fits a block, with that size; 0 if none fits.
template <typename T, int R>
int groups_for(int cw, int f_bins, int min_groups, size_t* smem) {
  for (int g = kMaxGroups; g >= min_groups; g /= 2) {
    *smem = smem_bytes(cw, f_bins, R, sizeof(T), g);
    if (*smem <= kMaxSmem) return g;
  }
  return 0;
}

// The block shape for a row of c channels, as described above: the chunk
// width cc (a multiple of 32), the column groups G (0 when no shape fits)
// and the shared memory of the widest chunk, min(cc, c) channels.
template <typename T, int R>
void plan(int c, int f_bins, int* cc, int* groups, size_t* smem) {
  *cc = (c + 31) / 32 * 32;
  *groups = *cc <= kRowChunk ? groups_for<T, R>(c, f_bins, 2, smem) : 0;
  if (*groups == 0) {
    if (*cc > kWideChunk) *cc = kWideChunk;
    *groups = groups_for<T, R>(*cc < c ? *cc : c, f_bins, 1, smem);
  }
}

template <typename T, int R>
cudaError_t launch(const int8_t* packed, const int* s_blk, const void* x,
                   const float* filt, const float* inv, const void* dout,
                   void* dx, float* dfilt_part, int batch, int n_t, int n,
                   int c, int f_bins, int window, cudaStream_t stream) {
  const int n_blk = (n + kTile - 1) / kTile;
  int cc, groups;
  size_t smem;
  plan<T, R>(c, f_bins, &cc, &groups, &smem);
  if (groups == 0) return cudaErrorInvalidValue;  // too wide for a block
  auto kernel = dense_conv_bwd_kernel<T, R>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(n_blk, batch, (c + cc - 1) / cc);
  kernel<<<grid, cc * groups, smem, stream>>>(
      packed, s_blk, static_cast<const T*>(x), filt, inv,
      static_cast<const T*>(dout), static_cast<T*>(dx), dfilt_part, n_t, n,
      c, cc, f_bins, window, n_blk, groups);
  return cudaGetLastError();
}

}  // namespace

// dx: (B, N, C) in the feature dtype; dfilt_part: (B, ceil(N/128), F, C, r)
// f32, one partial per x block (the caller sums them over blocks).
extern "C" int sph3d_dense_conv_bwd_launch(
    const int8_t* packed, const int* s_blk, const void* x, const float* filt,
    const float* inv, const void* dout, void* dx, float* dfilt_part,
    int batch, int n_t, int n, int c, int f_bins, int window, int mult,
    int is_bf16, void* stream) {
  if (c < 1 || c > kMaxC || (mult != 1 && mult != 2) ||
      window % kTile != 0) {
    return cudaErrorInvalidValue;
  }
  const auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return mult == 1
        ? launch<__nv_bfloat16, 1>(packed, s_blk, x, filt, inv, dout, dx,
                                   dfilt_part, batch, n_t, n, c, f_bins,
                                   window, st)
        : launch<__nv_bfloat16, 2>(packed, s_blk, x, filt, inv, dout, dx,
                                   dfilt_part, batch, n_t, n, c, f_bins,
                                   window, st);
  }
  return mult == 1
      ? launch<float, 1>(packed, s_blk, x, filt, inv, dout, dx, dfilt_part,
                         batch, n_t, n, c, f_bins, window, st)
      : launch<float, 2>(packed, s_blk, x, filt, inv, dout, dx, dfilt_part,
                         batch, n_t, n, c, f_bins, window, st);
}

// K2: dense windowed sphere query -> packed int8 neighbor maps.
//
// Replaces the TPU kernel sph3d_gcn_tpu/ops/pallas/query_kernel.py:245
// (_query_kernel, reached via dense_query_pallas), with its need_dist map
// (:296-299). The radius-growth query of the decoders' inter graphs is K7,
// csrc/growth_query.cu. Plain PyTorch twin:
// sph3d_gcn_torch/ops/query.py::dense_query_plain.
//
// One block per (cloud, 128-query tile). The block stages the live part
// of its window (the first u_end*128 of W axis-sorted database rows,
// starting at row s_blk*128) in shared memory as x/y/z planes. Each warp
// then owns query rows and walks the window in 32-column steps: lane i
// tests column c0+i, and the in-window rank (first K in point order) is
// a ballot + popc prefix count carried across steps, where the TPU kernel
// multiplied by a triangular ones matrix on the MXU. Every map byte of
// the tile is written: selections, zeros past u_end, zeros on padded
// query rows (their 1e9 sentinel coordinates are never in range).
//
// Map value: mode 0 the rank 1..K; mode 1 the spherical bin + 1 of the
// (8, 2, q) kernel (compare-only form of _bins_822); mode 2 the same bin
// SORT-GROUPED by the cloud's sort axis.
//
// Distance map (optional, dist != nullptr): an f32 (B, nT, 128, W) map
// beside the int8 one, sqrtf(d3) where the entry is selected and 0
// everywhere else (past u_end and past the K-th neighbor too). d3 is
// already the Euclidean distance, so the map holds the reference's
// sqrt-space distance (ref tf_nnquery_gpu.cu:54). Lane i stores column
// c0+i, so each warp store is 128 contiguous bytes. The map is a template
// branch: a launch without it runs the code of the int8-only kernel.
//
// What bounds it on the H100: instruction throughput of the
// per-candidate arithmetic (distance, sqrt, radius test, bin compares:
// ~40 instructions for each of B*M*W candidates); device memory traffic
// is the int8 map write, B*M*W bytes (five times that with the f32
// distance map). Warps stop computing once their row has K neighbors.
//
// Numerics: sqrt((dx*dx + dy*dy) + dz*dz) is written without FMA
// contraction (sum_sq3) and sqrtf is IEEE-rounded, so radius tests and
// radial bins equal the plain version's bit for bit; the map's sqrtf is
// IEEE-rounded too (no --use_fast_math), so it equals torch.sqrt's.
#include "common.cuh"

namespace {

using sph3d::kFullMask;
using sph3d::kTile;

constexpr int kWarps = 8;

struct BinParams {
  int grouped;       // 1: sort-grouped ids
  int sort_axis;     // the cloud's sort axis (grouped ids only)
  int q_bins;        // radial bins, 1..4
  float thr[3];      // radial thresholds (squared-space quirk, see Python)
  float far_thr;     // self-loop threshold
};

// _bins_822: the stored id minus one (ref bin, or its grouped number).
__device__ __forceinline__ int bin822(float dx, float dy, float dz, float d3,
                                      const BinParams& bp) {
  const float ux = -dx, uy = -dy;
  const float ax = fabsf(ux), ay = fabsf(uy);
  int o_pos = ux > 0.f ? (ay < ax ? 0 : 1) : (ay > ax ? 2 : 3);
  if (uy == 0.f && ux < 0.f) o_pos = 4;
  const int o_neg = ux < 0.f ? (ay < ax ? 4 : 5) : (ay > ax ? 6 : 7);
  int n = uy >= 0.f ? o_pos : o_neg;
  // dx == dy == +-0: atan2's signed-zero convention decides the bin
  if (ax == 0.f && ay == 0.f) n = (__float_as_uint(dx) >> 31) ? 0 : 4;
  const int p = dz >= 0.f ? 1 : 0;
  int q = 0;
  for (int j = 0; j < bp.q_bins - 1; ++j) q += d3 >= bp.thr[j] ? 1 : 0;
  if (!bp.grouped) return d3 > bp.far_thr ? q * 16 + p * 8 + n + 1 : 0;
  const int a = bp.sort_axis;
  const bool hemi = a == 2 ? p == 1 : (a == 0 ? (n >= 2 && n <= 5) : n >= 4);
  const int i4x = hemi ? n - 2 : (n + 2) & 7;
  const int i4y = hemi ? n - 4 : n;
  const int inhemi = a == 2 ? n : p * 4 + (a == 0 ? i4x : i4y);
  const bool outer = q == bp.q_bins - 1;
  const int gid = hemi ? (outer ? 16 * bp.q_bins - 6 + inhemi
                                : 8 * bp.q_bins + 2 + q * 8 + inhemi)
                       : (outer ? 1 + inhemi : 9 + q * 8 + inhemi);
  return d3 > bp.far_thr ? gid - 1 : 8 * bp.q_bins;
}

template <bool kDist>
__global__ void __launch_bounds__(kWarps * 32)
    dense_query_kernel(const float* __restrict__ db,
                       const float* __restrict__ q,
                       const int* __restrict__ s_blk,
                       const int* __restrict__ u_end,
                       const int* __restrict__ axis,
                       int8_t* __restrict__ out, float* __restrict__ dist,
                       int n_pad, int n_t, int window, int k, int mode,
                       BinParams bp, float radius) {
  extern __shared__ float win[];
  const int g = blockIdx.x;  // b * n_t + tile
  const int b = g / n_t;
  const int live = u_end[g] * kTile;  // columns that can hold candidates
  const float* dbw =
      db + (static_cast<size_t>(b) * n_pad +
            static_cast<size_t>(s_blk[g]) * kTile) * 3;
  float* wx = win;
  float* wy = win + live;
  float* wz = win + 2 * live;
  for (int i = threadIdx.x; i < live; i += blockDim.x) {
    wx[i] = dbw[3 * i];
    wy[i] = dbw[3 * i + 1];
    wz[i] = dbw[3 * i + 2];
  }
  if (mode == 2) bp.sort_axis = axis[b];
  bp.grouped = mode == 2;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const unsigned le_mask = kFullMask >> (31 - lane);  // lanes <= this one
  for (int t = threadIdx.x >> 5; t < kTile; t += kWarps) {
    const size_t row = static_cast<size_t>(g) * kTile + t;
    const float qx = q[3 * row], qy = q[3 * row + 1], qz = q[3 * row + 2];
    int8_t* orow = out + row * window;
    float* drow = kDist ? dist + row * window : nullptr;
    int off = 0;  // in-range candidates in earlier columns
    for (int c0 = 0; c0 < window; c0 += 32) {
      const int w = c0 + lane;
      int val = 0;
      float dval = 0.f;
      if (c0 < live && off < k) {  // warp-uniform
        const float dx = wx[w] - qx, dy = wy[w] - qy, dz = wz[w] - qz;
        const float d3 = sqrtf(sph3d::sum_sq3(dx, dy, dz));
        const bool in_r = d3 < radius && fabsf(d3 - radius) > 1e-6f;
        const unsigned bal = __ballot_sync(kFullMask, in_r);
        const int rank = off + __popc(bal & le_mask);
        if (in_r && rank <= k) {
          val = mode == 0 ? rank : bin822(dx, dy, dz, d3, bp) + 1;
          if (kDist) dval = sqrtf(d3);
        }
        off += __popc(bal);
      }
      orow[w] = static_cast<int8_t>(val);
      if (kDist) drow[w] = dval;
    }
  }
}

template <bool kDist>
cudaError_t launch(const float* db, const float* q, const int* s_blk,
                   const int* u_end, const int* axis, int8_t* out,
                   float* dist, int grid, int n_pad, int n_t, int window,
                   int k, int mode, const BinParams& bp, float radius,
                   cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float) * 3 * window);
  cudaError_t err = cudaFuncSetAttribute(
      dense_query_kernel<kDist>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dense_query_kernel<kDist><<<grid, kWarps * 32, smem, stream>>>(
      db, q, s_blk, u_end, axis, out, dist, n_pad, n_t, window, k, mode, bp,
      radius);
  return cudaGetLastError();
}

}  // namespace

// dist: the f32 distance map, or nullptr for the int8 map alone.
extern "C" int sph3d_dense_query_launch(
    const float* db, const float* q, const int* s_blk, const int* u_end,
    const int* axis, int8_t* out, float* dist, int batch, int n_pad,
    int n_t, int window, int k, int mode, int q_bins, float radius,
    float thr1, float thr2, float thr3, float far_thr, void* stream) {
  BinParams bp{0, 0, q_bins, {thr1, thr2, thr3}, far_thr};
  const auto st = static_cast<cudaStream_t>(stream);
  if (dist == nullptr) {
    return launch<false>(db, q, s_blk, u_end, axis, out, nullptr,
                         batch * n_t, n_pad, n_t, window, k, mode, bp,
                         radius, st);
  }
  return launch<true>(db, q, s_blk, u_end, axis, out, dist, batch * n_t,
                      n_pad, n_t, window, k, mode, bp, radius, st);
}

// K2: dense windowed sphere query -> packed int8 neighbor maps.
//
// Replaces the TPU kernel sph3d_gcn_tpu/ops/pallas/query_kernel.py:245
// (_query_kernel, reached via dense_query_pallas), with its need_dist map
// (:296-299). The radius-growth query of the decoders' inter graphs is K7,
// csrc/growth_query.cu. Plain PyTorch twin:
// sph3d_gcn_torch/ops/query.py::dense_query_plain.
//
// A query tile (128 rows, one cloud) takes `split` blocks of 8 warps
// (1-16, ops/query.py::query_split: the fewest that give the card 528
// blocks, so the small calls of the deep levels and the decoders spread
// over the SMs too). A block stages the live part of its tile's window
// (the first u_end*128 of W axis-sorted database rows, starting at row
// s_blk*128; u_end clamped to [1, W/128] here) in shared memory as x/y/z
// planes. Each warp then owns rows of the block's share and walks the
// live window in steps of 128 columns, 4 consecutive columns a lane
// (common.cuh walk_row): a step loads one float4 of each plane a lane,
// ranks the in-range columns with four ballots and popcounts (the TPU
// kernel multiplied by a triangular ones matrix on the MXU), and stores
// one 4-byte word of the int8 map a lane (a float4 of the distance map).
// Rank maps build the word in the lane. A bin map (or any map with its
// distances) lists the step's selected columns in shared memory and the
// warp computes their bins (and square roots) one entry a lane, so a
// step pays the bins' ~40 instructions once, not once for each of the 4
// column slots in which some lane selects; a step with no selection
// skips the list. A row stops after the step in which it reaches K; its
// remaining columns, those past u_end included, are zero-filled with
// 16-byte stores. Padded query rows (1e9 sentinels) are never in range.
// The kernel also writes each row's count, min(in-range, K): the number
// of nonzero bytes of the row, which the graph build would otherwise
// reduce from the whole map.
//
// Map value: mode 0 the rank 1..K; mode 1 the spherical bin + 1 of the
// (8, 2, q) kernel (compare-only form of _bins_822); mode 2 the same bin
// SORT-GROUPED by the cloud's sort axis (axis is read in mode 2 only).
//
// Distance map (optional, dist != nullptr): an f32 (B, nT, 128, W) map
// beside the int8 one, sqrtf(d3) where the entry is selected and 0
// everywhere else (past u_end and past the K-th neighbor too), with d3 =
// sqrtf(s) the Euclidean distance: the reference's sqrt-space distance
// (ref tf_nnquery_gpu.cu:54). The map is a template branch: a launch
// without it runs the code of the int8-only kernel.
//
// Thresholds in squared distance (no square root per candidate). The
// plain version tests d3 = sqrtf(s), s = (dx*dx + dy*dy) + dz*dz:
// in range iff d3 < r and |d3 - r| > 1e-6, radial bin j iff d3 >= thr_j,
// not the self loop iff d3 > far. sqrtf is correctly rounded, so d3 does
// not decrease as s grows; the range test holds for small d3 and fails
// from some d3 on, since fl(r - d3) does not grow with d3; each bin test
// fails for small d3 and holds from some d3 on. So each test flips at one
// f32 value of s, and the wrapper finds it by bisection over the f32 bit
// patterns with numpy's f32 square root (also correctly rounded, so it
// agrees with sqrtf): in range iff s < t_in, bin j iff s >= t_j, not the
// self loop iff s >= t_far (ops/query.py::query_thresholds). The tests
// equal the plain version's bit for bit; sqrtf runs only for a selected
// entry's distance map value.
//
// What bounds it on the H100: instruction throughput of the
// per-candidate arithmetic (three subtractions, three multiplies, two
// adds and a compare for each of B*M*W live candidates, until the row
// has K neighbors, with the ballots and the word's assembly about 20
// instructions a candidate; the bins' compares for selected entries
// only); device memory traffic is the int8 map write, B*M*W bytes (five
// times that with the f32 distance map). A warp walks one row at a time:
// the four columns of a lane are four independent chains already, and
// 8 warps of up to 8 blocks an SM hide the shared-memory latency.
//
// Numerics: s is formed without FMA contraction (sum_sq3), exactly as the
// plain version forms it, and the map's sqrtf is IEEE-rounded (no
// --use_fast_math), so it equals torch.sqrt's.
#include "common.cuh"

namespace {

using sph3d::kMaxDevices;
using sph3d::kQueryWarps;
using sph3d::kTile;

struct BinParams {
  int grouped;       // 1: sort-grouped ids
  int sort_axis;     // the cloud's sort axis (grouped ids only)
  int q_bins;        // radial bins, 1..4
  float t_radial[3];  // radial bin j + 1 iff s >= t_radial[j]
  float t_far;       // not the self loop iff s >= t_far
};

// _bins_822: the stored id minus one (ref bin, or its grouped number).
__device__ __forceinline__ int bin822(float dx, float dy, float dz, float s,
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
#pragma unroll
  for (int j = 0; j < 3; ++j) {  // constant indices: no local-memory copy
    q += j < bp.q_bins - 1 && s >= bp.t_radial[j] ? 1 : 0;
  }
  const bool far = s >= bp.t_far;
  if (!bp.grouped) return far ? q * 16 + p * 8 + n + 1 : 0;
  const int a = bp.sort_axis;
  const bool hemi = a == 2 ? p == 1 : (a == 0 ? (n >= 2 && n <= 5) : n >= 4);
  const int i4x = hemi ? n - 2 : (n + 2) & 7;
  const int i4y = hemi ? n - 4 : n;
  const int inhemi = a == 2 ? n : p * 4 + (a == 0 ? i4x : i4y);
  const bool outer = q == bp.q_bins - 1;
  const int gid = hemi ? (outer ? 16 * bp.q_bins - 6 + inhemi
                                : 8 * bp.q_bins + 2 + q * 8 + inhemi)
                       : (outer ? 1 + inhemi : 9 + q * 8 + inhemi);
  return far ? gid - 1 : 8 * bp.q_bins;
}

template <bool kDist>
__global__ void __launch_bounds__(kQueryWarps * 32)
    dense_query_kernel(const float* __restrict__ db,
                       const float* __restrict__ q,
                       const int64_t* __restrict__ s_blk,
                       const int64_t* __restrict__ u_end,
                       const int* __restrict__ axis,
                       int8_t* __restrict__ out, float* __restrict__ dist,
                       int* __restrict__ count, int n_pad, int n_t,
                       int window, int k, int mode, int split, float t_in,
                       BinParams bp) {
  extern __shared__ __align__(16) float win[];
  __shared__ __align__(16) sph3d::StepList lists[kQueryWarps];
  const int g = blockIdx.x / split;  // b * n_t + tile
  const int rows = kTile / split;    // this block's rows of the tile
  const int t0 = blockIdx.x % split * rows;
  const int b = g / n_t;
  const int live = sph3d::live_columns(u_end[g], window);
  sph3d::stage_window(
      db + (static_cast<size_t>(b) * n_pad +
            static_cast<size_t>(s_blk[g]) * kTile) * 3,
      live, win);
  if (mode == 2) bp.sort_axis = axis[b];
  bp.grouped = mode == 2;
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const auto value = [=](int rank, float dx, float dy, float dz, float s) {
    return mode == 0 ? rank : bin822(dx, dy, dz, s, bp) + 1;
  };
  for (int t = t0 + warp; t < t0 + rows; t += kQueryWarps) {
    const size_t row = static_cast<size_t>(g) * kTile + t;
    const float qx = q[3 * row], qy = q[3 * row + 1], qz = q[3 * row + 2];
    int8_t* orow = out + row * window;
    float* drow = kDist ? dist + row * window : nullptr;
    // ranks alone in the lanes' words; bins or distances through the list
    const int n =
        mode == 0 && !kDist
            ? sph3d::walk_row<false, false>(win, live, window, qx, qy, qz,
                                            t_in, k, orow, drow,
                                            &lists[warp], value)
            : sph3d::walk_row<kDist, true>(win, live, window, qx, qy, qz,
                                           t_in, k, orow, drow,
                                           &lists[warp], value);
    if ((threadIdx.x & 31) == 0) count[row] = min(n, k);
  }
}

template <bool kDist>
cudaError_t launch(const float* db, const float* q, const int64_t* s_blk,
                   const int64_t* u_end, const int* axis, int8_t* out,
                   float* dist, int* count, int grid, int n_pad, int n_t,
                   int window, int k, int mode, int split, float t_in,
                   const BinParams& bp, cudaStream_t stream) {
  static bool allowed[kMaxDevices] = {};
  cudaError_t err =
      sph3d::allow_all_smem(dense_query_kernel<kDist>, allowed);
  if (err != cudaSuccess) return err;
  const int smem = static_cast<int>(sizeof(float) * 3 * window);
  dense_query_kernel<kDist><<<grid, kQueryWarps * 32, smem, stream>>>(
      db, q, s_blk, u_end, axis, out, dist, count, n_pad, n_t, window, k,
      mode, split, t_in, bp);
  return cudaGetLastError();
}

}  // namespace

// s_blk, u_end: (B, nT) int64; axis: (B,) int32, read in mode 2 only (may
// be nullptr otherwise); dist: the f32 distance map, or nullptr for the
// int8 map alone; count: (B, nT*128) int32; split: blocks a query tile
// (1, 2, 4, 8 or 16; ops/query.py::query_split). t_in, t_radial1..3,
// t_far: the squared-distance thresholds of ops/query.py::query_thresholds.
extern "C" int sph3d_dense_query_launch(
    const float* db, const float* q, const int64_t* s_blk,
    const int64_t* u_end, const int* axis, int8_t* out, float* dist,
    int* count, int batch, int n_pad, int n_t, int window, int k, int mode,
    int q_bins, int split, float t_in, float t_radial1, float t_radial2,
    float t_radial3, float t_far, void* stream) {
  if (split < 1 || split > kTile / kQueryWarps || kTile % split) {
    return cudaErrorInvalidValue;
  }
  const BinParams bp{0, 0, q_bins, {t_radial1, t_radial2, t_radial3}, t_far};
  const auto st = static_cast<cudaStream_t>(stream);
  const int grid = batch * n_t * split;
  if (dist == nullptr) {
    return launch<false>(db, q, s_blk, u_end, axis, out, nullptr, count,
                         grid, n_pad, n_t, window, k, mode, split, t_in, bp,
                         st);
  }
  return launch<true>(db, q, s_blk, u_end, axis, out, dist, count, grid,
                      n_pad, n_t, window, k, mode, split, t_in, bp, st);
}

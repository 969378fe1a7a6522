// K7: dense windowed sphere query with +0.05 radius growth -> rank maps.
//
// Replaces the TPU kernel sph3d_gcn_tpu/ops/pallas/query_kernel.py:307
// (_growth_kernel, reached via dense_query_pallas with growth_steps > 0),
// with its need_dist map (:365-369). Plain PyTorch twin:
// sph3d_gcn_torch/ops/query.py::growth_query_plain.
//
// The decoders' fine->coarse inter graphs grow the radius of a query with
// no neighbor by +0.05 (ref tf_nnquery_gpu.cu:30-60). With the G+1 radii
// r_0..r_G (a running f32 sum, computed by the wrapper) and, per query row
// and live window column w,
//
//   g(w)  = #{i : not (d3 < r_i and |d3 - r_i| > 1e-6)}     in 0..G+1
//   g*    = min(G+1, min_w g(w)),  alive = g* < G+1
//   in(w) = alive and g(w) <= g*   (the in-range set at radius r_{g*})
//   rank  = inclusive count of in along the window; packed = in and
//           rank <= K ? rank : 0;  step[row] = alive ? g* : 0
//
// Thresholds in squared distance, as in K2 (csrc/dense_query.cu): for
// each radius one f32 value t_i of s = (dx*dx + dy*dy) + dz*dz with
// "d3 = sqrtf(s) in range at r_i" iff s < t_i, found by the wrapper
// (ops/query.py::growth_thresholds). The radii grow, so t_0 <= ... <= t_G,
// and g(w) = #{i : t_i <= s(w)} does not decrease as s grows. Hence
//
//   g*    = g(s_min), s_min the least s of the row's live columns;
//   in(w) iff s(w) < t_{g*}    (fewer than g*+1 thresholds are <= s(w))
//
// Blocks and warps as K2's: a tile takes `split` blocks of 8 warps
// (ops/query.py::query_split), each stages the tile's live window and its
// warps walk rows of its share. Pass 1 walks the live columns in
// 128-column steps (4 columns a lane) and keeps the row's least s with a
// warp reduction (__reduce_min_sync on the bit patterns, which order
// non-negative floats as their values); it stops once s_min < t_0
// (g* = 0). Pass 2 is K2's walk (common.cuh walk_row) with the threshold
// t_{g*}: it recomputes s with the same instructions, ranks, stores
// 4-byte words (a distance map through K2's list of the step's selected
// columns), stops after the step that reaches K and zero-fills the rest
// of the row. A row that is not alive is zero-filled at once. The TPU
// kernel kept g in an int8 scratch between its passes and ranked with a
// triangular-ones matmul on the MXU; here a row's step costs one min a
// candidate, not G+1 range tests, since g only grows with s.
//
// Distance map (optional, dist != nullptr): f32 (B, nT, 128, W), written
// in pass 2 beside the ranks: sqrtf(d3) where the column is selected at
// the row's grown radius (in(w) and rank <= K), 0 everywhere else. As in
// K2 it is a template branch. The kernel also writes each row's step and
// its count, min(#in, K) (0 for a row that is not alive).
//
// Columns at or past u_end chunks of 128 are zero (the slab-end bound at
// the largest radius proves they hold no candidate at any step).
//
// What bounds it on the H100: instruction throughput. Each live candidate
// costs the squared distance (8 operations) and a min in pass 1, and again
// the distance and a compare in pass 2 until the row has K neighbors;
// device memory traffic is the int8 map write, B*M*W bytes (five times
// that with the f32 distance map).
//
// Numerics: s without FMA contraction (sum_sq3), as the plain version
// forms it, and an IEEE-rounded sqrtf for the map, so every range test,
// and the distance map, equals the plain version's bit for bit.
#include <cmath>

#include "common.cuh"

namespace {

using sph3d::kFullMask;
using sph3d::kMaxDevices;
using sph3d::kQueryStep;
using sph3d::kQueryWarps;
using sph3d::kTile;

constexpr int kMaxRadii = 16;  // growth_steps <= 15

// t[i]: in range at radius r_i iff s < t[i]; +inf past the G+1 radii.
struct Thresholds {
  float t[kMaxRadii];
};

template <bool kDist>
__global__ void __launch_bounds__(kQueryWarps * 32)
    growth_query_kernel(const float* __restrict__ db,
                        const float* __restrict__ q,
                        const int64_t* __restrict__ s_blk,
                        const int64_t* __restrict__ u_end,
                        int8_t* __restrict__ out, int8_t* __restrict__ steps,
                        int* __restrict__ count, float* __restrict__ dist,
                        int n_pad, int n_t, int window, int k, int n_radii,
                        int split, Thresholds th) {
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
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const auto rank = [](int r, float, float, float, float) { return r; };
  for (int t = t0 + warp; t < t0 + rows; t += kQueryWarps) {
    const size_t row = static_cast<size_t>(g) * kTile + t;
    const float qx = q[3 * row], qy = q[3 * row + 1], qz = q[3 * row + 2];

    // pass 1: the row's least squared distance (live is a multiple of 128,
    // so every lane's columns are live)
    unsigned s_min = 0x7f800000u;  // +inf
    for (int c0 = 0; c0 < live && __uint_as_float(s_min) >= th.t[0];
         c0 += kQueryStep) {  // warp-uniform
      const sph3d::Cols4 c =
          sph3d::cols4(win, live, c0 + 4 * lane, qx, qy, qz);
      const float m = fminf(fminf(c.s[0], c.s[1]), fminf(c.s[2], c.s[3]));
      s_min = min(s_min, __reduce_min_sync(kFullMask, __float_as_uint(m)));
    }
    // g* and its threshold (t sorted: the loop's test holds for a prefix)
    int gstar = 0;
    float t_in = th.t[0];
#pragma unroll
    for (int i = 0; i < kMaxRadii; ++i) {
      if (th.t[i] <= __uint_as_float(s_min)) {
        gstar = i + 1;
        t_in = i + 1 < kMaxRadii ? th.t[i + 1] : 0.f;
      }
    }
    const bool alive = gstar < n_radii;

    // pass 2: ranks of the columns in range at radius r_{g*}
    int8_t* orow = out + row * window;
    float* drow = kDist ? dist + row * window : nullptr;
    int n = 0;
    if (alive) {  // the distance map through the list, as K2's
      n = sph3d::walk_row<kDist, kDist>(win, live, window, qx, qy, qz, t_in,
                                        k, orow, drow, &lists[warp], rank);
    } else {
      sph3d::zero_row<kDist>(orow, drow, 0, window, lane);
    }
    if (lane == 0) {
      steps[row] = static_cast<int8_t>(alive ? gstar : 0);
      count[row] = min(n, k);
    }
  }
}

template <bool kDist>
cudaError_t launch(const float* db, const float* q, const int64_t* s_blk,
                   const int64_t* u_end, int8_t* out, int8_t* steps,
                   int* count, float* dist, int grid, int n_pad, int n_t,
                   int window, int k, int n_radii, int split,
                   const Thresholds& th, cudaStream_t stream) {
  static bool allowed[kMaxDevices] = {};
  cudaError_t err =
      sph3d::allow_all_smem(growth_query_kernel<kDist>, allowed);
  if (err != cudaSuccess) return err;
  const int smem = static_cast<int>(sizeof(float) * 3 * window);
  growth_query_kernel<kDist><<<grid, kQueryWarps * 32, smem, stream>>>(
      db, q, s_blk, u_end, out, steps, count, dist, n_pad, n_t, window, k,
      n_radii, split, th);
  return cudaGetLastError();
}

}  // namespace

// s_blk, u_end: (B, nT) int64; steps: (B, nT*128) int8; count: (B, nT*128)
// int32; dist: the f32 distance map, or nullptr. thresholds: a HOST array
// of the n_radii = G + 1 squared-distance thresholds of
// ops/query.py::growth_thresholds (ascending), copied into the kernel's
// parameters. split: blocks a query tile (ops/query.py::query_split).
extern "C" int sph3d_growth_query_launch(
    const float* db, const float* q, const int64_t* s_blk,
    const int64_t* u_end, int8_t* out, int8_t* steps, int* count,
    float* dist, const float* thresholds, int batch, int n_pad, int n_t,
    int window, int k, int n_radii, int split, void* stream) {
  if (n_radii < 1 || n_radii > kMaxRadii) return cudaErrorInvalidValue;
  if (split < 1 || split > kTile / kQueryWarps || kTile % split) {
    return cudaErrorInvalidValue;
  }
  Thresholds th;
  for (int i = 0; i < kMaxRadii; ++i) {
    th.t[i] = i < n_radii ? thresholds[i] : INFINITY;
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const int grid = batch * n_t * split;
  if (dist == nullptr) {
    return launch<false>(db, q, s_blk, u_end, out, steps, count, nullptr,
                         grid, n_pad, n_t, window, k, n_radii, split, th,
                         st);
  }
  return launch<true>(db, q, s_blk, u_end, out, steps, count, dist, grid,
                      n_pad, n_t, window, k, n_radii, split, th, st);
}

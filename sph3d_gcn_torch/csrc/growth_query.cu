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
// Distance map (optional, dist != nullptr): f32 (B, nT, 128, W), written
// in pass 2 beside the ranks: sqrtf(d3) where the column is selected at
// the row's grown radius (in(w) and rank <= K), 0 everywhere else. As in
// K2 it is a template branch, one coalesced store per lane and column.
//
// Columns at or past u_end chunks of 128 are zero (the slab-end bound at
// the largest radius proves they hold no candidate at any step).
//
// Design: K2's layout. One block per (cloud, 128-query tile) stages the
// live part of its window in shared memory as x/y/z planes; each warp owns
// query rows. Pass 1 walks the live columns in 32-column steps, lane i
// testing column c0+i, and carries the row minimum of g with a warp
// reduction (__reduce_min_sync); it stops once g* is 0. Pass 2 recomputes
// the distances with the same instructions (so the bits match pass 1),
// and ranks the columns with g <= g* by a ballot + popc prefix count, as
// K2 ranks its in-range columns; it writes every map byte of the row. The
// TPU kernel kept g in an int8 scratch between its passes and ranked with
// a triangular-ones matmul on the MXU; here recomputing costs less than a
// shared-memory scratch of 128*W bytes per block, and no matrix unit is
// needed for a prefix count.
//
// What bounds it on the H100: instruction throughput. Each live candidate
// costs the distance (9 operations), G+1 range tests (3 each) in pass 1,
// and again in pass 2 until the row has K neighbors; device memory traffic
// is the int8 map write, B*M*W bytes (five times that with the f32
// distance map).
//
// Numerics: sqrt((dx*dx + dy*dy) + dz*dz) without FMA contraction
// (sum_sq3) and an IEEE-rounded sqrtf, so every range test, and the
// distance map, equals the plain version's bit for bit.
#include "common.cuh"

namespace {

using sph3d::kFullMask;
using sph3d::kTile;

constexpr int kWarps = 8;
constexpr int kMaxRadii = 16;  // growth_steps <= 15

struct Radii {
  float r[kMaxRadii];
};

// g(w): the number of radii at which a candidate at distance d3 is NOT in
// range (the reference's strict < with the 1e-6 margin).
__device__ __forceinline__ int growth_of(float d3, const Radii& rd,
                                         int n_radii) {
  int g = 0;
#pragma unroll
  for (int i = 0; i < kMaxRadii; ++i) {
    if (i < n_radii) {
      const float r = rd.r[i];
      g += (d3 < r && fabsf(d3 - r) > 1e-6f) ? 0 : 1;
    }
  }
  return g;
}

template <bool kDist>
__global__ void __launch_bounds__(kWarps * 32)
    growth_query_kernel(const float* __restrict__ db,
                        const float* __restrict__ q,
                        const int* __restrict__ s_blk,
                        const int* __restrict__ u_end,
                        int8_t* __restrict__ out, int8_t* __restrict__ steps,
                        float* __restrict__ dist, int n_pad, int n_t,
                        int window, int k, int n_radii, Radii rd) {
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
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const unsigned le_mask = kFullMask >> (31 - lane);  // lanes <= this one
  const int never = n_radii;                          // G + 1
  for (int t = threadIdx.x >> 5; t < kTile; t += kWarps) {
    const size_t row = static_cast<size_t>(g) * kTile + t;
    const float qx = q[3 * row], qy = q[3 * row + 1], qz = q[3 * row + 2];

    // pass 1: the row's growth step (live is a multiple of 128, so every
    // lane's column is live)
    int gstar = never;
    for (int c0 = 0; c0 < live && gstar > 0; c0 += 32) {  // warp-uniform
      const int w = c0 + lane;
      const float dx = wx[w] - qx, dy = wy[w] - qy, dz = wz[w] - qz;
      const float d3 = sqrtf(sph3d::sum_sq3(dx, dy, dz));
      gstar = min(gstar,
                  __reduce_min_sync(kFullMask, growth_of(d3, rd, n_radii)));
    }
    const bool alive = gstar < never;

    // pass 2: ranks of the columns in range at radius r_{g*}
    int8_t* orow = out + row * window;
    float* drow = kDist ? dist + row * window : nullptr;
    int off = 0;  // selected columns before this step
    for (int c0 = 0; c0 < window; c0 += 32) {
      const int w = c0 + lane;
      int val = 0;
      float dval = 0.f;
      if (alive && c0 < live && off < k) {  // warp-uniform
        const float dx = wx[w] - qx, dy = wy[w] - qy, dz = wz[w] - qz;
        const float d3 = sqrtf(sph3d::sum_sq3(dx, dy, dz));
        const bool in_g = growth_of(d3, rd, n_radii) <= gstar;
        const unsigned bal = __ballot_sync(kFullMask, in_g);
        const int rank = off + __popc(bal & le_mask);
        if (in_g && rank <= k) {
          val = rank;
          if (kDist) dval = sqrtf(d3);
        }
        off += __popc(bal);
      }
      orow[w] = static_cast<int8_t>(val);
      if (kDist) drow[w] = dval;
    }
    if (lane == 0) steps[row] = static_cast<int8_t>(alive ? gstar : 0);
  }
}

template <bool kDist>
cudaError_t launch(const float* db, const float* q, const int* s_blk,
                   const int* u_end, int8_t* out, int8_t* steps, float* dist,
                   int grid, int n_pad, int n_t, int window, int k,
                   int n_radii, const Radii& rd, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float) * 3 * window);
  cudaError_t err = cudaFuncSetAttribute(
      growth_query_kernel<kDist>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  growth_query_kernel<kDist><<<grid, kWarps * 32, smem, stream>>>(
      db, q, s_blk, u_end, out, steps, dist, n_pad, n_t, window, k, n_radii,
      rd);
  return cudaGetLastError();
}

}  // namespace

// radii: a HOST array of the n_radii = G + 1 radii, copied into the
// kernel's parameters. dist: the f32 distance map, or nullptr.
extern "C" int sph3d_growth_query_launch(
    const float* db, const float* q, const int* s_blk, const int* u_end,
    int8_t* out, int8_t* steps, float* dist, const float* radii, int batch,
    int n_pad, int n_t, int window, int k, int n_radii, void* stream) {
  if (n_radii < 1 || n_radii > kMaxRadii) return cudaErrorInvalidValue;
  Radii rd{};
  for (int i = 0; i < n_radii; ++i) rd.r[i] = radii[i];
  const auto st = static_cast<cudaStream_t>(stream);
  if (dist == nullptr) {
    return launch<false>(db, q, s_blk, u_end, out, steps, nullptr,
                         batch * n_t, n_pad, n_t, window, k, n_radii, rd, st);
  }
  return launch<true>(db, q, s_blk, u_end, out, steps, dist, batch * n_t,
                      n_pad, n_t, window, k, n_radii, rd, st);
}

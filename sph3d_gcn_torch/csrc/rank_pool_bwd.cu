// K6: backward of the max pool from dense neighbor maps (rank or bin
// valued).
//
// Replaces the TPU kernels sph3d_gcn_tpu/ops/dense.py:2035
// (_rank_pool_bwd_kernel, via _rank_window_max_for) and, behind
// dense_max_pool3d(with_index=True), sph3d_gcn_tpu/ops/dense.py:1826
// (_dense_pool_bwd_kernel). Both route each output gradient to its first
// maximal window column; the TPU kernels re-expand that column into a
// one-hot matrix for the matrix unit, here the column index is used as
// it is. Plain PyTorch twin: sph3d_gcn_torch/ops/dense.py::
// rank_pool_bwd_plain.
//
//   dx[n, c] = sum over query rows t with arg[t, c] >= 0 and
//              s_blk*128 + arg[t, c] = n of dout[t, c]
//
// where arg is K4's first attaining window column (-1 for an empty row,
// which gives nothing). Sums are f32, rounded once to the feature dtype.
//
// Design: pool windows of neighbouring query tiles overlap, so a feature
// row may receive from several tiles. Instead of a scatter with float
// atomics, every (128-row block of x, cloud, 32-channel slice) has one
// owner: a warp (lane = channel) with a (128, 32) f32 accumulator in
// shared memory. A thread block holds the owners of kGroup consecutive
// blocks of x and goes through the tiles whose window
// [s_blk, s_blk + W/128) meets them (warp 0 lists them, 32 tiles a
// ballot, in tile order), one tile a step:
//  - every warp stages kTile / kGroup rows of the tile's (128, 32) slice
//    of arg and dout in shared memory, and sorts its rows by owner as it
//    goes: the target block of column a is s_blk + a / 128, so each lane
//    sets, for each owner, one bit per staged row that lands there (from
//    three bit planes of the owner index). Then it loads its rows of the
//    next tile into registers, in flight while this tile is summed;
//  - each owner gathers its lane's bits and adds dout of exactly those
//    rows, in row order, to its accumulator, kBatch rows a step: their
//    accumulator rows are read together, a row that repeats an earlier
//    one of the step takes its new value, and a lane with fewer rows left
//    adds 0 to a spare row, so that the warp never diverges.
// Every sum is taken in (tile, row) order, fixed by the layout: bitwise
// reproducible, and equal to any other order where the sums are exact.
// The earlier K6 (one thread per channel walking every row of every
// covering tile, reading arg from device memory W/128 times over) spent a
// dependent load and a shared-memory add on every row and channel; here an
// owner spends time only on the rows that land in its block.
//
// What bounds it on the H100: device memory (through L2) sees arg and
// dout about (W/128 + kGroup - 1) / kGroup times, as every group that a
// tile's window meets stages the whole tile, and dx once. Where a tile's
// rows land in few blocks (many rows a lane for one owner), the owner's
// chain of shared-memory read-modify-writes, one step after another, takes
// the time, and the accumulators (129 KB) hold an SM to one block of
// kGroup warps, which leaves little work to hide that latency.
#include "common.cuh"

namespace {

using sph3d::kTile;

constexpr int kGroup = 8;                  // owners (warps) per block
constexpr int kThreads = kGroup * 32;
constexpr int kSlab = (kTile + 1) * 32;    // one accumulator, spare row
constexpr int kStaged = kTile * 32;        // a tile's (128, 32) slice
constexpr int kStage = kTile / kGroup;     // rows a warp stages per tile
constexpr int kBatch = 8;                  // rows an owner adds together
constexpr int kMaxDevices = 16;           // devices whose attribute is kept
static_assert(kGroup == 8, "owners are numbered by three bit planes");
static_assert(kStage == 16, "two warps' bits make a 32-row word");

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    rank_pool_bwd_kernel(const int64_t* __restrict__ s_blk,
                         const int* __restrict__ arg,
                         const T* __restrict__ dout, T* __restrict__ dx,
                         int n_t, int n, int c, int window) {
  extern __shared__ float4 smem[];
  float* slabs = reinterpret_cast<float*>(smem);     // (kGroup, 129, 32)
  int* arg_s = reinterpret_cast<int*>(slabs + kGroup * kSlab);
  unsigned* bits_s = reinterpret_cast<unsigned*>(arg_s + kStaged);
  T* dout_s = reinterpret_cast<T*>(bits_s + kGroup * kGroup * 32);
  int2* cover = reinterpret_cast<int2*>(dout_s + kStaged);  // n_t
  __shared__ int n_cover_s;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nb0 = blockIdx.x * kGroup;
  const int b = blockIdx.y;
  const int ch = blockIdx.z * 32 + lane;
  const bool live = ch < c;
  const int nbw = window / kTile;
  float* slab = slabs + warp * kSlab;
  for (int i = lane; i < kSlab / 4; i += 32) {
    reinterpret_cast<float4*>(slab)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (warp == 0) {
    // (tile, first block of its window) of every tile meeting the group
    int count = 0;
    for (int g0 = 0; g0 < n_t; g0 += 32) {
      const int g = g0 + lane;
      const int sb =
          g < n_t ? static_cast<int>(s_blk[static_cast<size_t>(b) * n_t + g])
                  : 0;
      const bool meets = g < n_t && sb < nb0 + kGroup && nb0 < sb + nbw;
      const unsigned bal = __ballot_sync(sph3d::kFullMask, meets);
      if (meets) {
        cover[count + __popc(bal & ((1u << lane) - 1u))] = make_int2(g, sb);
      }
      count += __popc(bal);
    }
    if (lane == 0) n_cover_s = count;
  }
  __syncthreads();
  const int n_cover = n_cover_s;
  const size_t cloud = static_cast<size_t>(b) * n_t;

  // this warp's rows warp * kStage + i of listed tile k, loaded one tile
  // ahead
  int pa[kStage];
  T pd[kStage];
  auto load = [&](int k) {
    const size_t base =
        ((cloud + cover[k].x) * kTile + warp * kStage) * c + ch;
#pragma unroll
    for (int i = 0; i < kStage; ++i) {
      const size_t e = base + static_cast<size_t>(i) * c;
      pa[i] = live ? arg[e] : -1;
      pd[i] = live ? dout[e] : sph3d::from_float<T>(0.f);
    }
  };
  if (n_cover > 0) load(0);
  for (int k = 0; k < n_cover; ++k) {
    __syncthreads();  // every owner is done with the previous tile
    // stage the rows, and the owner of each as three bit planes: bit i of
    // plane q is bit q of row i's owner (valid: it has one)
    const int first = cover[k].y - nb0;  // owner of window block 0
    unsigned valid = 0u, plane0 = 0u, plane1 = 0u, plane2 = 0u;
#pragma unroll
    for (int i = 0; i < kStage; ++i) {
      const int t = warp * kStage + i;
      arg_s[t * 32 + lane] = pa[i];
      dout_s[t * 32 + lane] = pd[i];
      const int owner = first + (pa[i] >> 7);
      const bool in = pa[i] >= 0 && static_cast<unsigned>(owner) < kGroup;
      valid |= static_cast<unsigned>(in) << i;
      plane0 |= static_cast<unsigned>(owner & 1) << i;
      plane1 |= static_cast<unsigned>((owner >> 1) & 1) << i;
      plane2 |= static_cast<unsigned>((owner >> 2) & 1) << i;
    }
#pragma unroll
    for (int o = 0; o < kGroup; ++o) {
      bits_s[(o * kGroup + warp) * 32 + lane] =
          valid & (o & 1 ? plane0 : ~plane0) & (o & 2 ? plane1 : ~plane1) &
          (o & 4 ? plane2 : ~plane2);
    }
    __syncthreads();
    if (k + 1 < n_cover) load(k + 1);
    // this owner's rows, 32 at a time in row order: word j holds rows
    // 32j .. 32j + 31, the bits of warps 2j and 2j + 1
    const unsigned* bits = bits_s + warp * kGroup * 32 + lane;
#pragma unroll
    for (int j = 0; j < kTile / 32; ++j) {
      unsigned m = bits[2 * j * 32] | (bits[(2 * j + 1) * 32] << kStage);
      // kBatch rows at a time, in row order: their accumulator rows are
      // read together, and a row that an earlier row of the batch also
      // updates takes that row's new value instead (the stores go in row
      // order, so the last one holds the whole sum). A lane with fewer
      // rows left adds 0 to the spare row kTile.
      while (__any_sync(sph3d::kFullMask, m != 0u)) {
        int at[kBatch];
        float dv[kBatch], v[kBatch];
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          const int t = __ffs(m) - 1;
          m &= m - 1u;
          const int e = (32 * j + (t < 0 ? 0 : t)) * 32 + lane;
          const int a = arg_s[e];
          const float d = sph3d::to_float(dout_s[e]);
          at[q] = (t < 0 ? kTile : (a & (kTile - 1))) * 32 + lane;
          dv[q] = t < 0 ? 0.f : d;
        }
#pragma unroll
        for (int q = 0; q < kBatch; ++q) v[q] = slab[at[q]];
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
#pragma unroll
          for (int p = 0; p < q; ++p) {
            if (at[p] == at[q]) v[q] = v[p];
          }
          v[q] += dv[q];
        }
#pragma unroll
        for (int q = 0; q < kBatch; ++q) slab[at[q]] = v[q];
      }
    }
  }

  const int nb = nb0 + warp;
  const int rows = min(kTile, n - nb * kTile);
  if (rows <= 0 || !live) return;
  T* dxb = dx + (static_cast<size_t>(b) * n + nb * kTile) * c + ch;
  for (int i = 0; i < rows; ++i) {
    dxb[static_cast<size_t>(i) * c] =
        sph3d::from_float<T>(slab[i * 32 + lane]);
  }
}

template <typename T>
cudaError_t launch(const int64_t* s_blk, const int* arg, const void* dout,
                   void* dx, int batch, int n_t, int n, int c, int window,
                   cudaStream_t stream) {
  const int n_blk = (n + kTile - 1) / kTile;
  // accumulators, staged arg, row bits, staged dout, the tile list
  const size_t smem = kGroup * kSlab * sizeof(float) +
                      kStaged * sizeof(int) +
                      kGroup * kGroup * 32 * sizeof(unsigned) +
                      kStaged * sizeof(T) + n_t * sizeof(int2);
  auto kernel = rank_pool_bwd_kernel<T>;
  // the shared memory the kernel was allowed on each device so far: the
  // attribute is set only when a launch needs more (a host call that
  // costs more than a small launch)
  static size_t allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || smem > allowed[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) allowed[dev] = smem;
  }
  const dim3 grid((n_blk + kGroup - 1) / kGroup, batch, (c + 31) / 32);
  kernel<<<grid, kThreads, smem, stream>>>(
      s_blk, arg, static_cast<const T*>(dout), static_cast<T*>(dx), n_t, n,
      c, window);
  return cudaGetLastError();
}

}  // namespace

// s_blk: (B, n_t) int64; arg, dout: (B, n_t * 128, C); dx: (B, N, C) in
// the feature dtype.
extern "C" int sph3d_rank_pool_bwd_launch(const int64_t* s_blk,
                                          const int* arg, const void* dout,
                                          void* dx, int batch, int n_t,
                                          int n, int c, int window,
                                          int is_bf16, void* stream) {
  if (c < 1 || n < 1 || n_t < 1 || window < kTile || window % kTile != 0) {
    return cudaErrorInvalidValue;
  }
  const auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch<__nv_bfloat16>(s_blk, arg, dout, dx, batch, n_t, n, c,
                                 window, st);
  }
  return launch<float>(s_blk, arg, dout, dx, batch, n_t, n, c, window, st);
}

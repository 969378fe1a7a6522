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
//   over the window columns w of query row t whose map entry pk is a bin
//   (1 <= pk <= F) and whose row lies in the cloud
//
// filt_b is the per-cloud filter (B, F, C, r) in f32, its bin rows already
// in the map's (possibly sort-grouped) order, read with a per-cloud
// stride (0: one filter for every cloud, the ungrouped maps');
// inv[t] = 1 / max(count, 1). Sums are f32, each row's in window order;
// the output is cast once to the feature dtype (f32 or bf16), after the
// scale, as the TPU's C <= 128 kernel does. No atomics: a second run is
// bitwise equal to the first.
//
// Design: an item of work is (query tile, or 1/2-1/8 of its rows; cloud;
// slice of 32 * S channels), S and the split chosen on the host
// (ops/dense.py::conv_fwd_layout). A block of 8 warps stages the item's
// (F, 32 S, r) filter slice in shared memory (cp.async, while the map's
// first stages are in flight). Each warp owns
// 16 / split consecutive query rows, so its map is one contiguous run of
// bytes: it streams the run through its own 4-stage cp.async ring, 1024
// bytes a stage, and decodes each 16-byte word into a hit list (row, bin,
// column) in shared memory, in window order, drained before a group of
// words that could overflow it. A lane holds a channel and its r sums in
// 32-channel slots; the warp takes a row's listed hits 2-8 at a time
// (padded against a zero filter row), their feature rows loaded while the
// batch before is summed, the filter terms read from shared memory, and
// writes a row (or the zero rows it skipped) when the next row's hits
// begin. The map is read once per channel slice, and only its selected
// entries cost arithmetic. A block takes one item, or (the host's
// choice: a large filter slice against few tiles, the scene models'
// deep levels) as many blocks as fit the card at once take the items in
// order and stage a slice once for each run of items of one cloud.
//
// What bounds it on the H100: on sparse maps (the S3DIS scenes, about 6
// hits a row) the map read, B*M*W bytes, which the bound counts once; on
// dense maps (ModelNet, about 47 a row) the work of each hit, a gathered
// feature row (mostly from L1/L2: a tile's window is shared by its 128
// rows) and some fifteen instructions of the warp that takes it; on the
// small calls of the deep levels, the fixed cost of an item (its filter
// slice, the ring's first stages).
#include "common.cuh"

namespace {

using sph3d::allow_smem;
using sph3d::cp_async16;
using sph3d::cp_async4;
using sph3d::cp_async_commit;
using sph3d::cp_async_wait;
using sph3d::hit_bits16;
using sph3d::kFullMask;
using sph3d::kMaxDevices;
using sph3d::kTile;
using sph3d::load_terms;
using sph3d::pack_hit;
using sph3d::warp_scan;
using sph3d::word_byte;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxC = 1024;
constexpr int kWordsPerLane = 2;     // 16-byte map words a lane reads a step
constexpr int kStepWords = 32 * kWordsPerLane;  // a warp's words a step
constexpr int kStages = 4;           // a warp's ring of map steps
constexpr int kGroup = 32 * 16;      // hits 32 words can list
// a warp's hit list, in entries: drained once it holds more than 128
constexpr int kListCap = kGroup + 128;

// The r terms of one channel of an output row, rounded once each.
template <int R>
__device__ __forceinline__ void store_terms(float* p, const float (&v)[R]) {
  if constexpr (R == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

template <int R>
__device__ __forceinline__ void store_terms(__nv_bfloat16* p,
                                            const float (&v)[R]) {
  if constexpr (R == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  } else {
    *p = __float2bfloat16(v[0]);
  }
}

// Output rows of (query tile part, cloud, 32 * S channel slice) items:
// lane = channel c0 + 32 s + lane (s < S), its R sums in registers. Block
// i takes items [i * items / grid, (i + 1) * items / grid) in order, in
// which consecutive items share their cloud and slice, and stages the
// filter slice again only when they change.
template <typename T, int R, int S>
__global__ void __launch_bounds__(kThreads, 2)
    dense_conv_kernel(const int8_t* __restrict__ packed,
                      const int64_t* __restrict__ s_blk,
                      const T* __restrict__ x, const float* __restrict__ filt,
                      long long filt_stride, const float* __restrict__ inv,
                      T* __restrict__ out, int batch, int n_t, int n, int c,
                      int f_bins, int window, int slices, int split) {
  constexpr int kw = 32 * S;                           // channels a slice
  constexpr int kBatch = S <= 2 ? 8 : S <= 4 ? 4 : 2;  // hits in flight
  extern __shared__ float4 smem4[];
  uint4* rings = reinterpret_cast<uint4*>(smem4);      // (warps, stages, ..)
  int* lists = reinterpret_cast<int*>(rings + kWarps * kStages * kStepWords);
  // (F + 1, kw, R): the block's filter slice, then a row of zeros
  float* filt_s = reinterpret_cast<float*>(lists + kWarps * kListCap);

  const int cr = c * R;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int rpw = kTile / kWarps / split;          // rows a warp, <= 16
  const int wpr = window / 16;                     // map words a row
  const int words = rpw * wpr;                     // a warp's, an item
  const int steps = (words + kStepWords - 1) / kStepWords;
  const unsigned fmax4 = 0x01010101u * static_cast<unsigned>(f_bins);
  const float* fl = filt_s + lane * R;
  const int zero_row = f_bins * kw * R;
  int* list = lists + warp * kListCap;
  uint4* ring = rings + warp * kStages * kStepWords + lane;

  const long long items = static_cast<long long>(slices) * batch * n_t *
                          split;
  const int first = static_cast<int>(items * blockIdx.x / gridDim.x);
  const int last = static_cast<int>(items * (blockIdx.x + 1) / gridDim.x);
  int staged = -1;                  // slice * batch + cloud of filt_s
  for (int it = first; it < last; ++it) {
    const int part = it % split;
    const int tile = (it / split) % n_t;
    const int key = it / (split * n_t);            // slice * batch + b
    const int b = key % batch;
    const int c0 = (key / batch) * kw;
    const int g = b * n_t + tile;
    const float* fb = filt + b * filt_stride + c0 * R;
    const bool restage = key != staged;
    if (restage) {
      // the item's filter slice, (F, kw, R) of filt_b (B, F, C, R) (zeros
      // past C), and a row of zeros that padded hits read, once every warp
      // is done with the last; it lands while the map's first stages are
      // in flight
      const int kr = min(kw, c - c0) * R;          // live terms of a bin
      __syncthreads();
      for (int e = tid; e < (f_bins + 1) * kw * R; e += kThreads) {
        const int f = e / (kw * R);
        const int ke = e - f * kw * R;
        if (f < f_bins && ke < kr) {
          cp_async4(filt_s + e, fb + static_cast<size_t>(f) * cr + ke);
        } else {
          filt_s[e] = 0.f;
        }
      }
      cp_async_commit();
    }

    const int base_row = static_cast<int>(s_blk[g]) * kTile;
    const int reach = n - base_row;                // columns in the cloud
    // this warp's rows of the item: [row0, row0 + rpw) of the tile; its
    // map, one contiguous run: word u of step k (u = k * kStepWords + h *
    // 32 + lane) goes to ring slot [k % kStages][h][lane], copied and
    // read by the same lane
    const int row0 = part * (kTile / split) + warp * rpw;
    const uint4* pw = reinterpret_cast<const uint4*>(
        packed + (static_cast<size_t>(g) * kTile + row0) * window);
    auto issue = [&](int k) {
      if (k < steps) {
#pragma unroll
        for (int h = 0; h < kWordsPerLane; ++h) {
          const int u = k * kStepWords + h * 32 + lane;
          if (u < words) {
            cp_async16(ring + (k % kStages) * kStepWords + h * 32, pw + u);
          }
        }
      }
      cp_async_commit();  // an empty group past the end keeps the count
    };
#pragma unroll
    for (int k = 0; k < kStages - 1; ++k) issue(k);
    const float iv_lane =                          // row lane's scale
        lane < rpw ? inv[static_cast<size_t>(g) * kTile + row0 + lane] : 0.f;
    if (restage) {
      cp_async_wait<kStages - 1>();  // the filter slice has landed
      __syncthreads();
      staged = key;
    }

    bool live[S];
#pragma unroll
    for (int s = 0; s < S; ++s) live[s] = c0 + 32 * s + lane < c;
    const T* xb =
        x + (static_cast<size_t>(b) * n + base_row) * c + c0 + lane;
    T* ob = out + (static_cast<size_t>(g) * kTile + row0) * cr +
            (c0 + lane) * R;

    float acc[S][R];
#pragma unroll
    for (int s = 0; s < S; ++s) {
#pragma unroll
      for (int j = 0; j < R; ++j) acc[s][j] = 0.f;
    }
    int cur_row = -1;   // the row whose hits acc[] sums
    int next_row = 0;   // the first row not written yet
    // writes row cur_row (scaled, acc cleared), then zeros up to row upto
    auto finish = [&](int upto) {
      if (cur_row >= 0) {
        const float iv = __shfl_sync(kFullMask, iv_lane, cur_row);
        T* orow = ob + static_cast<size_t>(cur_row) * cr;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          float v[R];
#pragma unroll
          for (int j = 0; j < R; ++j) {
            v[j] = acc[s][j] * iv;
            acc[s][j] = 0.f;
          }
          if (live[s]) store_terms<R>(orow + 32 * s * R, v);
        }
        next_row = cur_row + 1;
      }
      for (; next_row < upto; ++next_row) {
        T* orow = ob + static_cast<size_t>(next_row) * cr;
        float zero[R] = {};
#pragma unroll
        for (int s = 0; s < S; ++s) {
          if (live[s]) store_terms<R>(orow + 32 * s * R, zero);
        }
      }
    };
    // A batch: the leading run of at most kBatch hits of one row from
    // list entry e on (the list is in row order), their feature terms
    // loaded; padded to kBatch with the run's last hit against the zero
    // filter row (x * 0 leaves a sum unchanged). take = 0: no entry left.
    auto prep = [&](int e, int fill, int& row, int& take,
                    int (&fo)[kBatch], float (&xv)[kBatch][S]) {
      take = 0;
      if (e >= fill) return;
      const int ent = list[min(e + lane, fill - 1)];
      const int r = ent & 0x7f;
      row = __shfl_sync(kFullMask, r, 0);
      const unsigned same = __ballot_sync(
          kFullMask, lane < kBatch && e + lane < fill && r == row);
      take = __ffs(~same) - 1;
      const int xo = (ent >> 14) * c;
      const int fo_lane =
          lane < take ? ((ent >> 7) & 0x7f) * kw * R : zero_row;
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const T* xr = xb + __shfl_sync(kFullMask, xo, min(q, take - 1));
        fo[q] = __shfl_sync(kFullMask, fo_lane, q);
#pragma unroll
        for (int s = 0; s < S; ++s) {
          xv[q][s] = live[s] ? sph3d::to_float(xr[32 * s]) : 0.f;
        }
      }
    };
    auto consume = [&](int row, const int (&fo)[kBatch],
                       const float (&xv)[kBatch][S]) {
      if (row != cur_row) {
        finish(row);
        cur_row = row;
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const float* fr = fl + fo[q];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          float ft[R];
          load_terms<R>(fr + 32 * s * R, ft);
#pragma unroll
          for (int j = 0; j < R; ++j) {
            acc[s][j] = fmaf(xv[q][s], ft[j], acc[s][j]);
          }
        }
      }
    };
    // adds the listed hits [0, fill) in list order, a batch's loads in
    // flight while the batch before it is summed
    auto drain = [&](int fill) {
      __syncwarp();
      int row_a, take_a, fo_a[kBatch], row_b, take_b, fo_b[kBatch];
      float xv_a[kBatch][S], xv_b[kBatch][S];
      int e = 0;
      prep(e, fill, row_a, take_a, fo_a, xv_a);
      e += take_a;
      while (take_a > 0) {
        prep(e, fill, row_b, take_b, fo_b, xv_b);
        e += take_b;
        consume(row_a, fo_a, xv_a);
        if (take_b == 0) break;
        prep(e, fill, row_a, take_a, fo_a, xv_a);
        e += take_a;
        consume(row_b, fo_b, xv_b);
      }
      __syncwarp();
    };

    // decode: word u holds columns 16 (u % wpr) + i of row u / wpr,
    // tracked per lane as (wrow, wcol) and advanced 32 words a group. The
    // list is drained before a group that could overflow it.
    int wrow = lane / wpr;
    int wcol = lane - wrow * wpr;
    int fill = 0;
    for (int k = 0; k < steps; ++k) {
      cp_async_wait<kStages - 2>();  // step k has landed
      issue(k + kStages - 1);        // into the slot step k - 1 left
#pragma unroll
      for (int h = 0; h < kWordsPerLane; ++h) {
        if (fill > kListCap - kGroup) {
          drain(fill);
          fill = 0;
        }
        const int u = k * kStepWords + h * 32 + lane;
        const uint4 v = ring[(k % kStages) * kStepWords + h * 32];
        const int col = wcol * 16;
        // bytes past the cloud's end are never hits
        const int in = min(max(reach - col, 0), 16);
        const unsigned bits =
            u < words ? hit_bits16(v, fmax4) & ((1u << in) - 1u) : 0u;
        int total;
        int p = fill + warp_scan(__popc(bits), lane, &total);
        for (unsigned m = bits; m; m &= m - 1u) {
          const int i = __ffs(m) - 1;
          list[p++] = pack_hit(wrow, word_byte(v, i) - 1, col + i);
        }
        fill += total;
        for (wcol += 32; wcol >= wpr; wcol -= wpr) ++wrow;
      }
    }
    drain(fill);
    finish(rpw);
  }
}

struct Args {
  const int8_t* packed;
  const int64_t* s_blk;
  const void* x;
  const float* filt;
  long long filt_stride;
  const float* inv;
  void* out;
  int batch, n_t, n, c, f_bins, window, slices, split, persistent;
  cudaStream_t stream;
};

// How many blocks of a kernel instance, with `smem` bytes of shared
// memory, the device runs at once: a persistent launch's grid. sizes and
// counts: the instance's last size asked and its count, on each device.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, size_t smem, int* blocks,
                            size_t (&sizes)[kMaxDevices],
                            int (&counts)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && sizes[dev] == smem) {
    *blocks = counts[dev];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  }
  if (err != cudaSuccess) return err;
  *blocks = sms * per_sm;
  if (dev < kMaxDevices) {
    sizes[dev] = smem;
    counts[dev] = *blocks;
  }
  return *blocks > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

template <typename T, int R, int S>
cudaError_t launch(const Args& a) {
  const size_t smem =
      static_cast<size_t>(kWarps) * kStages * kStepWords * 16 +
      (static_cast<size_t>(a.f_bins + 1) * 32 * S * R + kWarps * kListCap) *
          4;
  auto kernel = dense_conv_kernel<T, R, S>;
  static size_t allowed[kMaxDevices] = {};
  static size_t sizes[kMaxDevices] = {};
  static int counts[kMaxDevices] = {};
  cudaError_t err = allow_smem(kernel, smem, allowed);
  const long long items =
      static_cast<long long>(a.slices) * a.batch * a.n_t * a.split;
  long long grid = items;
  if (a.persistent) {
    int resident = 0;
    if (err == cudaSuccess) {
      err = resident_blocks(kernel, smem, &resident, sizes, counts);
    }
    if (resident < grid) grid = resident;
  }
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<int>(grid), kThreads, smem,
           a.stream>>>(a.packed, a.s_blk, static_cast<const T*>(a.x),
                       a.filt, a.filt_stride, a.inv, static_cast<T*>(a.out),
                       a.batch, a.n_t, a.n, a.c, a.f_bins, a.window,
                       a.slices, a.split);
  return cudaGetLastError();
}

// the slot counts built (ops/dense.py::FWD_SLOTS)
#define SPH3D_CONV_SLOTS(X) X(1) X(2) X(3) X(4) X(5) X(8)

template <typename T, int R>
cudaError_t launch_slots(int slots, const Args& a) {
  switch (slots) {
#define SPH3D_CONV_CASE(s) \
  case s:                  \
    return launch<T, R, s>(a);
    SPH3D_CONV_SLOTS(SPH3D_CONV_CASE)
#undef SPH3D_CONV_CASE
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_type(int mult, int slots, const Args& a) {
  return mult == 1 ? launch_slots<T, 1>(slots, a)
                   : launch_slots<T, 2>(slots, a);
}

}  // namespace

// packed: (B, n_t, 128, W) int8, 16-byte aligned; s_blk: (B, n_t) int64;
// x: (B, N, C); filt: the per-cloud filter (F, C, r) f32 at cloud b's
// offset b * filt_stride (0: shared by every cloud); inv: (B, n_t*128)
// f32; out: (B, n_t*128, C*r) in the feature dtype. The layout (slots
// 32-channel slots in each of slices blocks across C; a block takes
// 128 / split rows of a tile, split in 1, 2, 4, 8) is the wrapper's
// (ops/dense.py::conv_fwd_layout).
extern "C" int sph3d_dense_conv_launch(
    const int8_t* packed, const int64_t* s_blk, const void* x,
    const float* filt, long long filt_stride, const float* inv, void* out,
    int batch, int n_t, int n, int c, int f_bins, int window, int mult,
    int is_bf16, int slots, int slices, int split, int persistent,
    void* stream) {
  if (c < 1 || c > kMaxC || (mult != 1 && mult != 2) || batch < 1 ||
      n < 1 || n_t < 1 ||
      f_bins < 1 || f_bins > 127 || window < 16 || window % 16 != 0 ||
      window >= (1 << 17) || slices < 1 || slices * 32 * slots < c ||
      (slices - 1) * 32 * slots >= c ||
      (split != 1 && split != 2 && split != 4 && split != 8) ||
      reinterpret_cast<uintptr_t>(packed) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  const Args a{packed,  s_blk, x,      filt,
               filt_stride, inv,  out,    batch,
               n_t,     n,     c,      f_bins,
               window,  slices, split, persistent,
               static_cast<cudaStream_t>(stream)};
  return is_bf16 ? launch_type<__nv_bfloat16>(mult, slots, a)
                 : launch_type<float>(mult, slots, a);
}

// K5: backward of the depthwise spherical conv from packed bin maps.
//
// Replaces the TPU kernels sph3d_gcn_tpu/ops/dense.py:692
// (_dense_conv_bwd_kernel, the backward of the C_in <= 128 conv) and
// sph3d_gcn_tpu/ops/dense.py:1183 (_dense_conv_rm_bwd_kernel, C_in > 128),
// and their S-recomputing twins :768 and :1233 (the same function): one
// function in several TPU layouts, as K3 (dense_conv.cu) serves both
// forwards. The TPU kernels expand each tile's bins into a one-hot (F*128,
// W) matrix for the matrix unit; here only the selected entries cost
// work. Plain PyTorch twin: sph3d_gcn_torch/ops/dense.py::
// dense_conv_bwd_plain.
//
// With g[t, c, j] = inv[t] * dout[t, c*r + j] and the map entry pk of
// query row t at window column w (a hit where 1 <= pk <= F; bin pk - 1):
//
//   dx[n, c]          = sum over hits (t, w) with s_blk*128 + w = n
//                       of sum_j g[t, c, j] * filt_b[pk - 1, c, j]
//   dfilt_b[b, f, c, j] = sum over cloud b's hits of bin f
//                       of g[t, c, j] * x[s_blk*128 + w, c]
//
// Sums are f32; dx is rounded once to the feature dtype, dfilt stays f32.
// No float atomics: every sum runs in an order fixed by the data layout,
// so the result is bitwise reproducible. A lane holds a channel and both
// its r terms, in 32-channel slots. Three launches a call:
//
// 1. dfilt_tile_kernel, a block per (query tile, or 1/2-1/8 of its rows
//    where the tiles are few; cloud; 32, 64 or 128 channels): the rows'
//    windows are decoded 512 map bytes a warp and step (16-byte loads, the
//    next step's in flight) into a hit list (row, bin, column) in shared
//    memory; warp w then takes the hits of the bins f with f % 8 == w, in
//    list order, 2-8 at a time with their x and dout rows loaded together,
//    and adds g * x for all the block's channels into the block's one
//    (F, channels, r) partial: no two warps touch one entry.
// 2. dfilt_reduce_kernel sums the partials over tiles (and row parts), in
//    order.
// 3. dx_kernel, one owner per (128-row block of x, cloud, slice of up to
//    128 channels): it walks the query tiles whose window covers its
//    block ([s_blk, s_blk + W/128)), in tile order, through a two-stage
//    cp.async ring, so that the next tile's map slice (128 x 128 bytes)
//    and inverse counts arrive while one is scanned; its filter slice
//    stays in shared memory. Each warp owns 16 of the block's rows as
//    registers acc[16][slot]: it reads its 16 columns of the slice with
//    16-byte loads, lists the hits in (column, query row) order, and takes
//    them 2-16 at a time with their dout rows loaded together.
//
// What bounds it on the H100 (PERF.md): on dense maps (ModelNet, 47 hits
// a row) the work of each hit, a gather of an x or a dout row and some
// thirty instructions for the warp that takes it, far below the card's
// f32 rate; on sparse maps (the S3DIS scenes, about 6 a row) the two
// scans of the map, each reading every map byte. The layout answers the
// first (a hit costs one warp for up to 128 channels), the ring and the
// step prefetch the second. Before this design K5 kept the dfilt partials
// in the dx owner's shared memory (one block an SM), copied its operands
// one element at a time with no load in flight and re-scanned the map
// per 64 channels: 1.5% of its bound on the S3DIS train step.
#include "common.cuh"

namespace {

using sph3d::allow_smem;
using sph3d::cp_async16;
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

// dfilt: 16-byte map words a lane decodes a step, and the hits a step can
// list (16 a word)
constexpr int kWordsPerLane = 2;
constexpr int kStepWords = 32 * kWordsPerLane;
constexpr int kStepCap = kWarps * kStepWords * 16;

// dx: rows of the owned block per warp, ring stages, map slice row stride
// (144: 16-byte reads of eight rows hit distinct banks), per-warp hit list
constexpr int kCols = kTile / kWarps;
constexpr int kStages = 2;
constexpr int kSliceStride = kTile + 16;
constexpr int kSliceBytes = kTile * kSliceStride;
constexpr int kDxList = 4 * kTile;
constexpr int kMaxDxSlots = 4;

// dfilt of one query tile (or of 128 / split of its rows), for a slice of
// 32 * M channels: lane = channel c0 + 32 m + lane (m < M), both terms j
// in the thread. The rows are decoded a step at a time into the list;
// warp w adds the hits of bins f with f % 8 == w, in list order, into the
// block's one (F, 32 M, R) slab, so no two warps touch one entry.
template <typename T, int R, int M>
__global__ void __launch_bounds__(kThreads)
    dfilt_tile_kernel(const int8_t* __restrict__ packed,
                      const int64_t* __restrict__ s_blk,
                      const T* __restrict__ x, const float* __restrict__ inv,
                      const T* __restrict__ dout, float* __restrict__ part,
                      int n_t, int n, int c, int f_bins, int window,
                      int split) {
  constexpr int kw = 32 * M;                      // channels a block
  constexpr int kBatch = M == 1 ? 8 : M == 2 ? 4 : 2;  // hits loaded at once
  extern __shared__ float4 smem4[];
  float* slab = reinterpret_cast<float*>(smem4);  // (F, kw, R)
  int* list = reinterpret_cast<int*>(slab + f_bins * kw * R);  // kStepCap
  float* inv_s = reinterpret_cast<float*>(list + kStepCap);  // (128,)
  __shared__ int count_s[kWarps];

  const int cr = c * R;
  const int c0 = blockIdx.x * kw;
  const int tile = blockIdx.y / split;
  const int b = blockIdx.z;
  const int g = b * n_t + tile;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int base_row = static_cast<int>(s_blk[g]) * kTile;
  const int reach = n - base_row;                 // columns in the cloud
  for (int e = tid; e < f_bins * kw * R; e += kThreads) slab[e] = 0.f;
  if (tid < kTile) inv_s[tid] = inv[static_cast<size_t>(g) * kTile + tid];

  // the block takes rows [row0, row0 + 128 / split) of the tile; this warp
  // decodes rows row0 + warp + 8 * rr: word u of that sequence is word
  // u % wpr of row rr = u / wpr
  const int row0 = (blockIdx.y - tile * split) * (kTile / split);
  const int wpr = window / 16;
  const int words = (kTile / kWarps / split) * wpr;
  const int steps = (words + kStepWords - 1) / kStepWords;
  const unsigned fmax4 = 0x01010101u * static_cast<unsigned>(f_bins);
  const int8_t* pg = packed + static_cast<size_t>(g) * kTile * window;
  auto load = [&](int u) {
    if (u >= words) return make_uint4(0u, 0u, 0u, 0u);
    const int rr = u / wpr;
    return __ldg(reinterpret_cast<const uint4*>(
        pg + static_cast<size_t>(row0 + warp + kWarps * rr) * window +
        (u - rr * wpr) * 16));
  };

  bool live[M];
#pragma unroll
  for (int m = 0; m < M; ++m) live[m] = c0 + 32 * m + lane < c;
  const T* xb = x + (static_cast<size_t>(b) * n + base_row) * c + c0 + lane;
  const T* db =
      dout + static_cast<size_t>(g) * kTile * cr + (c0 + lane) * R;
  float* sl = slab + lane * R;

  uint4 cur[kWordsPerLane];
#pragma unroll
  for (int h = 0; h < kWordsPerLane; ++h) cur[h] = load(h * 32 + lane);
  for (int step = 0; step < steps; ++step) {
    const int u0 = step * kStepWords;
    uint4 nxt[kWordsPerLane];
#pragma unroll
    for (int h = 0; h < kWordsPerLane; ++h) {
      nxt[h] = load(u0 + kStepWords + h * 32 + lane);
    }
    unsigned bits[kWordsPerLane];
    int row[kWordsPerLane], col[kWordsPerLane], pos[kWordsPerLane];
    int total = 0;
#pragma unroll
    for (int h = 0; h < kWordsPerLane; ++h) {
      const int u = u0 + h * 32 + lane;
      const int rr = u / wpr;
      row[h] = row0 + warp + kWarps * rr;
      col[h] = (u - rr * wpr) * 16;
      // bytes past the cloud's end are never hits
      const int in = min(max(reach - col[h], 0), 16);
      bits[h] = u < words ? hit_bits16(cur[h], fmax4) & ((1u << in) - 1u)
                          : 0u;
      int sum;
      pos[h] = total + warp_scan(__popc(bits[h]), lane, &sum);
      total += sum;
    }
    if (lane == 0) count_s[warp] = total;
    __syncthreads();  // the counts; the previous step's list is read
    int base = 0, n_hits = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int v = count_s[w];
      base += w < warp ? v : 0;
      n_hits += v;
    }
#pragma unroll
    for (int h = 0; h < kWordsPerLane; ++h) {
      int p = base + pos[h];
      for (unsigned m = bits[h]; m; m &= m - 1u) {
        const int i = __ffs(m) - 1;
        list[p++] = pack_hit(row[h], word_byte(cur[h], i) - 1, col[h] + i);
      }
    }
    __syncthreads();  // the list

    // this warp's hits, 32 entries of the list at a time, kBatch of them
    // with their x and dout rows loaded together
    for (int e0 = 0; e0 < n_hits; e0 += 32) {
      const int ent = e0 + lane < n_hits ? list[e0 + lane] : 0;
      unsigned mine = __ballot_sync(
          kFullMask, e0 + lane < n_hits && ((ent >> 7) & 7) == warp);
      while (mine) {
        int hit[kBatch];
        bool ok[kBatch];
        float xv[kBatch][M], dv[kBatch][M][R];
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          ok[q] = mine != 0u;
          hit[q] = __shfl_sync(kFullMask, ent, ok[q] ? __ffs(mine) - 1 : 0);
          mine &= mine - 1u;
          const int t = hit[q] & 0x7f;
          const int w = hit[q] >> 14;
#pragma unroll
          for (int m = 0; m < M; ++m) {
            if (ok[q] && live[m]) {
              xv[q][m] = sph3d::to_float(
                  xb[static_cast<size_t>(w) * c + 32 * m]);
              load_terms<R>(db + static_cast<size_t>(t) * cr + 32 * m * R,
                            dv[q][m]);
            } else {
              xv[q][m] = 0.f;
#pragma unroll
              for (int j = 0; j < R; ++j) dv[q][m][j] = 0.f;
            }
          }
        }
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          if (ok[q]) {
            const float iv = inv_s[hit[q] & 0x7f];
            float* sf = sl + ((hit[q] >> 7) & 0x7f) * kw * R;
#pragma unroll
            for (int m = 0; m < M; ++m) {
              if (!live[m]) continue;
              if constexpr (R == 2) {
                float2* s = reinterpret_cast<float2*>(sf + 64 * m);
                float2 v = *s;
                v.x = fmaf(iv * dv[q][m][0], xv[q][m], v.x);
                v.y = fmaf(iv * dv[q][m][1], xv[q][m], v.y);
                *s = v;
              } else {
                float* s = sf + 32 * m;
                *s = fmaf(iv * dv[q][m][0], xv[q][m], *s);
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int h = 0; h < kWordsPerLane; ++h) cur[h] = nxt[h];
  }
  __syncthreads();

  // the block's partial, (F, kw, R) of part[b, tile * split + part_row]
  float* pt = part + (static_cast<size_t>(b) * n_t * split + blockIdx.y) *
                         f_bins * cr + c0 * R;
  const int kr = min(kw, c - c0) * R;             // live terms of a bin
  for (int e = tid; e < f_bins * kw * R; e += kThreads) {
    const int f = e / (kw * R);
    const int ke = e - f * kw * R;
    if (ke < kr) pt[static_cast<size_t>(f) * cr + ke] = slab[e];
  }
}

// dfilt[b, e] = sum over partials p, in order, of part[b, p, e]
__global__ void __launch_bounds__(kThreads)
    dfilt_reduce_kernel(const float* __restrict__ part,
                        float* __restrict__ dfilt, int n_part, int fcr,
                        int total) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const int b = e / fcr;
  const float* p =
      part + static_cast<size_t>(b) * n_part * fcr + (e - b * fcr);
  float sum = p[0];
#pragma unroll 4
  for (int t = 1; t < n_part; ++t) sum += p[static_cast<size_t>(t) * fcr];
  dfilt[e] = sum;
}

// dx of one 128-row block of x, for a slice of 32 * S channels: lane =
// channel c0 + 32 s + lane, both terms j in the thread. Its accumulators
// acc[16][S] and kBatch hits' dout terms (12-16 a thread) stay in
// registers: three blocks an SM where S * R <= 2, two above.
template <typename T, int R, int S>
__global__ void __launch_bounds__(kThreads, S * R <= 2 ? 3 : 2)
    dx_kernel(const int8_t* __restrict__ packed,
              const int64_t* __restrict__ s_blk,
              const float* __restrict__ filt, const float* __restrict__ inv,
              const T* __restrict__ dout, T* __restrict__ dx, int n_t, int n,
              int c, int f_bins, int window) {
  constexpr int kBatch = S * R == 1 ? 16 : S * R == 2 ? 6 : S * R <= 4 ? 4 : 2;
  constexpr int kw = 32 * S;                 // channels a block
  extern __shared__ float4 smem4[];
  int8_t* slices = reinterpret_cast<int8_t*>(smem4);  // (stages, 128, 144)
  float* inv_s = reinterpret_cast<float*>(slices + kStages * kSliceBytes);
  float* filt_s = inv_s + kStages * kTile;   // (F, kw, R) the block's filter
  int* lists = reinterpret_cast<int*>(filt_s + f_bins * kw * R);
  int2* cover = reinterpret_cast<int2*>(lists + kWarps * kDxList);  // n_t
  __shared__ int n_cover_s;

  const int cr = c * R;
  const int c0 = blockIdx.x * kw;
  const int nb = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nbw = window / kTile;
  if (warp == 0) {
    // (tile, window column of this block's row 0) of every tile whose
    // window covers the block, in tile order
    int count = 0;
    for (int t0 = 0; t0 < n_t; t0 += 32) {
      const int tile = t0 + lane;
      const int sb =
          tile < n_t
              ? static_cast<int>(s_blk[static_cast<size_t>(b) * n_t + tile])
              : 0;
      const bool covers = tile < n_t && sb <= nb && nb < sb + nbw;
      const unsigned bal = __ballot_sync(kFullMask, covers);
      if (covers) {
        cover[count + __popc(bal & ((1u << lane) - 1u))] =
            make_int2(tile, (nb - sb) * kTile);
      }
      count += __popc(bal);
    }
    if (lane == 0) n_cover_s = count;
  }
  // the block's filter terms, (F, kw, R) from filt_b (B, F, C, R)
  const int kr = min(kw, c - c0) * R;
  const float* fb = filt + static_cast<size_t>(b) * f_bins * cr + c0 * R;
  for (int e = tid; e < f_bins * kw * R; e += kThreads) {
    const int f = e / (kw * R);
    const int ke = e - f * kw * R;
    filt_s[e] = ke < kr ? fb[static_cast<size_t>(f) * cr + ke] : 0.f;
  }
  __syncthreads();
  const int n_cover = n_cover_s;

  // copy listed tile k's map slice and inverse counts into stage k % 2
  auto issue = [&](int k) {
    if (k < n_cover) {
      const int2 cv = cover[k];
      const size_t g = static_cast<size_t>(b) * n_t + cv.x;
      const int8_t* src = packed + g * kTile * window + cv.y;
      int8_t* dst = slices + (k % kStages) * kSliceBytes;
      for (int i = tid; i < kTile * 8; i += kThreads) {
        const int t = i >> 3;
        const int q = i & 7;
        cp_async16(dst + t * kSliceStride + 16 * q,
                   src + static_cast<size_t>(t) * window + 16 * q);
      }
      if (tid < kTile / 4) {
        cp_async16(inv_s + (k % kStages) * kTile + 4 * tid,
                   inv + g * kTile + 4 * tid);
      }
    }
    cp_async_commit();  // an empty group past the list keeps the count
  };

  bool live[S];
#pragma unroll
  for (int s = 0; s < S; ++s) live[s] = c0 + 32 * s + lane < c;
  const float* fl = filt_s + lane * R;
  const unsigned fmax4 = 0x01010101u * static_cast<unsigned>(f_bins);
  int* list = lists + warp * kDxList;
  const unsigned lower = (1u << lane) - 1u;

  float acc[kCols][S];
#pragma unroll
  for (int q = 0; q < kCols; ++q) {
#pragma unroll
    for (int s = 0; s < S; ++s) acc[q][s] = 0.f;
  }
  float run[S] = {};
  int cur = -1;  // the column whose hits run[] is summing
  auto flush = [&]() {
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      if (q == cur) {
#pragma unroll
        for (int s = 0; s < S; ++s) acc[q][s] += run[s];
      }
    }
  };

  for (int k = 0; k < kStages - 1; ++k) issue(k);
  for (int k = 0; k < n_cover; ++k) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile k has landed; stage (k - 1) % 2 is free
    issue(k + kStages - 1);
    const int8_t* sl = slices + (k % kStages) * kSliceBytes + warp * kCols;
    const float* iv_s = inv_s + (k % kStages) * kTile;
    const T* dt = dout + (static_cast<size_t>(b) * n_t + cover[k].x) *
                             kTile * cr + (c0 + lane) * R;

    // adds the listed hits [0, fill) in list order, kBatch at a time
    auto drain = [&](int fill) {
      __syncwarp();
      for (int h0 = 0; h0 < fill; h0 += kBatch) {
        int ent[kBatch];
        float gv[kBatch][S][R];
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          const bool ok = h0 + q < fill;
          ent[q] = ok ? list[h0 + q] : 0;
          const int t = ent[q] & 0xff;
#pragma unroll
          for (int s = 0; s < S; ++s) {
            if (ok && live[s]) {
              load_terms<R>(dt + static_cast<size_t>(t) * cr + 32 * s * R,
                            gv[q][s]);
            } else {
#pragma unroll
              for (int j = 0; j < R; ++j) gv[q][s][j] = 0.f;
            }
          }
        }
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          if (h0 + q < fill) {
            const int i = ent[q] >> 16;
            if (i != cur) {
              flush();
              cur = i;
#pragma unroll
              for (int s = 0; s < S; ++s) run[s] = 0.f;
            }
            const float iv = iv_s[ent[q] & 0xff];
            const float* fr = fl + ((ent[q] >> 8) & 0xff) * kw * R;
#pragma unroll
            for (int s = 0; s < S; ++s) {
              if (!live[s]) continue;
              float ft[R];
              load_terms<R>(fr + 32 * s * R, ft);
#pragma unroll
              for (int j = 0; j < R; ++j) {
                run[s] = fmaf(iv * gv[q][s][j], ft[j], run[s]);
              }
            }
          }
        }
      }
      __syncwarp();
    };

    // this lane's query rows lane + 32q, the warp's 16 columns
    unsigned bits[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      bits[q] = hit_bits16(*reinterpret_cast<const uint4*>(
                               sl + (lane + 32 * q) * kSliceStride),
                           fmax4);
    }
    unsigned cols =
        __reduce_or_sync(kFullMask, bits[0] | bits[1] | bits[2] | bits[3]);
    int fill = 0;
    while (cols) {
      const int i = __ffs(cols) - 1;
      cols &= cols - 1u;
      if (fill + kTile > kDxList) {
        drain(fill);
        fill = 0;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool hit = (bits[q] >> i) & 1u;
        const unsigned bal = __ballot_sync(kFullMask, hit);
        if (hit) {
          const int t = lane + 32 * q;
          list[fill + __popc(bal & lower)] =
              t | ((sl[t * kSliceStride + i] - 1) << 8) | (i << 16);
        }
        fill += __popc(bal);
      }
    }
    drain(fill);
    flush();
    cur = -1;
  }

  // the block's rows, rounded once
  const int row0 = nb * kTile + warp * kCols;
  T* dxb = dx + static_cast<size_t>(b) * n * c + c0 + lane;
#pragma unroll
  for (int q = 0; q < kCols; ++q) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (row0 + q < n && live[s]) {
        dxb[static_cast<size_t>(row0 + q) * c + 32 * s] =
            sph3d::from_float<T>(acc[q][s]);
      }
    }
  }
}

template <typename T, int R, int M>
cudaError_t launch_dfilt(const int8_t* packed, const int64_t* s_blk,
                         const void* x, const float* inv, const void* dout,
                         float* part, float* dfilt, int batch, int n_t, int n,
                         int c, int f_bins, int window, int split,
                         cudaStream_t stream) {
  constexpr int kw = 32 * M;
  const size_t smem =
      (static_cast<size_t>(f_bins) * kw * R + kStepCap + kTile) * 4;
  auto kernel = dfilt_tile_kernel<T, R, M>;
  static size_t allowed[kMaxDevices] = {};
  cudaError_t err = allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((c + kw - 1) / kw, n_t * split, batch), kThreads, smem,
           stream>>>(packed, s_blk, static_cast<const T*>(x), inv,
                     static_cast<const T*>(dout), part, n_t, n, c, f_bins,
                     window, split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int total = batch * f_bins * c * R;
  dfilt_reduce_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0,
                        stream>>>(part, dfilt, n_t * split, f_bins * c * R,
                                  total);
  return cudaGetLastError();
}

template <typename T, int R, int S>
cudaError_t launch_dx(const int8_t* packed, const int64_t* s_blk,
                      const float* filt, const float* inv, const void* dout,
                      void* dx, int batch, int n_t, int n, int c, int f_bins,
                      int window, int chunks, cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(kStages) * kSliceBytes +
      (kStages * kTile + f_bins * 32 * S * R + kWarps * kDxList) * 4 +
      static_cast<size_t>(n_t) * sizeof(int2);
  auto kernel = dx_kernel<T, R, S>;
  static size_t allowed[kMaxDevices] = {};
  const cudaError_t err = allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(chunks, (n + kTile - 1) / kTile, batch), kThreads, smem,
           stream>>>(packed, s_blk, filt, inv, static_cast<const T*>(dout),
                     static_cast<T*>(dx), n_t, n, c, f_bins, window);
  return cudaGetLastError();
}

template <typename T, int R>
cudaError_t launch(const int8_t* packed, const int64_t* s_blk, const void* x,
                   const float* filt, const float* inv, const void* dout,
                   void* dx, float* dfilt, float* part, int batch, int n_t,
                   int n, int c, int f_bins, int window, int dx_slots,
                   int dx_chunks, int df_slots, int df_split,
                   cudaStream_t stream) {
  cudaError_t err;
  switch (df_slots) {
    case 1:
      err = launch_dfilt<T, R, 1>(packed, s_blk, x, inv, dout, part, dfilt,
                                  batch, n_t, n, c, f_bins, window, df_split,
                                  stream);
      break;
    case 2:
      err = launch_dfilt<T, R, 2>(packed, s_blk, x, inv, dout, part, dfilt,
                                  batch, n_t, n, c, f_bins, window, df_split,
                                  stream);
      break;
    default:
      err = launch_dfilt<T, R, 4>(packed, s_blk, x, inv, dout, part, dfilt,
                                  batch, n_t, n, c, f_bins, window, df_split,
                                  stream);
  }
  if (err != cudaSuccess) return err;
  switch (dx_slots) {
    case 1:
      return launch_dx<T, R, 1>(packed, s_blk, filt, inv, dout, dx, batch,
                                n_t, n, c, f_bins, window, dx_chunks, stream);
    case 2:
      return launch_dx<T, R, 2>(packed, s_blk, filt, inv, dout, dx, batch,
                                n_t, n, c, f_bins, window, dx_chunks, stream);
    case 3:
      return launch_dx<T, R, 3>(packed, s_blk, filt, inv, dout, dx, batch,
                                n_t, n, c, f_bins, window, dx_chunks, stream);
    default:
      return launch_dx<T, R, 4>(packed, s_blk, filt, inv, dout, dx, batch,
                                n_t, n, c, f_bins, window, dx_chunks, stream);
  }
}

}  // namespace

// s_blk: (B, n_t) int64; filt: (B, F, C, r) f32; inv: (B, n_t*128) f32;
// dout: (B, n_t*128, C*r); dx: (B, N, C) in the feature dtype; dfilt:
// (B, F, C, r) f32; part: (B, n_t * df_split, F, C*r) f32 scratch.
// packed and inv 16-byte aligned. The layout (dx_slots 32-channel slots
// in each of dx_chunks dx owners; df_slots in 1, 2, 4 for a dfilt block,
// which takes 128 / df_split rows of a tile, df_split in 1, 2, 4, 8) is
// the wrapper's (ops/dense.py::conv_bwd_layout). Launches three kernels.
extern "C" int sph3d_dense_conv_bwd_launch(
    const int8_t* packed, const int64_t* s_blk, const void* x,
    const float* filt, const float* inv, const void* dout, void* dx,
    float* dfilt, float* part, int batch, int n_t, int n, int c, int f_bins,
    int window, int mult, int is_bf16, int dx_slots, int dx_chunks,
    int df_slots, int df_split, void* stream) {
  const auto pow2_to = [](int v, int top) {
    return v == 1 || v == 2 || v == 4 || v == top;
  };
  if (c < 1 || c > kMaxC || (mult != 1 && mult != 2) || batch < 1 ||
      n < 1 || n_t < 1 || n_t * df_split > 65535 || batch > 65535 ||
      f_bins < 1 || f_bins > 127 || window < kTile || window % kTile != 0 ||
      window >= (1 << 17) || dx_slots < 1 || dx_slots > kMaxDxSlots ||
      dx_chunks * 32 * dx_slots < c || !pow2_to(df_slots, 4) ||
      !pow2_to(df_split, 8) ||
      reinterpret_cast<uintptr_t>(packed) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(inv) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  const auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return mult == 1
        ? launch<__nv_bfloat16, 1>(packed, s_blk, x, filt, inv, dout, dx,
                                   dfilt, part, batch, n_t, n, c, f_bins,
                                   window, dx_slots, dx_chunks, df_slots,
                                   df_split, st)
        : launch<__nv_bfloat16, 2>(packed, s_blk, x, filt, inv, dout, dx,
                                   dfilt, part, batch, n_t, n, c, f_bins,
                                   window, dx_slots, dx_chunks, df_slots,
                                   df_split, st);
  }
  return mult == 1
      ? launch<float, 1>(packed, s_blk, x, filt, inv, dout, dx, dfilt, part,
                         batch, n_t, n, c, f_bins, window, dx_slots,
                         dx_chunks, df_slots, df_split, st)
      : launch<float, 2>(packed, s_blk, x, filt, inv, dout, dx, dfilt, part,
                         batch, n_t, n, c, f_bins, window, dx_slots,
                         dx_chunks, df_slots, df_split, st);
}

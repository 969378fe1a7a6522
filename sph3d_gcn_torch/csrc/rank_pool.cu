// K4: max pooling from dense neighbor maps (forward).
//
// Replaces the TPU kernel sph3d_gcn_tpu/ops/dense.py:1953
// (_rank_pool_fwd_kernel, via _rank_window_max_for) and, behind
// dense_max_pool3d(with_index=True), sph3d_gcn_tpu/ops/dense.py:1792
// (_dense_pool_fwd_kernel: the masked max over every selected window
// column with its first attaining column, on rank and bin maps alike).
// Plain PyTorch twin: sph3d_gcn_torch/ops/dense.py::rank_pool_plain.
//
//   out[t, c]   = max x[s_blk*128 + w, c] over the window columns w of
//                 query row t whose rank pk lies in 1..count[t] (every
//                 nonzero entry of a bin map: no counts); 0 if none
//   arg[t, c]   = the FIRST such column w attaining the max, -1 if none
//                 (on request: the backward's input)
//   index[t, c] = min(s_blk*128 + w, N - 1) for that column, column 0
//                 for a row with none (on request: the op-level max_index)
//
// Design: one warp a query row, in two phases.
//  1. The walk: 512 window columns a step, one 16-byte map word a lane
//     (the words of kAhead steps loaded together); the selected bytes'
//     columns are compacted, in window order, into the warp's list in
//     shared memory (a warp scan of the lanes' counts gives each lane's
//     place). A step in which no lane selects writes nothing. The map is
//     read once, whatever C is.
//  2. The fold: every channel of the row comes from that list. A feature
//     row is read as vectors U (16 bytes, or 8/4/2 where C times the
//     element size or the features' base address allows no wider); the
//     lanes split into groups of `width` lanes, each group takes every
//     groups-th hit, in window order, and loads kBatch of its hits before
//     folding any. Rows of more than 32 vectors take several passes over
//     the list, 32 vectors a pass. A larger value replaces a lane's best
//     (strict: a tie keeps the earlier column; a group starts from its
//     first hit's column, so values that are all -inf keep it). bf16
//     features stay bf16 pairs: one compare of the pair gives a 16-bit
//     mask a half, which selects the pair's values and its two 16-bit
//     columns (three instructions a pair). The groups merge by shuffles:
//     the larger value wins, and on equal values the smaller column, so
//     the first attaining column is kept whatever order the groups saw
//     their hits in.
// The comparisons are IEEE, so -0 and +0 tie, and an output -0 is folded
// to +0 (as the TPU kernel does); the max of bf16 values is exact, so f32
// and bf16 outputs, arg and index equal the plain version's bit for bit.
// Inference launches the values-only instance (a max a pair or value, no
// column registers).
//
// What bounds it on the H100: the map read, B*M*W bytes, and the gathered
// feature reads, B*M*K*C elements, mostly from L2.
#include <math_constants.h>

#include "common.cuh"

namespace {

using sph3d::kFullMask;
using sph3d::kMaxDevices;
using sph3d::kTile;

constexpr int kWarps = 8;    // query rows a block, one a warp
constexpr int kStep = 512;   // window columns a walk step, 16 a lane
constexpr int kAhead = 2;    // walk steps whose map words load together
constexpr int kBatch = 8;    // hits a group loads before it folds them
constexpr int kMaxC = 512;
constexpr int kAll = 127;    // the rank bound that selects every nonzero
constexpr unsigned kNoHit = 0xffffu;  // the column of a group with no hit
constexpr unsigned kNegInf2 = 0xff80ff80u;  // a bf16 pair of -inf

// A vector's features as 32-bit words: one f32, or one bf16 pair, a word
// (a lone bf16, from a 2-byte vector, in the low half beside -inf).
__device__ __forceinline__ void to_words(uint4 u, unsigned (&w)[4]) {
  w[0] = u.x;
  w[1] = u.y;
  w[2] = u.z;
  w[3] = u.w;
}
__device__ __forceinline__ void to_words(uint2 u, unsigned (&w)[2]) {
  w[0] = u.x;
  w[1] = u.y;
}
__device__ __forceinline__ void to_words(unsigned u, unsigned (&w)[1]) {
  w[0] = u;
}
__device__ __forceinline__ void to_words(unsigned short u,
                                         unsigned (&w)[1]) {
  w[0] = 0xff800000u | u;
}

template <typename U, int NW>
__device__ __forceinline__ U from_words(const unsigned (&w)[NW]) {
  if constexpr (sizeof(U) == 16) {
    return make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (sizeof(U) == 8) {
    return make_uint2(w[0], w[1]);
  } else if constexpr (sizeof(U) == 4) {
    return w[0];
  } else {
    return static_cast<unsigned short>(w[0]);
  }
}

// Per-half bf16 pair operations (sm_90: one instruction each); a mask
// half is 0xffff where the comparison holds.
__device__ __forceinline__ unsigned bf16x2_gt(unsigned a, unsigned b) {
  unsigned d;
  asm("set.gt.u32.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ unsigned bf16x2_eq(unsigned a, unsigned b) {
  unsigned d;
  asm("set.eq.u32.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ unsigned bf16x2_max(unsigned a, unsigned b) {
  unsigned d;
  asm("max.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// Folds a hit's feature word v (at window column w; a bf16 pair's two
// columns as 16-bit halves, w2) into the group's (best, col): a larger
// value replaces the best, so a tie keeps the earlier column (a group
// takes its hits in window order). IEEE comparisons: -0 and +0 tie.
template <bool kBf16, bool kTrack>
__device__ __forceinline__ void fold(unsigned v, unsigned w, unsigned w2,
                                     unsigned& best, unsigned& col) {
  if constexpr (kBf16) {
    if constexpr (kTrack) {
      const unsigned m = bf16x2_gt(v, best);
      best = (v & m) | (best & ~m);
      col = (w2 & m) | (col & ~m);
    } else {
      best = bf16x2_max(v, best);
    }
  } else {
    const float fv = __uint_as_float(v);
    const float fb = __uint_as_float(best);
    if constexpr (kTrack) {
      if (fv > fb) {
        best = v;
        col = w;
      }
    } else {
      best = __float_as_uint(fmaxf(fv, fb));
    }
  }
}

// Merges another group's (ob, oc) into (best, col): the larger value, and
// on equal values the smaller column.
template <bool kBf16, bool kTrack>
__device__ __forceinline__ void merge(unsigned ob, unsigned oc,
                                      unsigned& best, unsigned& col) {
  if constexpr (kBf16) {
    if constexpr (kTrack) {
      const unsigned m = bf16x2_gt(ob, best) |
                         (bf16x2_eq(ob, best) & __vcmpltu2(oc, col));
      best = (ob & m) | (best & ~m);
      col = (oc & m) | (col & ~m);
    } else {
      best = bf16x2_max(ob, best);
    }
  } else {
    const float fo = __uint_as_float(ob);
    const float fb = __uint_as_float(best);
    if constexpr (kTrack) {
      if (fo > fb || (fo == fb && oc < col)) {
        best = ob;
        col = oc;
      }
    } else {
      best = __float_as_uint(fmaxf(fo, fb));
    }
  }
}

// The output word of a row with hits: -0 folded to +0.
template <bool kBf16>
__device__ __forceinline__ unsigned fold_zero(unsigned best) {
  if constexpr (kBf16) {
    const unsigned lo = (best & 0x7fffu) ? (best & 0xffffu) : 0u;
    const unsigned hi = (best & 0x7fff0000u) ? (best & 0xffff0000u) : 0u;
    return lo | hi;
  } else {
    // + 0 is not an identity without fast-math: it folds -0 to +0
    return __float_as_uint(__uint_as_float(best) + 0.0f);
  }
}

// E consecutive ints at p, aligned to 4*E bytes, in the widest stores.
template <int E>
__device__ __forceinline__ void store_ints(int* p, const int (&v)[E]) {
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int i = 0; i < E; i += 4) {
      *reinterpret_cast<int4*>(p + i) =
          make_int4(v[i], v[i + 1], v[i + 2], v[i + 3]);
    }
  } else if constexpr (E == 2) {
    *reinterpret_cast<int2*>(p) = make_int2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

template <typename T, typename U, bool kTrack>
__global__ void __launch_bounds__(kWarps * 32)
    rank_pool_kernel(const int8_t* __restrict__ packed,
                     const int64_t* __restrict__ s_blk,
                     const int* __restrict__ counts, int count_stride,
                     int count_rows, const T* __restrict__ x,
                     T* __restrict__ out, int* __restrict__ arg,
                     int* __restrict__ index, int rows_total, int n_t,
                     int n, int c, int window) {
  extern __shared__ uint16_t lists[];  // kWarps x window columns
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= rows_total) return;  // the whole warp leaves together
  const int g = row / kTile;
  const int b = g / n_t;
  const int t = row - b * n_t * kTile;
  const int64_t base = s_blk[g] * kTile;
  int cnt = kAll;
  if (counts != nullptr) {
    cnt = t < count_rows
        ? counts[static_cast<int64_t>(b) * count_stride + t]
        : 0;
  }
  cnt = min(max(cnt, 0), kAll);
  // window columns that land in the cloud (none to walk for a count of 0)
  const int64_t in_cloud = n - base;
  const int live = in_cloud <= 0 || cnt == 0 ? 0
      : static_cast<int>(in_cloud < window ? in_cloud : window);

  // 1. the walk: the selected columns into the list, in window order
  uint16_t* list = lists + warp * window;
  const int8_t* prow = packed + static_cast<size_t>(row) * window;
  const unsigned cnt4 = static_cast<unsigned>(cnt) * 0x01010101u;
  int len = 0;
  for (int c0 = 0; c0 < live; c0 += kAhead * kStep) {  // warp-uniform
    uint4 words[kAhead];  // the next kAhead steps' map words, in flight
#pragma unroll
    for (int s = 0; s < kAhead; ++s) {
      const int w = c0 + s * kStep + 16 * lane;
      words[s] = w < live ? *reinterpret_cast<const uint4*>(prow + w)
                          : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int s = 0; s < kAhead; ++s) {
      const int w = c0 + s * kStep + 16 * lane;
      unsigned bits = 0;  // bit j: column w + j is selected
      if (w < live) {
        bits = sph3d::hit_bits16(words[s], cnt4);
        if (live - w < 16) bits &= (1u << (live - w)) - 1u;
      }
      if (__ballot_sync(kFullMask, bits != 0) == 0) continue;
      int total;
      int at = len + sph3d::warp_scan(__popc(bits), lane, &total);
      len += total;
      while (bits) {
        list[at++] = static_cast<uint16_t>(w + __ffs(bits) - 1);
        bits &= bits - 1;
      }
    }
  }
  __syncwarp();

  // 2. the fold: groups of `width` lanes, one vector of the row a lane
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int E = sizeof(U) / sizeof(T);         // features a vector
  constexpr int NW = sizeof(U) < 4 ? 1 : sizeof(U) / 4;  // words a vector
  const int nvec = c / E;
  const int width = nvec >= 32 ? 32 : 1 << (32 - __clz(nvec - 1));
  const int groups = 32 / width;
  const int grp = lane >> (31 - __clz(width));
  const int gl = lane & (width - 1);
  // a group's first hit: its column until a larger value comes (so a
  // group whose values are all -inf keeps it)
  const unsigned first = grp < len ? list[grp] : kNoHit;
  const U* xw = reinterpret_cast<const U*>(
      x + (static_cast<int64_t>(b) * n + base) * c);
  for (int p = 0; p * 32 < nvec; ++p) {  // warp-uniform
    const int v = p * 32 + gl;
    const bool active = v < nvec;
    unsigned best[NW], col[NW];
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      best[k] = kBf16 ? kNegInf2 : __float_as_uint(-CUDART_INF_F);
      col[k] = kBf16 ? first * 0x10001u : first;
    }
    for (int i0 = grp; i0 < len; i0 += groups * kBatch) {
      U buf[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = i0 + j * groups;
        if (active && i < len) {
          buf[j] = xw[static_cast<int64_t>(list[i]) * nvec + v];
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = i0 + j * groups;
        if (active && i < len) {
          unsigned words[NW];
          to_words(buf[j], words);
          const unsigned w = list[i];
#pragma unroll
          for (int k = 0; k < NW; ++k) {
            fold<kBf16, kTrack>(words[k], w, w * 0x10001u, best[k], col[k]);
          }
        }
      }
    }
    // lanes gl of every group hold the same vector: merge them
    for (int off = width; off < 32; off <<= 1) {
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        const unsigned ob = __shfl_xor_sync(kFullMask, best[k], off);
        const unsigned oc =
            kTrack ? __shfl_xor_sync(kFullMask, col[k], off) : 0u;
        merge<kBf16, kTrack>(ob, oc, best[k], col[k]);
      }
    }
    if (grp == 0 && active) {
      const size_t at = static_cast<size_t>(row) * c + v * E;
      unsigned o[NW];
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        o[k] = len > 0 ? fold_zero<kBf16>(best[k]) : 0u;
      }
      *reinterpret_cast<U*>(out + at) = from_words<U>(o);
      if (kTrack) {
        int cols[E];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if constexpr (kBf16) {
            cols[e] = static_cast<int>((col[e / 2] >> (16 * (e % 2))) &
                                       0xffffu);
          } else {
            cols[e] = static_cast<int>(col[e]);
          }
        }
        if (arg != nullptr) {
          int a[E];
#pragma unroll
          for (int e = 0; e < E; ++e) a[e] = len > 0 ? cols[e] : -1;
          store_ints(arg + at, a);
        }
        if (index != nullptr) {
          int id[E];
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const int64_t src = base + (len > 0 ? cols[e] : 0);
            id[e] = src < n ? static_cast<int>(src) : n - 1;
          }
          store_ints(index + at, id);
        }
      }
    }
  }
}

struct Args {
  const int8_t* packed;
  const int64_t* s_blk;
  const int* counts;
  int count_stride, count_rows;
  const void* x;
  void* out;
  int* arg;
  int* index;
  int rows, n_t, n, c, window;
  cudaStream_t stream;
};

template <typename T, typename U, bool kTrack>
cudaError_t launch(const Args& a) {
  const size_t smem = static_cast<size_t>(kWarps) * a.window * 2;
  auto kernel = rank_pool_kernel<T, U, kTrack>;
  static size_t allowed[kMaxDevices] = {};
  const cudaError_t err = sph3d::allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  kernel<<<(a.rows + kWarps - 1) / kWarps, kWarps * 32, smem, a.stream>>>(
      a.packed, a.s_blk, a.counts, a.count_stride, a.count_rows,
      static_cast<const T*>(a.x), static_cast<T*>(a.out), a.arg, a.index,
      a.rows, a.n_t, a.n, a.c, a.window);
  return cudaGetLastError();
}

template <typename T, typename U>
cudaError_t launch_track(const Args& a) {
  return a.arg != nullptr || a.index != nullptr ? launch<T, U, true>(a)
                                                : launch<T, U, false>(a);
}

}  // namespace

// packed: (B, n_t, 128, W) int8, 16-byte aligned (W a multiple of 16);
// s_blk: (B, n_t) int64; counts: int32 rank bounds, row t of cloud b at
// counts[b * count_stride + t] for t < count_rows (later rows: 0), or
// null for a bin map (every nonzero entry); x: (B, N, C); out: (B,
// n_t*128, C) in x's dtype; arg, index: (B, n_t*128, C) int32, or null.
// vec_bytes (16, 8, 4 or 2, at least the element size) divides C times
// the element size and x's address.
extern "C" int sph3d_rank_pool_launch(const int8_t* packed,
                                      const int64_t* s_blk,
                                      const int* counts, int count_stride,
                                      int count_rows, const void* x,
                                      void* out, int* arg, int* index,
                                      int batch, int n_t, int n, int c,
                                      int window, int is_bf16,
                                      int vec_bytes, void* stream) {
  const int elem = is_bf16 ? 2 : 4;
  if (c < 1 || c > kMaxC || n < 1 || window < 16 || window % 16 != 0 ||
      window > 65536 || vec_bytes < elem || (c * elem) % vec_bytes != 0 ||
      reinterpret_cast<uintptr_t>(x) % vec_bytes != 0 ||
      reinterpret_cast<uintptr_t>(packed) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  const Args a{packed, s_blk, counts, count_stride, count_rows, x, out, arg,
               index, batch * n_t * kTile, n_t, n, c, window,
               static_cast<cudaStream_t>(stream)};
  if (a.rows == 0) return cudaSuccess;
  if (is_bf16) {
    switch (vec_bytes) {
      case 16: return launch_track<__nv_bfloat16, uint4>(a);
      case 8: return launch_track<__nv_bfloat16, uint2>(a);
      case 4: return launch_track<__nv_bfloat16, unsigned>(a);
      case 2: return launch_track<__nv_bfloat16, unsigned short>(a);
    }
    return cudaErrorInvalidValue;
  }
  switch (vec_bytes) {
    case 16: return launch_track<float, uint4>(a);
    case 8: return launch_track<float, uint2>(a);
    case 4: return launch_track<float, unsigned>(a);
  }
  return cudaErrorInvalidValue;
}

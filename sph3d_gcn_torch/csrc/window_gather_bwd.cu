// K9: the segment sum of the backward passes: every cloud row's gradient
// summed from its list of terms, in list order. Two forms.
//
// Replaces the TPU kernel sph3d_gcn_tpu/ops/windowed.py:71
// (_onehot_matmul_t_kernel, launched at :126) and the block-granular
// scatter that XLA derived after it; in form (b) also the transpose of the
// dense window sums (the unpools' and the avg pool's backward, XLA's
// gather transpose in the JAX package). Plain PyTorch twins:
// sph3d_gcn_torch/ops/windowed.py::window_gather_bwd_plain (a) and
// ::window_sum_bwd_plain (b).
//
//   dx[r, :] = sum over the entries of row r's list, in list order, of
//              the entry's term
//
// summed in f32 and rounded once to the output dtype.
//  (a) The per-edge engine's gather backward: row r's list is
//      order[starts[r] .. starts[r + 1]), its edges grouped by target row
//      (ops/windowed.py::edge_lists); edge e's term is dg[e, :] (f32 or
//      bf16; dx in dg's dtype).
//  (b) The dense window sums' backward: row n of cloud b lists the window
//      rows (g, w) that are it, s_blk[g] * 128 + w = n, in ascending tile
//      g (ops/windowed.py::window_sum_bwd_plain builds these lists with
//      group_by_row); the term of (g, w) is the sum over r = 0..127
//      ascending, where lhs[g, r, w] is selected, of lhs[g, r, w] *
//      dout[g * 128 + r, :]: lhs the int8 map (selected: > 0, the factor
//      1, an exact product) or the weighted unpool's f32 or bf16 weights
//      (selected: nonzero), the product and the add each rounded
//      (__fmul_rn, __fadd_rn: nvcc contracts nothing into an FMA, so the
//      terms equal PyTorch's); dout and dx f32. The window gradients are
//      formed here, never stored.
// No float atomics and one fixed order: bitwise equal to the plain twins,
// and reproducible.
//
// Design. A row is owned by a lane group of G lanes, a power of two up to
// 32; a warp serves 32/G rows.
//  (a) A group fetches its list's next G entries in one coalesced load
//      (the G after them loading while it works) and hands them out by
//      __shfl_sync; it loads 4 edges' rows before it adds them, in order.
//      Rows of whole 16-byte vectors at 16-byte aligned addresses (the
//      widths 64 .. 1024) are read a vector a lane, G the smallest group
//      covering the row (ops/windowed.py::gather_bwd_layout, below). Any
//      other row (the odd widths 35, 67, 131, 259, or an address off 16
//      bytes) is read as the aligned 16-byte chunks that hold it, a chunk
//      a lane, each output chunk joined from a lane's chunk and the next
//      lane's by word selects and a funnel shift (as K8 joins its pieces,
//      csrc/window_gather.cu); a unit of G - 1 output chunks a slot, at
//      most 2 slots a lane a pass (ops/windowed.py::funnel_layout).
//  Form (b), and (a) on aligned rows: the row is read as vectors of V
//  bytes, 16, or 8/4 where the row's bytes or the operands' addresses
//  allow no wider, or where 16 would leave a lane of the group without a
//  vector (ops/windowed.py::gather_bwd_layout). Lane l takes vectors l +
//  G*q; a lane holds at most 16 bytes of a row a pass (3 vectors), and a
//  wider row walks its list in P passes, pass p taking the slots q = p, p
//  + P, ..., so every lane of the group has a live vector in every pass.
//  (b) A block owns 16 consecutive rows of a cloud, a group a row. Windows
//      are whole 16-row chunks (W and s_blk * 128 multiples of 16), so the
//      block's rows lie in the same tiles, their columns w0 .. w0 + 15 of
//      each: the block walks those tiles in ascending g (found from s_blk:
//      no sort of the window rows) and stages each tile's 128 x 16 slice
//      of lhs in shared memory (16-byte loads, each byte read once; the
//      next tile's slice loads while the block works on this one). A group
//      finds its column's selected rows by one ballot a G rows of the
//      slice, then loads 4 selected dout rows (from L2: a tile's rows serve
//      its whole window) before it adds them, in order.
//
// What bounds it on the H100: (a) each valid edge's gradient row read once
// and dx written, plus 4 bytes a list entry; (b) lhs read once, dout, and
// dx written, and 2 operations a selected entry and channel
// (ops/costs.py).
#include <type_traits>

#include "common.cuh"

namespace {

using sph3d::kFullMask;
using sph3d::kTile;

constexpr int kThreads = 256;     // form (a)'s block
constexpr int kInFlight = 4;      // form (a): rows loaded before their adds
constexpr int kGatherBlocks = 4;  // form (a)'s blocks an SM (64 registers)
constexpr int kFunnelInFlight = 4;  // form (a), funnel: rows in flight
constexpr int kFunnelBlocks = 3;    // form (a), funnel: blocks an SM
constexpr int kFunnelSlots = 2;     // form (a), funnel: most slots a pass
constexpr int kUnit = 16;         // form (b): the rows of a block
constexpr int kSumInFlight = 4;   // form (b): dout rows loaded before adds

template <int V>
__host__ __device__ constexpr int words() { return V / 4; }

// The most vectors a lane holds a pass: 16 bytes, at most 3 vectors
// (ops/windowed.py::GATHER_BWD_LANE_BYTES, GATHER_BWD_MAX_SLOTS).
template <int V>
__host__ __device__ constexpr int max_slots() { return V >= 8 ? 16 / V : 3; }

template <int V>
__device__ __forceinline__ void load_vec(const char* p,
                                         unsigned (&w)[words<V>()]) {
  if constexpr (V == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = u.x;
    w[1] = u.y;
    w[2] = u.z;
    w[3] = u.w;
  } else if constexpr (V == 8) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = u.x;
    w[1] = u.y;
  } else {
    static_assert(V == 4, "16-, 8- or 4-byte vectors");
    w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
  }
}

// Element j of a vector as f32 (a bf16 is the high half of its f32).
template <typename T, int V>
__device__ __forceinline__ float elem(const unsigned (&w)[words<V>()],
                                      int j) {
  if constexpr (std::is_same_v<T, float>) {
    return __uint_as_float(w[j]);
  } else {
    return __uint_as_float(((w[j >> 1] >> (16 * (j & 1))) & 0xffffu) << 16);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(char* p,
                                          const float (&a)[V / sizeof(T)]) {
  unsigned w[words<V>()] = {};
#pragma unroll
  for (int j = 0; j < static_cast<int>(V / sizeof(T)); ++j) {
    if constexpr (std::is_same_v<T, float>) {
      w[j] = __float_as_uint(a[j]);
    } else {
      const unsigned b = __bfloat16_as_ushort(sph3d::from_float<T>(a[j]));
      w[j >> 1] |= b << (16 * (j & 1));
    }
  }
  if constexpr (V == 16) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (V == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
    *reinterpret_cast<unsigned*>(p) = w[0];
  }
}

// A thread's lane group: its lane in the group, the group's first lane in
// the warp and the group's lanes.
struct Group {
  int lg;
  int first;
  unsigned mask;
};

__device__ __forceinline__ Group group_of(int log_g) {
  const int lane = threadIdx.x & 31;
  const int g = 1 << log_g;
  Group gr;
  gr.lg = lane & (g - 1);
  gr.first = lane - gr.lg;
  gr.mask = (g == 32 ? kFullMask : (1u << g) - 1u) << gr.first;
  return gr;
}

// The lane's vectors of pass p: vector lg + G * (p + passes * j) of slot j.
template <int S, int V>
__device__ __forceinline__ void pass_slots(const Group& gr, int log_g,
                                           int p, int passes, int slots,
                                           int nv, int (&voff)[S],
                                           bool (&live)[S]) {
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int v = gr.lg + ((p + passes * j) << log_g);
    live[j] = j < slots && v < nv;
    voff[j] = v * V;
  }
}

// Calls chunk(ids, n) for the list entries order[e0 .. e1), in order, up to
// IF at a time (ids[q] for q < n). The group fetches its next G
// entries in one coalesced load, a lane each, the fetch after them issued
// before it works on these; entry i comes from lane i % G by a shuffle.
template <int IF, typename Chunk>
__device__ __forceinline__ void walk_list(const int* __restrict__ order,
                                          int e0, int e1, const Group& gr,
                                          int log_g, Chunk&& chunk) {
  const int g = 1 << log_g;
  int ord = e0 + gr.lg < e1 ? __ldg(order + e0 + gr.lg) : 0;
  for (int base = e0; base < e1; base += g) {
    const int at = base + g + gr.lg;
    const int next = at < e1 ? __ldg(order + at) : 0;
    const int n = min(g, e1 - base);
    for (int c = 0; c < n; c += IF) {
      int ids[IF];
#pragma unroll
      for (int q = 0; q < IF; ++q) {
        ids[q] = __shfl_sync(gr.mask, ord, gr.first + ((c + q) & (g - 1)));
      }
      chunk(ids, min(IF, n - c));
    }
    ord = next;
  }
}

// Form (a) on rows of whole 16-byte vectors at 16-byte aligned addresses:
// dx[r] = sum of dg[order[i]] over row r's list.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kGatherBlocks)
    window_gather_bwd_kernel(const T* __restrict__ dg,
                             const int* __restrict__ order,
                             const int* __restrict__ starts,
                             T* __restrict__ dx, int rows, int nv,
                             int log_g, int slots, int passes) {
  constexpr int S = max_slots<V>();
  constexpr int E = V / sizeof(T);
  constexpr int NW = words<V>();
  const Group gr = group_of(log_g);
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int r = static_cast<int>(t >> log_g);
  if (r >= rows) return;  // the whole group
  const int e0 = starts[r];
  const int e1 = starts[r + 1];
  const int64_t row_bytes = static_cast<int64_t>(nv) * V;
  const char* src = reinterpret_cast<const char*>(dg);
  for (int p = 0; p < passes; ++p) {
    int voff[S];
    bool live[S];
    pass_slots<S, V>(gr, log_g, p, passes, slots, nv, voff, live);
    float acc[S][E] = {};
    walk_list<kInFlight>(order, e0, e1, gr, log_g,
              [&](const int (&ids)[kInFlight], int n) {
                unsigned v[kInFlight][S][NW];
#pragma unroll
                for (int q = 0; q < kInFlight; ++q) {
                  if (q >= n) continue;
                  const char* row = src + ids[q] * row_bytes;
#pragma unroll
                  for (int j = 0; j < S; ++j) {
                    if (live[j]) load_vec<V>(row + voff[j], v[q][j]);
                  }
                }
#pragma unroll
                for (int q = 0; q < kInFlight; ++q) {
                  if (q >= n) continue;
#pragma unroll
                  for (int j = 0; j < S; ++j) {
                    if (!live[j]) continue;
#pragma unroll
                    for (int el = 0; el < E; ++el) {
                      acc[j][el] += elem<T, V>(v[q][j], el);
                    }
                  }
                }
              });
    char* out = reinterpret_cast<char*>(dx) + r * row_bytes;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      if (live[j]) store_vec<T, V>(out + voff[j], acc[j]);
    }
  }
}

// Form (a) on any other row (an odd width, or a row or address off 16
// bytes): row r's output chunk k, its bytes [16k, 16k + 16), is the 16
// bytes at offset s of the aligned 16-byte chunks k and k + 1 that hold
// the edge's gradient row (s the row's address mod 16, per edge). Lane l of
// a group of G takes aligned chunk u * (G - 1) + l of unit u, loads it with
// one 16-byte load, gets chunk + 1 from lane l + 1 by a shuffle and joins
// the two by word selects and a funnel shift (s is a whole number of
// elements); lanes 0 .. G - 2 own the unit's output chunks, lane G - 1 only
// loads. An aligned chunk holding a byte of the row lies inside the
// gradients' allocation (allocations are 256-byte aligned), so the loads
// stay inside it. Slot j of pass p is unit p + passes * j, for j < S.
template <typename T, int S>
__global__ void __launch_bounds__(kThreads, kFunnelBlocks)
    window_gather_bwd_funnel_kernel(const T* __restrict__ dg,
                                    const int* __restrict__ order,
                                    const int* __restrict__ starts,
                                    T* __restrict__ dx, int rows,
                                    int row_bytes, int log_g, int passes) {
  constexpr int IF = kFunnelInFlight;
  constexpr int E = 16 / sizeof(T);
  const Group gr = group_of(log_g);
  const int g = 1 << log_g;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int r = static_cast<int>(t >> log_g);
  if (r >= rows) return;  // the whole group
  const int e0 = starts[r];
  const int e1 = starts[r + 1];
  const int outs = (row_bytes + 15) >> 4;  // output chunks of a row
  const uintptr_t src = reinterpret_cast<uintptr_t>(dg);
  for (int p = 0; p < passes; ++p) {
    int chunk[S];  // the lane's aligned chunk (and output chunk) a slot
    bool own[S];   // it owns that output chunk
#pragma unroll
    for (int j = 0; j < S; ++j) {
      chunk[j] = (p + passes * j) * (g - 1) + gr.lg;
      own[j] = gr.lg < g - 1 && chunk[j] < outs;
    }
    float acc[S][E] = {};
    walk_list<IF>(order, e0, e1, gr, log_g,
                  [&](const int (&ids)[IF], int n) {
      unsigned v[IF][S][4];
      int shift[IF];
#pragma unroll
      for (int q = 0; q < IF; ++q) {
        if (q >= n) continue;
        const uintptr_t a = src + static_cast<uintptr_t>(ids[q]) *
                                      static_cast<uintptr_t>(row_bytes);
        const uint4* base = reinterpret_cast<const uint4*>(
            a & ~static_cast<uintptr_t>(15));
        shift[q] = static_cast<int>(a & 15u);
        const int held = (shift[q] + row_bytes + 15) >> 4;  // chunks
#pragma unroll
        for (int j = 0; j < S; ++j) {
          uint4 u = make_uint4(0u, 0u, 0u, 0u);
          if (chunk[j] < held) u = __ldg(base + chunk[j]);
          v[q][j][0] = u.x;
          v[q][j][1] = u.y;
          v[q][j][2] = u.z;
          v[q][j][3] = u.w;
        }
      }
#pragma unroll
      for (int q = 0; q < IF; ++q) {
        if (q >= n) continue;
        const int k = shift[q] >> 2;           // whole words
        const int h = 8 * (shift[q] & 3);      // and bits: 0 or 16
#pragma unroll
        for (int j = 0; j < S; ++j) {
          unsigned w[8];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            w[i] = v[q][j][i];
            w[4 + i] = __shfl_down_sync(gr.mask, v[q][j][i], 1, g);
          }
#pragma unroll
          for (int i = 0; i < 6; ++i) w[i] = (k & 2) ? w[i + 2] : w[i];
#pragma unroll
          for (int i = 0; i < 5; ++i) w[i] = (k & 1) ? w[i + 1] : w[i];
          unsigned out[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            out[i] = __funnelshift_r(w[i], w[i + 1], h);
          }
          if (!own[j]) continue;
#pragma unroll
          for (int el = 0; el < E; ++el) {
            acc[j][el] += elem<T, 16>(out, el);
          }
        }
      }
    });
    char* row = reinterpret_cast<char*>(dx) +
                static_cast<int64_t>(r) * row_bytes;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      if (!own[j]) continue;
#pragma unroll
      for (int el = 0; el < E; ++el) {
        const int at = chunk[j] * 16 + el * static_cast<int>(sizeof(T));
        if (at < row_bytes) {
          *reinterpret_cast<T*>(row + at) = sph3d::from_float<T>(acc[j][el]);
        }
      }
    }
  }
}

// Form (b)'s lhs: the int8 map or the weighted unpool's weights.
enum LhsKind { kMap = 0, kF32 = 1, kBf16 = 2 };

// The 16 lhs entries at element i (a multiple of 16) as factors: a map
// entry 1 where selected (> 0), else 0; a weight as it is. An entry is
// selected where its factor is nonzero.
__device__ __forceinline__ void factors16(const void* lhs, int kind,
                                          int64_t i, float (&f)[kUnit]) {
  if (kind == kMap) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(
        static_cast<const int8_t*>(lhs) + i));
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int q = 0; q < kUnit; ++q) {
      const int b = static_cast<int8_t>((w[q >> 2] >> (8 * (q & 3))) & 0xffu);
      f[q] = b > 0 ? 1.f : 0.f;
    }
  } else if (kind == kF32) {
    const float4* p = reinterpret_cast<const float4*>(
        static_cast<const float*>(lhs) + i);
#pragma unroll
    for (int q = 0; q < kUnit / 4; ++q) {
      const float4 u = __ldg(p + q);
      f[4 * q] = u.x;
      f[4 * q + 1] = u.y;
      f[4 * q + 2] = u.z;
      f[4 * q + 3] = u.w;
    }
  } else {
    const uint4* p = reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(lhs) + i);
#pragma unroll
    for (int q = 0; q < kUnit / 8; ++q) {
      const uint4 u = __ldg(p + q);
      const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        f[8 * q + k] = __uint_as_float(
            ((w[k >> 1] >> (16 * (k & 1))) & 0xffffu) << 16);
      }
    }
  }
}

// Form (b): a block owns the kUnit rows n0 .. of cloud b, a group a row.
// Two blocks an SM (64 registers a thread, a few spilled) ran faster than
// one on the H100: the tile walk is latency-bound.
template <int V>
__global__ void __launch_bounds__(kUnit * 32, 2)
    window_sum_bwd_kernel(const void* __restrict__ lhs, int kind,
                          const int64_t* __restrict__ s_blk,
                          const float* __restrict__ dout,
                          float* __restrict__ dx, int num_in, int n_t,
                          int window, int nv, int log_g, int slots,
                          int passes) {
  constexpr int S = max_slots<V>();
  constexpr int E = V / 4;
  constexpr int NW = words<V>();
  // the staged slices (two: the next loads while this one is read), one
  // tile's 128 rows of the block's 16 columns as factors, column-major
  __shared__ float fac[2][kUnit][kTile];
  const Group gr = group_of(log_g);
  const int tid = threadIdx.x;
  const int units = (num_in + kUnit - 1) / kUnit;
  const int b = blockIdx.x / units;
  const int n0 = (blockIdx.x - b * units) * kUnit;
  const int i = tid >> log_g;  // the block's row n0 + i, column w0 + i
  const bool own = n0 + i < num_in;
  const int64_t* sb = s_blk + static_cast<int64_t>(b) * n_t;
  const int64_t tile0 = static_cast<int64_t>(b) * n_t;
  const int64_t row_bytes = static_cast<int64_t>(nv) * V;
  const char* src = reinterpret_cast<const char*>(dout);
  const int g_size = 1 << log_g;
  const int col_steps = kTile >> log_g;  // ballots a column: 4 or more
  // the first tile at or after g whose window holds the block's rows
  auto next_tile = [&](int g) {
    for (; g < n_t; ++g) {
      const int64_t s = sb[g] * kTile;
      if (s <= n0 && n0 < s + window) break;
    }
    return g;
  };
  // element index of the slice's row r in tile g
  auto slice_at = [&](int g, int r) {
    return ((tile0 + g) * kTile + r) * window + (n0 - sb[g] * kTile);
  };
  const bool prefetch = blockDim.x >= kTile;  // a slice row a thread
  for (int p = 0; p < passes; ++p) {
    int voff[S];
    bool live[S];
    pass_slots<S, V>(gr, log_g, p, passes, slots, nv, voff, live);
    float acc[S][E] = {};
    int g = next_tile(0);
    if (g < n_t) {
      for (int r = tid; r < kTile; r += blockDim.x) {
        float f[kUnit];
        factors16(lhs, kind, slice_at(g, r), f);
#pragma unroll
        for (int q = 0; q < kUnit; ++q) fac[0][q][r] = f[q];
      }
    }
    __syncthreads();
    for (int buf = 0; g < n_t; buf ^= 1) {
      const int gn = next_tile(g + 1);
      float pre[kUnit];
      if (gn < n_t && prefetch && tid < kTile) {
        factors16(lhs, kind, slice_at(gn, tid), pre);
      }
      if (own) {
        const float* col = fac[buf][i];
        // the column's selected rows: bit r of (hi:lo)
        uint64_t lo = 0, hi = 0;
        for (int j = 0; j < col_steps; ++j) {
          unsigned bits = __ballot_sync(
                              gr.mask, col[gr.lg + (j << log_g)] != 0.f) >>
                          gr.first;
          if (g_size < 32) bits &= (1u << g_size) - 1u;
          const int pos = j << log_g;
          if (pos < 64) {
            lo |= static_cast<uint64_t>(bits) << pos;
          } else {
            hi |= static_cast<uint64_t>(bits) << (pos - 64);
          }
        }
        float term[S][E] = {};
        const char* trows = src + (tile0 + g) * kTile * row_bytes;
        while (lo | hi) {  // group-uniform
          int rr[kSumInFlight];
#pragma unroll
          for (int k = 0; k < kSumInFlight; ++k) {
            if (lo) {
              rr[k] = __ffsll(static_cast<long long>(lo)) - 1;
              lo &= lo - 1;
            } else if (hi) {
              rr[k] = 63 + __ffsll(static_cast<long long>(hi));
              hi &= hi - 1;
            } else {
              rr[k] = -1;
            }
          }
          unsigned v[kSumInFlight][S][NW];
#pragma unroll
          for (int k = 0; k < kSumInFlight; ++k) {
            if (rr[k] < 0) continue;
            const char* row = trows + rr[k] * row_bytes;
#pragma unroll
            for (int j = 0; j < S; ++j) {
              if (live[j]) load_vec<V>(row + voff[j], v[k][j]);
            }
          }
#pragma unroll
          for (int k = 0; k < kSumInFlight; ++k) {
            if (rr[k] < 0) continue;
            const float wt = col[rr[k]];
#pragma unroll
            for (int j = 0; j < S; ++j) {
              if (!live[j]) continue;
#pragma unroll
              for (int el = 0; el < E; ++el) {
                term[j][el] = __fadd_rn(
                    term[j][el], __fmul_rn(wt, elem<float, V>(v[k][j], el)));
              }
            }
          }
        }
#pragma unroll
        for (int j = 0; j < S; ++j) {
#pragma unroll
          for (int el = 0; el < E; ++el) {
            acc[j][el] = __fadd_rn(acc[j][el], term[j][el]);
          }
        }
      }
      if (gn < n_t) {
        if (prefetch) {
          if (tid < kTile) {
#pragma unroll
            for (int q = 0; q < kUnit; ++q) fac[buf ^ 1][q][tid] = pre[q];
          }
        } else {
          for (int r = tid; r < kTile; r += blockDim.x) {
            float f[kUnit];
            factors16(lhs, kind, slice_at(gn, r), f);
#pragma unroll
            for (int q = 0; q < kUnit; ++q) fac[buf ^ 1][q][r] = f[q];
          }
        }
      }
      __syncthreads();  // the slice read, the next one written
      g = gn;
    }
    if (own) {
      char* out = reinterpret_cast<char*>(dx) +
                  (static_cast<int64_t>(b) * num_in + n0 + i) * row_bytes;
#pragma unroll
      for (int j = 0; j < S; ++j) {
        if (live[j]) store_vec<float, V>(out + voff[j], acc[j]);
      }
    }
    __syncthreads();  // the next pass restages the slices
  }
}

template <typename T>
cudaError_t launch_gather(const void* dg, const int* order,
                          const int* starts, void* dx, int rows, int c,
                          int log_g, int slots, int passes, bool funnel,
                          cudaStream_t stream) {
  const int row_bytes = c * static_cast<int>(sizeof(T));
  if (funnel ? slots > kFunnelSlots
             : (slots > max_slots<16>() || row_bytes % 16 != 0)) {
    return cudaErrorInvalidValue;
  }
  const int64_t blocks =
      ((static_cast<int64_t>(rows) << log_g) + kThreads - 1) / kThreads;
  if (blocks == 0) return cudaSuccess;
  const auto grid = static_cast<unsigned>(blocks);
  if (funnel && slots == 1) {
    window_gather_bwd_funnel_kernel<T, 1><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(dg), order, starts, static_cast<T*>(dx), rows,
        row_bytes, log_g, passes);
  } else if (funnel) {
    window_gather_bwd_funnel_kernel<T, 2><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(dg), order, starts, static_cast<T*>(dx), rows,
        row_bytes, log_g, passes);
  } else {
    window_gather_bwd_kernel<T, 16><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(dg), order, starts, static_cast<T*>(dx), rows,
        row_bytes / 16, log_g, slots, passes);
  }
  return cudaGetLastError();
}

template <int V>
cudaError_t launch_sum(const void* lhs, int kind, const int64_t* s_blk,
                       const void* dout, void* dx, int batch, int num_in,
                       int n_t, int window, int nv, int log_g, int slots,
                       int passes, cudaStream_t stream) {
  if (slots > max_slots<V>() || window < kUnit || window % kUnit != 0 ||
      n_t < 1) {
    return cudaErrorInvalidValue;
  }
  const int64_t blocks = static_cast<int64_t>(batch) *
                         ((num_in + kUnit - 1) / kUnit);
  if (blocks == 0) return cudaSuccess;
  window_sum_bwd_kernel<V>
      <<<static_cast<unsigned>(blocks), kUnit << log_g, 0, stream>>>(
          lhs, kind, s_blk, static_cast<const float*>(dout),
          static_cast<float*>(dx), num_in, n_t, window, nv, log_g, slots,
          passes);
  return cudaGetLastError();
}

// fn(std::integral_constant<int, V>) for the vector width vec among Vs.
template <int... Vs, typename Fn>
cudaError_t by_vec(int vec, Fn fn) {
  cudaError_t err = cudaErrorInvalidValue;
  (void)((vec == Vs ? (err = fn(std::integral_constant<int, Vs>{}), true)
                    : false) ||
         ...);
  return err;
}

// The lane-group layout's checks: a group of a power of two lanes up to
// 32, covering `cover` of the row's nv vectors (or chunks) a slot, in
// slots a pass and passes.
bool bad_layout(int nv, int group, int cover, int slots, int passes) {
  return nv < 1 || slots < 1 || passes < 1 || group < 1 || group > 32 ||
         (group & (group - 1)) != 0 || cover < 1 ||
         static_cast<int64_t>(cover) * slots * passes < nv;
}

}  // namespace

// Form (a). dg (B, M_pad, K, C) f32 / bf16 (is_bf16), order (B * M_pad *
// K,) int32 entries grouped by row, starts (rows + 1,) int32, dx (rows, C)
// in dg's dtype. group lanes a row (a power of two up to 32), slots a lane
// a pass, passes: of 16-byte vectors (funnel 0: rows of whole vectors at
// 16-byte aligned addresses; ops/windowed.py::gather_bwd_layout) or of
// units of group - 1 output chunks (funnel 1; ::funnel_layout).
extern "C" int sph3d_window_gather_bwd_launch(
    const void* dg, const int* order, const int* starts, void* dx, int rows,
    int c, int group, int slots, int passes, int funnel, int is_bf16,
    void* stream) {
  const int row_bytes = c * (is_bf16 ? 2 : 4);
  const int units = funnel ? (row_bytes + 15) / 16 : row_bytes / 16;
  if (rows < 0 || c < 1 ||
      bad_layout(units, group, funnel ? group - 1 : group, slots, passes)) {
    return cudaErrorInvalidValue;
  }
  const int log_g = __builtin_ctz(static_cast<unsigned>(group));
  const auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch_gather<__nv_bfloat16>(dg, order, starts, dx, rows, c,
                                        log_g, slots, passes, funnel != 0,
                                        st);
  }
  return launch_gather<float>(dg, order, starts, dx, rows, c, log_g, slots,
                              passes, funnel != 0, st);
}

// Form (b). lhs the int8 map / f32 / bf16 weights (kind 0 / 1 / 2) (B,
// n_t, 128, window), 16-byte aligned, window a multiple of 16; s_blk (B,
// n_t) int64; dout (B, n_t * 128, C) f32; dx (B, num_in, C) f32. The
// layout as form (a)'s.
extern "C" int sph3d_window_sum_bwd_launch(
    const void* lhs, int kind, const int64_t* s_blk, const void* dout,
    void* dx, int batch, int num_in, int n_t, int window, int nv, int group,
    int slots, int passes, int vec, void* stream) {
  if (batch < 0 || num_in < 0 || kind < kMap || kind > kBf16 ||
      bad_layout(nv, group, group, slots, passes)) {
    return cudaErrorInvalidValue;
  }
  const int log_g = __builtin_ctz(static_cast<unsigned>(group));
  return by_vec<16, 8, 4>(vec, [&](auto v) {
    return launch_sum<decltype(v)::value>(
        lhs, kind, s_blk, dout, dx, batch, num_in, n_t, window, nv, log_g,
        slots, passes, static_cast<cudaStream_t>(stream));
  });
}

// K1: farthest-point sampling, each cloud held in registers, spread over
// a thread block cluster at large N; beyond the registers, walked in
// device memory by a cluster.
//
// Replaces the TPU kernel sph3d_gcn_tpu/ops/pallas/fps_kernel.py:44
// (_fps_kernel, reached via farthest_point_sample_pallas). Plain PyTorch
// twin: sph3d_gcn_torch/ops/sample.py::farthest_point_sample_plain.
//
// Semantics: seed index 0, min-distance initialised to 1e38, running
// minimum of squared distances (dx*dx + dy*dy) + dz*dz, argmax with ties
// to the lowest index. Reads the f32 coordinates of a (B, N, C >= 3)
// tensor with its strides; writes (B, npoint) int64.
//
// What bounds it on the H100: the chain, not bytes or FLOPs. The npoint-1
// greedy steps are sequential, and each ends in an argmax over the whole
// cloud that the next step needs. A step costs the distance update of the
// points one SM holds (issue-bound: about 12 instructions a point over an
// SM's 4 schedulers) plus the latency of the reductions and of the
// exchange that publishes the winner: about 0.2 us a step in one block of
// 4 warps, 0.28-0.35 us in a cluster (NVIDIA H100 80GB HBM3, 700 W;
// PERF.md). The kernel before this one (one 1024-thread block a cloud,
// the cloud in shared memory) paid 4 shared-memory accesses a point
// through one SM and two block barriers: about 1.4 us a step.
//
// What the design does about it:
//  - The cloud lives in registers: a thread holds P points (x, y, z and
//    running minimum), P a template parameter, so the arrays unroll and a
//    step's update touches no memory. Padded slots hold -1 as their
//    minimum and never win. A thread scans its slots in up to 4 runs and
//    takes the runs' maximum by a tree, a chain of P / 4 + 2 compares.
//  - The argmax is exact in any order: non-negative floats order as their
//    bits do as signed integers (-1 below them all), so a warp takes
//    __reduce_max_sync of the bits, then __reduce_min_sync of the index
//    among the lanes that hold the maximum. Only (value bits, index) keys
//    travel: every CTA keeps the cloud's coordinates in shared memory too
//    and reads the winner's from there.
//  - Two modes in registers, chosen on the host from (B, N) alone
//    (ops/sample.py::fps_plan). One block: each warp's key goes into a
//    slot of a parity-indexed shared array, one __syncthreads, then every
//    warp reduces the slots itself (no second barrier). A cluster of C
//    CTAs: lane r of each warp stores the warp's key straight into its
//    slot in CTA r (st.async into distributed shared memory), which counts
//    the bytes on CTA r's mbarrier for that parity; each CTA waits on its
//    own mbarrier only, then every warp reduces the same C x warps keys
//    (at most 32, one a lane) to the same winner. Slots and mbarriers
//    alternate with the step's parity: a CTA writes step j + 2's keys
//    only after every CTA has sent step j + 1's, which each warp does
//    after reading step j's. A cluster barrier a step (barrier.cluster
//    arrive.release / wait.acquire) in the mbarriers' place cost 0.67-0.94
//    us a step against their 0.40-0.48 (one point a thread, same call):
//    every thread of the cluster takes part in it. A lone warp would need
//    no exchange, but no configuration samples a cloud of fewer than 384
//    points, so a small cloud takes a block too.
//  - A cluster CTA asks for more than half an SM's shared memory, so that
//    each SM holds one CTA: a cluster spreads its cloud over C SMs. C is
//    the largest size whose B clusters run in one wave
//    (cudaOccupancyMaxActiveClusters, queried once a plan): an H100 runs
//    15 clusters of 8 or 7 at once, 17 of 6, so 16 clouds take C = 6 (96
//    SMs); 2 waves of 8-CTA clusters took 1.9x the time of 6-CTA ones.
//  - A cloud beyond the registers (16384 points: 8 CTAs of 4 warps, 16
//    points a thread; a CTA's shared-memory copy of it, 12 bytes a point,
//    and the 32 warp keys a step reduces end there too) takes
//    fps_stream_kernel, chosen on the host as the plan with no points a
//    thread (ppt = 0). It has no cap but the card's memory: each point's
//    x, y, z and running minimum lie in a (B, N) float4 scratch that its
//    thread reads and writes back every step, 4 points' loads in flight;
//    each CTA of 32 warps reduces its warps' keys in shared memory to one
//    before the cluster exchange (so a step reduces at most 8 keys), and
//    the winner's coordinates are read from the cloud in device memory.
//    What bounds it: the scratch's 20 bytes a point and step through the
//    cluster's SMs, mostly from L2 (the scratch of a few clouds fits its
//    50 MB), and the exchange and the winner's read a step. Speed at these
//    sizes was not a goal; no configuration samples such a cloud.
//
// Numerics: the distance is written with __fmul_rn/__fadd_rn (no FMA
// contraction), so the indices equal the plain version's bit for bit.
#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

using sph3d::kFullMask;
using sph3d::kMaxDevices;

// the points a thread may hold: the instances built. The plan
// (ops/sample.py::fps_plan) chooses among them, and a launch with another
// count fails.
#define SPH3D_FPS_PPT(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(8) X(10) X(12) X(14) X(16)

constexpr int kMaxCands = 32;      // candidates a step reduces: one a lane
constexpr int kMaxCluster = 8;     // CTAs a cluster: the portable size
constexpr int kStreamThreads = 1024;  // a CTA of fps_stream_kernel, at most
constexpr int kStreamBatch = 4;    // its points a thread loads at once
constexpr int kCopyBatch = 16;     // words of the cloud a thread loads at once
// dynamic shared memory: the cloud's x, y and z (12 bytes a point); for a
// cluster CTA at least more than half an SM's 228 KB, so that an SM holds
// one CTA of a cluster
constexpr int kCloudBytes = 12;
constexpr int kSoloSmem = 116 * 1024;

__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return static_cast<int>(r);
}

// every thread of the cluster arrives (its writes released) and waits for
// all the others (acquired)
__device__ __forceinline__ void cluster_barrier() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the address of the same shared variable in CTA `rank` of the cluster
__device__ __forceinline__ uint32_t at_rank(const void* p, int rank) {
  uint32_t remote;
  asm("mapa.shared::cluster.u32 %0, %1, %2;"
      : "=r"(remote) : "r"(smem_addr(p)), "r"(rank));
  return remote;
}

__device__ __forceinline__ void mbar_init(const uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// the local arrival of a phase, which then also waits for `bytes`
__device__ __forceinline__ void mbar_expect_tx(const uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(const uint64_t* bar,
                                          uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

// a store into another CTA's shared memory that counts its bytes on that
// CTA's mbarrier `bar`
__device__ __forceinline__ void st_async(uint32_t addr, int2 v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.s32 "
      "[%0], {%1, %2}, [%3];"
      :: "r"(addr), "r"(v.x), "r"(v.y), "r"(bar) : "memory");
}

// Thread t of CTA `rank` holds points rank * T * P + k * T + t, k < P.
// kCluster: the cloud spreads over `cluster` CTAs of a cluster, else one
// block holds it. Up to 6 points a thread fit 64 registers (1024 threads
// a block), up to 16 fit 128 (512 threads): ops/sample.py::max_threads.
template <int P, bool kCluster>
__global__ void __launch_bounds__(P <= 6 ? 1024 : 512, 1)
    fps_kernel(const float* __restrict__ xyz, long long batch_stride,
               long long row_stride, long long* __restrict__ out, int n,
               int npoint, int cluster) {
  constexpr int kRun = (P + 3) / 4;              // slots a run scans
  constexpr int kRuns = (P + kRun - 1) / kRun;   // runs: at most 4
  extern __shared__ float s_cloud[];    // x, y, z of point 0, 1, ...
  __shared__ int2 s_key[2][kMaxCands];  // a step's candidates (bits, index)
  __shared__ uint64_t s_bar[2];         // kCluster: a step's arrivals

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int nw = blockDim.x >> 5;
  int rank = 0;
  int cloud = blockIdx.x;
  if constexpr (kCluster) {
    rank = cluster_rank();
    cloud = blockIdx.x / cluster;
  }
  const float* p = xyz + cloud * batch_stride;
  long long* o = out + static_cast<long long>(cloud) * npoint;
  // the cloud into shared memory, kCopyBatch loads of a thread in flight
  // (coalesced when the rows are 3 floats wide)
  const int words = 3 * n;
  for (int w0 = 0; w0 < words; w0 += kCopyBatch * blockDim.x) {
    float v[kCopyBatch];
#pragma unroll
    for (int u = 0; u < kCopyBatch; ++u) {
      const int w = w0 + u * blockDim.x + t;
      v[u] = w < words ? p[(w / 3) * row_stride + w % 3] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kCopyBatch; ++u) {
      const int w = w0 + u * blockDim.x + t;
      if (w < words) s_cloud[w] = v[u];
    }
  }
  const int slot = rank * nw + (t >> 5);
  const int n_cand = (kCluster ? cluster : 1) * nw;
  if (kCluster && t == 0) {
    mbar_init(&s_bar[0], 1);
    mbar_init(&s_bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // every CTA of the cluster runs before any writes into its shared memory
  if constexpr (kCluster) cluster_barrier();

  const int first = rank * static_cast<int>(blockDim.x) * P + t;
  float x[P], y[P], z[P], md[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int i = first + k * static_cast<int>(blockDim.x);
    x[k] = i < n ? s_cloud[3 * i] : 0.0f;
    y[k] = i < n ? s_cloud[3 * i + 1] : 0.0f;
    z[k] = i < n ? s_cloud[3 * i + 2] : 0.0f;
    md[k] = i < n ? 1e38f : -1.0f;
  }
  float xo = s_cloud[0], yo = s_cloud[1], zo = s_cloud[2];
  const bool writer = rank == 0 && t == 0;
  if (writer) o[0] = 0;

  for (int j = 1; j < npoint; ++j) {
    // the thread's first maximum: a scan of each of G runs of slots, then
    // a tree over the runs (a chain of P / G + 2 compares, not P); a later
    // slot or run wins only if strictly larger
    float bv[kRuns];
    int bk[kRuns];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      md[k] = fminf(md[k], sph3d::sum_sq3(x[k] - xo, y[k] - yo, z[k] - zo));
      const int g = k / kRun;
      if (k % kRun == 0 || md[k] > bv[g]) {
        bv[g] = md[k];
        bk[g] = k;
      }
    }
#pragma unroll
    for (int s = 1; s < kRuns; s *= 2) {
#pragma unroll
      for (int g = 0; g + s < kRuns; g += 2 * s) {
        if (bv[g + s] > bv[g]) {
          bv[g] = bv[g + s];
          bk[g] = bk[g + s];
        }
      }
    }
    const int bi = first + bk[0] * static_cast<int>(blockDim.x);
    const int bits = __float_as_int(bv[0]);
    const int wv = __reduce_max_sync(kFullMask, bits);
    int win = __reduce_min_sync(kFullMask, bits == wv ? bi : INT_MAX);
    const int par = j & 1;
    const int2 key = make_int2(wv, win);
    if constexpr (!kCluster) {
      if (lane == 0) s_key[par][slot] = key;
      __syncthreads();
    } else {
      // lane r sends the warp's candidate to CTA r of the cluster
      if (t == 0) mbar_expect_tx(&s_bar[par], n_cand * sizeof(int2));
      if (lane < cluster) {
        st_async(at_rank(&s_key[par][slot], lane), key,
                 at_rank(&s_bar[par], lane));
      }
      // the k-th use of a parity's barrier waits for its phase k
      mbar_wait(&s_bar[par], ((j - 1) >> 1) & 1);
    }
    const int2 c =
        lane < n_cand ? s_key[par][lane] : make_int2(INT_MIN, INT_MAX);
    const int cv = __reduce_max_sync(kFullMask, c.x);
    win = __reduce_min_sync(kFullMask, c.x == cv ? c.y : INT_MAX);
    xo = s_cloud[3 * win];
    yo = s_cloud[3 * win + 1];
    zo = s_cloud[3 * win + 2];
    if (writer) o[j] = win;
  }
  // no CTA leaves while another may still write into its shared memory
  if constexpr (kCluster) cluster_barrier();
}

// A cloud of any size (the plan's ppt = 0): each point's x, y, z and
// running minimum stay in the device memory of `scratch` (B, N) and are
// read and written back every step. Thread t of CTA `rank` walks points
// rank * T + t + k * cluster * T. A CTA reduces its warps' keys in shared
// memory to one, which its warp 0 sends into every CTA of the cluster as
// fps_kernel's warps do (at most kMaxCluster keys a step); the winner's
// coordinates are then read from the cloud in device memory.
__global__ void __launch_bounds__(kStreamThreads, 1)
    fps_stream_kernel(const float* __restrict__ xyz, long long batch_stride,
                      long long row_stride, float4* __restrict__ scratch,
                      long long* __restrict__ out, int n, int npoint,
                      int cluster) {
  __shared__ int2 s_warp[2][32];           // a step's warp keys
  __shared__ int2 s_key[2][kMaxCluster];   // a step's CTA keys
  __shared__ uint64_t s_bar[2];            // a step's arrivals

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nw = blockDim.x >> 5;
  const int rank = cluster_rank();
  const int cloud = blockIdx.x / cluster;
  const float* p = xyz + cloud * batch_stride;
  float4* sc = scratch + static_cast<long long>(cloud) * n;
  long long* o = out + static_cast<long long>(cloud) * npoint;
  const int stride = cluster * static_cast<int>(blockDim.x);
  const int first = rank * static_cast<int>(blockDim.x) + t;
  for (int i = first; i < n; i += stride) {
    const float* r = p + i * row_stride;
    sc[i] = make_float4(r[0], r[1], r[2], 1e38f);
  }
  if (t == 0) {
    mbar_init(&s_bar[0], 1);
    mbar_init(&s_bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  cluster_barrier();

  float xo = p[0], yo = p[1], zo = p[2];
  const bool writer = rank == 0 && t == 0;
  if (writer) o[0] = 0;
  for (int j = 1; j < npoint; ++j) {
    // the thread's first maximum, kStreamBatch points' loads in flight
    float bv = -1.0f;
    int bi = INT_MAX;
    for (int i0 = first; i0 < n; i0 += kStreamBatch * stride) {
      float4 v[kStreamBatch];
#pragma unroll
      for (int u = 0; u < kStreamBatch; ++u) {
        const int i = i0 + u * stride;
        v[u] = i < n ? sc[i] : make_float4(0.f, 0.f, 0.f, -1.0f);
      }
#pragma unroll
      for (int u = 0; u < kStreamBatch; ++u) {
        const int i = i0 + u * stride;
        if (i < n) {
          const float m = fminf(
              v[u].w, sph3d::sum_sq3(v[u].x - xo, v[u].y - yo, v[u].z - zo));
          reinterpret_cast<float*>(sc + i)[3] = m;
          if (m > bv) {
            bv = m;
            bi = i;
          }
        }
      }
    }
    const int bits = __float_as_int(bv);
    const int wv = __reduce_max_sync(kFullMask, bits);
    const int par = j & 1;
    int win = __reduce_min_sync(kFullMask, bits == wv ? bi : INT_MAX);
    if (lane == 0) s_warp[par][warp] = make_int2(wv, win);
    __syncthreads();
    if (warp == 0) {
      // the CTA's key; lane r sends it to CTA r of the cluster
      const int2 c =
          lane < nw ? s_warp[par][lane] : make_int2(INT_MIN, INT_MAX);
      const int cv = __reduce_max_sync(kFullMask, c.x);
      const int2 key = make_int2(
          cv, __reduce_min_sync(kFullMask, c.x == cv ? c.y : INT_MAX));
      if (t == 0) mbar_expect_tx(&s_bar[par], cluster * sizeof(int2));
      if (lane < cluster) {
        st_async(at_rank(&s_key[par][rank], lane), key,
                 at_rank(&s_bar[par], lane));
      }
    }
    // the k-th use of a parity's barrier waits for its phase k
    mbar_wait(&s_bar[par], ((j - 1) >> 1) & 1);
    const int2 c =
        lane < cluster ? s_key[par][lane] : make_int2(INT_MIN, INT_MAX);
    const int cv = __reduce_max_sync(kFullMask, c.x);
    win = __reduce_min_sync(kFullMask, c.x == cv ? c.y : INT_MAX);
    const float* r = p + win * row_stride;
    xo = r[0];
    yo = r[1];
    zo = r[2];
    if (writer) o[j] = win;
  }
  // no CTA leaves while another may still write into its shared memory
  cluster_barrier();
}

// Each instance may use all the shared memory the device lends a block
// (set once a device); a cloud beyond it fails to launch.
template <int P, bool kCluster>
cudaError_t allow_smem() {
  static bool allowed[kMaxDevices] = {};
  return sph3d::allow_all_smem(fps_kernel<P, kCluster>, allowed);
}

cudaError_t allow_stream_smem() {
  static bool allowed[kMaxDevices] = {};
  return sph3d::allow_all_smem(fps_stream_kernel, allowed);
}

struct Args {
  const float* xyz;
  long long batch_stride, row_stride;
  float4* scratch;
  long long* out;
  int batch, n, npoint, cluster, threads;
  cudaStream_t stream;
};

cudaLaunchConfig_t cluster_config(int grid, int threads, int cluster,
                                  int smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int P, bool kCluster>
cudaError_t launch(const Args& a) {
  cudaError_t err = allow_smem<P, kCluster>();
  if (err != cudaSuccess) return err;
  const int cloud = kCloudBytes * a.n;
  if constexpr (!kCluster) {
    fps_kernel<P, kCluster><<<a.batch, a.threads, cloud, a.stream>>>(
        a.xyz, a.batch_stride, a.row_stride, a.out, a.n, a.npoint, 1);
  } else {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(
        a.batch * a.cluster, a.threads, a.cluster,
        cloud > kSoloSmem ? cloud : kSoloSmem, a.stream, &attr);
    err = cudaLaunchKernelEx(&cfg, fps_kernel<P, kCluster>, a.xyz,
                             a.batch_stride, a.row_stride, a.out, a.n,
                             a.npoint, a.cluster);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

cudaError_t launch_stream(const Args& a) {
  cudaError_t err = allow_stream_smem();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(a.batch * a.cluster, a.threads, a.cluster, kSoloSmem,
                     a.stream, &attr);
  err = cudaLaunchKernelEx(&cfg, fps_stream_kernel, a.xyz, a.batch_stride,
                           a.row_stride, a.scratch, a.out, a.n, a.npoint,
                           a.cluster);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool kCluster>
cudaError_t launch_mode(int ppt, const Args& a) {
  switch (ppt) {
#define SPH3D_FPS_CASE(p) \
  case p:                 \
    return launch<p, kCluster>(a);
    SPH3D_FPS_PPT(SPH3D_FPS_CASE)
#undef SPH3D_FPS_CASE
  }
  return cudaErrorInvalidValue;
}

// Every reservation above half an SM gives one CTA an SM: the count does
// not depend on N.
template <typename Kernel>
cudaError_t max_active(Kernel kernel, int cluster, int threads, int* count) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(cluster, threads, cluster, kSoloSmem, nullptr, &attr);
  return cudaOccupancyMaxActiveClusters(
      count, reinterpret_cast<const void*>(kernel), &cfg);
}

template <int P>
cudaError_t max_active(int cluster, int threads, int* count) {
  const cudaError_t err = allow_smem<P, true>();
  if (err != cudaSuccess) return err;
  return max_active(fps_kernel<P, true>, cluster, threads, count);
}

// What the kernel itself needs of a plan: whole warps; in registers
// (ppt > 0) a candidate slot a warp of the cluster and every point held,
// in device memory (ppt = 0) a cluster of 2 to kMaxCluster CTAs of at
// most kStreamThreads. A points-a-thread count that was not built, more
// threads than an instance's launch bounds, a cluster beyond the portable
// 8 CTAs or a cloud beyond the shared memory fail at launch.
bool valid_plan(int n, int cluster, int threads, int ppt) {
  const bool warps = threads >= 32 && threads % 32 == 0;
  if (ppt == 0) {
    return warps && cluster >= 2 && cluster <= kMaxCluster &&
           threads <= kStreamThreads;
  }
  return warps && cluster >= 1 && cluster * (threads / 32) <= kMaxCands &&
         static_cast<long long>(cluster) * threads * ppt >= n;
}

}  // namespace

// xyz: (B, N, C >= 3) f32 with the given strides (elements); out: (B,
// npoint) int64. The plan: `cluster` CTAs a cloud (1: one block),
// `threads` a CTA, `ppt` points a thread (0: the cloud in device memory,
// `scratch` (B, N) float4, 16-byte aligned; else unused).
extern "C" int sph3d_fps_launch(const float* xyz, long long batch_stride,
                                long long row_stride, float* scratch,
                                long long* out, int batch, int n, int npoint,
                                int cluster, int threads, int ppt,
                                void* stream) {
  if (!valid_plan(n, cluster, threads, ppt) ||
      (ppt == 0 && (scratch == nullptr ||
                    reinterpret_cast<uintptr_t>(scratch) % 16 != 0))) {
    return cudaErrorInvalidValue;
  }
  const Args a{xyz,   batch_stride, row_stride,
               reinterpret_cast<float4*>(scratch), out, batch, n, npoint,
               cluster, threads, static_cast<cudaStream_t>(stream)};
  if (ppt == 0) return launch_stream(a);
  if (cluster > 1) return launch_mode<true>(ppt, a);
  return launch_mode<false>(ppt, a);
}

// How many clusters of `cluster` CTAs of `threads` threads (one CTA an SM)
// the current device runs at once.
extern "C" int sph3d_fps_max_active_clusters(int cluster, int threads,
                                             int ppt, int* count) {
  if (cluster < 2 || !valid_plan(0, cluster, threads, ppt)) {
    return cudaErrorInvalidValue;
  }
  if (ppt == 0) {
    const cudaError_t err = allow_stream_smem();
    if (err != cudaSuccess) return err;
    return max_active(fps_stream_kernel, cluster, threads, count);
  }
  switch (ppt) {
#define SPH3D_FPS_CASE(p) \
  case p:                 \
    return max_active<p>(cluster, threads, count);
    SPH3D_FPS_PPT(SPH3D_FPS_CASE)
#undef SPH3D_FPS_CASE
  }
  return cudaErrorInvalidValue;
}

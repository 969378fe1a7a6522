// K1: farthest-point sampling, one thread block per cloud.
//
// Replaces the TPU kernel sph3d_gcn_tpu/ops/pallas/fps_kernel.py:44
// (_fps_kernel, reached via farthest_point_sample_pallas). Plain PyTorch
// twin: sph3d_gcn_torch/ops/sample.py::farthest_point_sample_plain.
//
// Semantics: seed index 0, min-distance buffer initialised to 1e38,
// running minimum of squared distances (dx*dx + dy*dy) + dz*dz, argmax
// with ties to the lowest index. Output (B, npoint) int32.
//
// What bounds it on the H100: latency, not bytes or FLOPs. The npoint-1
// greedy steps are sequential; each is an O(N) distance update plus a
// block-wide argmax (warp shuffles, then one warp over the per-warp
// winners) and two barriers. Coordinates and min-distances of the cloud
// (16 bytes a point, 160 KB at N = 10000) stay in dynamic shared memory,
// so the loop touches device memory only to write the output. One block
// per cloud occupies B of the 132 SMs; splitting a cloud across a thread
// block cluster (distributed shared memory) is later work.
//
// Numerics: the distance is written with __fmul_rn/__fadd_rn (no FMA
// contraction), so the indices equal the plain version's bit for bit.
#include "common.cuh"

namespace {

using sph3d::kFullMask;

constexpr int kThreads = 1024;

__device__ __forceinline__ void take_max(float& bv, int& bi, float ov,
                                         int oi) {
  if (ov > bv || (ov == bv && oi < bi)) {
    bv = ov;
    bi = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& bv, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(kFullMask, bv, off);
    const int oi = __shfl_down_sync(kFullMask, bi, off);
    take_max(bv, bi, ov, oi);
  }
}

__global__ void __launch_bounds__(kThreads)
    fps_kernel(const float* __restrict__ xyz, int* __restrict__ out, int n,
               int npoint) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + n;
  float* sz = sy + n;
  float* md = sz + n;
  __shared__ float red_v[kThreads / 32];
  __shared__ int red_i[kThreads / 32];
  __shared__ int s_best;

  const float* p = xyz + static_cast<size_t>(blockIdx.x) * n * 3;
  int* o = out + static_cast<size_t>(blockIdx.x) * npoint;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    sx[i] = p[3 * i];
    sy[i] = p[3 * i + 1];
    sz[i] = p[3 * i + 2];
    md[i] = 1e38f;
  }
  if (threadIdx.x == 0) o[0] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int old = 0;
  for (int j = 1; j < npoint; ++j) {
    const float xo = sx[old], yo = sy[old], zo = sz[old];
    float bv = -1.0f;  // min-distances are >= 0: any point beats this
    int bi = n;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const float d = sph3d::sum_sq3(sx[i] - xo, sy[i] - yo, sz[i] - zo);
      const float m = fminf(md[i], d);
      md[i] = m;
      if (m > bv) {  // i increases: strict > keeps the lowest index
        bv = m;
        bi = i;
      }
    }
    warp_argmax(bv, bi);
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < nwarps ? red_v[lane] : -1.0f;
      bi = lane < nwarps ? red_i[lane] : n;
      warp_argmax(bv, bi);
      if (lane == 0) {
        s_best = bi;
        o[j] = bi;
      }
    }
    __syncthreads();
    old = s_best;
  }
}

}  // namespace

extern "C" int sph3d_fps_launch(const float* xyz, int* out, int batch, int n,
                                int npoint, void* stream) {
  const int smem = static_cast<int>(sizeof(float) * 4 * n);
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fps_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xyz, out, n, npoint);
  return cudaGetLastError();
}

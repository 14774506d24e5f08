// Cluster-traversal nearest hit for Hopper (sm_90a), bound with ctypes.
//
// Replaces pathtracer_tpu/ops/pallas/cluster_kernel.py::_kernel.  For each
// ray of a flat batch it finds the nearest hit (t, packed row) against a
// ClusterSet (clusters.py): for each cluster in the ray's block's visit
// order, the slab test of the cluster's AABB (tmax >= 0, tmin <= tmax,
// tmin < best_t), then Möller–Trumbore over the cluster's packed
// [v1, e1, e2] rows with a strict t < best_t.
//
// What bounds it on this card: fp32 issue (every ray tests every cluster
// box it reaches, ~20 operations each, and ~40 per triangle of an entered
// cluster, one IEEE division each) and divergence between the rays of a
// warp, which pay for the union of the clusters any of them enters.
// Design: one thread per ray; a block of 256 rays plays the part of the TPU
// tile, and the wrapper orders the clusters front to back for each block
// (and, on request, sorts the rays by Morton cell and direction octant
// first, so a block's rays are coherent).  Cluster bounds, starts and
// counts go to shared memory when they fit (dynamic, with the opt-in above
// 48 KB); triangle rows are read from global memory through L1/L2.
//
// Rounding: IEEE 1.0f / d and 1.0f / a, and the library builds with
// --fmad=false, so t is the plain version's (ops/intersect.py) bit for bit.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBoxCols = 8;
constexpr int kTriCols = 9;

template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
cluster_kernel(const float* __restrict__ rays, const float* __restrict__ tris,
               const float* __restrict__ bounds,
               const int* __restrict__ start, const int* __restrict__ count,
               const int* __restrict__ order, float* __restrict__ t_out,
               int* __restrict__ slot_out, int n_rays, int n_clusters) {
  extern __shared__ float4 smem[];
  const float4* box4 = reinterpret_cast<const float4*>(bounds);
  const int* s_start = start;
  const int* s_count = count;
  if (kSmem) {
    float4* sb = smem;
    int* ss = reinterpret_cast<int*>(smem + 2 * n_clusters);
    int* sc = ss + n_clusters;
    for (int i = threadIdx.x; i < 2 * n_clusters; i += blockDim.x)
      sb[i] = box4[i];
    for (int i = threadIdx.x; i < n_clusters; i += blockDim.x) {
      ss[i] = start[i];
      sc[i] = count[i];
    }
    __syncthreads();
    box4 = sb;
    s_start = ss;
    s_count = sc;
  }

  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const float ox = rays[r], oy = rays[n_rays + r], oz = rays[2 * n_rays + r];
  const float dx = rays[3 * n_rays + r], dy = rays[4 * n_rays + r],
              dz = rays[5 * n_rays + r];
  // IEEE division: d == 0 must give inf for the slab test.
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;

  float best_t = ptk::kInf;
  int best = -1;
  const int* visit = order + static_cast<size_t>(blockIdx.x) * n_clusters;
  for (int k = 0; k < n_clusters; ++k) {
    const int c = __ldg(visit + k);
    const float4 b0 = box4[2 * c];
    const float4 b1 = box4[2 * c + 1];
    if (!ptk::slab_hit(b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, ox, oy, oz, ix,
                       iy, iz, best_t))
      continue;
    const int s0 = s_start[c];
    const int s1 = s0 + s_count[c];
    for (int i = s0; i < s1; ++i) {
      const float* p = tris + static_cast<size_t>(i) * kTriCols;
      const float t = ptk::mt_hit(__ldg(p), __ldg(p + 1), __ldg(p + 2),
                                  __ldg(p + 3), __ldg(p + 4), __ldg(p + 5),
                                  __ldg(p + 6), __ldg(p + 7), __ldg(p + 8),
                                  ox, oy, oz, dx, dy, dz);
      if (t < best_t) {
        best_t = t;
        best = i;
      }
    }
  }
  t_out[r] = best_t;
  slot_out[r] = best;
}

}  // namespace

// Nearest hits of `n_rays` rays (planes (6, n_rays): ox, oy, oz, dx, dy, dz;
// n_rays a multiple of 256) against `n_clusters` clusters: bounds (C, 8),
// start and count (C,), packed rows (P, 9), and order (n_rays / 256, C), the
// visit order of each block of 256 rays.  Writes t (n_rays,) and the packed
// row (n_rays,), -1 on a miss.  Launches on `stream` of `device` and
// returns cudaGetLastError() as an int: 0 when the launch was accepted.
extern "C" int pt_cluster_intersect(const float* rays, const float* tris,
                                    const float* bounds, const int* start,
                                    const int* count, const int* order,
                                    float* t_out, int* slot_out, int n_rays,
                                    int n_clusters, int device,
                                    void* stream) {
  if (n_rays < kThreads || n_rays % kThreads != 0 || n_clusters < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(n_clusters) *
                      (kBoxCols * sizeof(float) + 2 * sizeof(int));
  const bool use_smem =
      ptk::prepare_smem(cluster_kernel<true>, smem, device) == cudaSuccess;
  cudaGetLastError();  // a refused opt-in is not an error: use global memory
  const int blocks = n_rays / kThreads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (use_smem) {
    cluster_kernel<true><<<blocks, kThreads, smem, st>>>(
        rays, tris, bounds, start, count, order, t_out, slot_out, n_rays,
        n_clusters);
  } else {
    cluster_kernel<false><<<blocks, kThreads, 0, st>>>(
        rays, tris, bounds, start, count, order, t_out, slot_out, n_rays,
        n_clusters);
  }
  return static_cast<int>(cudaGetLastError());
}

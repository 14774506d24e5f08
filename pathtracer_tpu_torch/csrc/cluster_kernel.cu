// Cluster-traversal nearest hit for Hopper (sm_90a), bound with ctypes.
//
// Replaces pathtracer_tpu/ops/pallas/cluster_kernel.py::_kernel.  For each
// ray of a flat batch it finds the nearest hit (t, packed row) against a
// ClusterSet (clusters.py): a walk of the box tree over the clusters
// (ptk::walk_tree: the top of the SAH BVH the set was cut from, both
// children's boxes in one 64-byte node, near child first), then
// Möller–Trumbore over the packed [v1, e1, e2] rows of every cluster whose
// box it enters.  A row replaces the best on a nearer t, or on an equal t
// with a lower packed row, and a box opens on tmin <= best_t, so the hit is
// the plain version's argmin whatever the visit order.
//
// What bounds it on this card: fp32 issue (~20 operations a box, ~40 a
// triangle of an entered cluster, one IEEE division each) and divergence
// between the rays of a warp, which pay for the union of their walks.
// Design: one thread per ray, 256 a block; the walk opens about two dozen
// nodes where a loop over every cluster box tested 225 (sphere9812) to
// 2,310 (garden105708) boxes a ray.  The tree's nodes and the clusters'
// starts and counts go to shared memory when they leave room for two blocks
// an SM, else they are read through the read-only cache; each thread's
// stack slice (8 B an entry, the tree's depth in entries) is in shared
// memory; triangle rows are read from global memory through L1/L2.
//
// Rounding: IEEE 1.0f / d and 1.0f / a, and the library builds with
// --fmad=false, so t is the plain version's (ops/intersect.py) bit for bit.

#include <cstdint>

#define PTK_KERNEL "cluster_kernel"
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTriCols = 9;

// kSmem: the nodes, starts and counts in shared memory, else read from
// global memory through __ldg.
template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
cluster_kernel(const float* __restrict__ rays, const float* __restrict__ tris,
               const float* __restrict__ tree,
               const int* __restrict__ start, const int* __restrict__ count,
               float* __restrict__ t_out, int* __restrict__ slot_out,
               int n_rays, int n_clusters, int tree_depth, int n_tri_rows) {
  // Shared memory: each thread's stack slice (entry k of thread x at
  // k * kThreads + x), then, with kSmem, the nodes, starts and counts.
  extern __shared__ float4 smem[];
  const int n_nodes = n_clusters - 1;
  float2* stack = reinterpret_cast<float2*>(smem) + threadIdx.x;
  const float4* nodes = reinterpret_cast<const float4*>(tree);
  const int* s_start = start;
  const int* s_count = count;
  if (kSmem) {
    float4* sn = reinterpret_cast<float4*>(reinterpret_cast<float2*>(smem) +
                                           tree_depth * kThreads);
    int* ss = reinterpret_cast<int*>(sn + 4 * n_nodes);
    int* sc = ss + n_clusters;
    for (int i = threadIdx.x; i < 4 * n_nodes; i += blockDim.x)
      sn[PTK_IX(sn, i, 4 * n_nodes)] = nodes[PTK_IX(nodes, i, 4 * n_nodes)];
    for (int i = threadIdx.x; i < n_clusters; i += blockDim.x) {
      ss[PTK_IX(ss, i, n_clusters)] = start[PTK_IX(start, i, n_clusters)];
      sc[PTK_IX(sc, i, n_clusters)] = count[PTK_IX(count, i, n_clusters)];
    }
    __syncthreads();
    nodes = sn;
    s_start = ss;
    s_count = sc;
  }

  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const float ox = rays[PTK_IX(rays, r, 6 * n_rays)];
  const float oy = rays[PTK_IX(rays, n_rays + r, 6 * n_rays)];
  const float oz = rays[PTK_IX(rays, 2 * n_rays + r, 6 * n_rays)];
  const float dx = rays[PTK_IX(rays, 3 * n_rays + r, 6 * n_rays)];
  const float dy = rays[PTK_IX(rays, 4 * n_rays + r, 6 * n_rays)];
  const float dz = rays[PTK_IX(rays, 5 * n_rays + r, 6 * n_rays)];
  // IEEE division: d == 0 must give inf for the slab test.
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;

  float best_t = ptk::kInf;
  int best = -1;
  ptk::walk_tree<!kSmem>(
      nodes, n_nodes, stack, kThreads, tree_depth, ox, oy, oz, ix, iy, iz,
      best_t, [&](int c) {
        const int cc = PTK_IX(start, c, n_clusters);
        const int s0 = kSmem ? s_start[cc] : __ldg(start + cc);
        const int s1 = s0 + (kSmem ? s_count[cc] : __ldg(count + cc));
        for (int i = s0; i < s1; ++i) {
          const float* p =
              tris + static_cast<size_t>(PTK_IX(tris, i, n_tri_rows)) *
                         kTriCols;
          const float t = ptk::mt_hit(
              __ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3),
              __ldg(p + 4), __ldg(p + 5), __ldg(p + 6), __ldg(p + 7),
              __ldg(p + 8), ox, oy, oz, dx, dy, dz);
          if (ptk::nearer(t, i, best_t, best)) {
            best_t = t;
            best = i;
          }
        }
      });
  t_out[PTK_IX(t_out, r, n_rays)] = best_t;
  slot_out[PTK_IX(slot_out, r, n_rays)] = best;
}

}  // namespace

// Nearest hits of `n_rays` rays (planes (6, n_rays): ox, oy, oz, dx, dy, dz;
// n_rays a multiple of 256) against `n_clusters` clusters: `tree`, the
// (n_clusters - 1, 16) box tree over the clusters, of depth `tree_depth` (at
// most kTreeStack; 0 for one cluster), start and count (C,), packed rows
// (n_tri_rows, 9; the row count only the checked build reads, PTK_IX).
// Writes t (n_rays,) and the packed row (n_rays,), -1 on a miss.  Launches
// on `stream` of `device` and returns cudaGetLastError() as an int: 0 when
// the launch was accepted.
extern "C" int pt_cluster_intersect(const float* rays, const float* tris,
                                    const float* tree, const int* start,
                                    const int* count, float* t_out,
                                    int* slot_out, int n_rays,
                                    int n_clusters, int tree_depth,
                                    int n_tri_rows, int device,
                                    void* stream) {
  if (n_rays < kThreads || n_rays % kThreads != 0 || n_clusters < 1 ||
      n_tri_rows < 1 || tree_depth < 0 || tree_depth > ptk::kTreeStack ||
      (n_clusters == 1) != (tree_depth == 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t stack = static_cast<size_t>(tree_depth) * kThreads *
                       sizeof(float2);
  const size_t tables = static_cast<size_t>(n_clusters - 1) * 4 *
                            sizeof(float4) +
                        static_cast<size_t>(n_clusters) * 2 * sizeof(int);
  // The tables go to shared memory when two blocks of it fit an SM (1 KB of
  // each block's shared memory is the system's).
  int per_sm = 0;
  err = cudaDeviceGetAttribute(
      &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool use_smem =
      2 * (stack + tables + 1024) <= static_cast<size_t>(per_sm) &&
      ptk::prepare_smem(cluster_kernel<true>, stack + tables, device) ==
          cudaSuccess;
  cudaGetLastError();  // a refused opt-in is not an error: use global memory
  const int blocks = n_rays / kThreads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (use_smem) {
    cluster_kernel<true><<<blocks, kThreads, stack + tables, st>>>(
        rays, tris, tree, start, count, t_out, slot_out, n_rays, n_clusters,
        tree_depth, n_tri_rows);
  } else {
    err = ptk::prepare_smem(cluster_kernel<false>, stack, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    cluster_kernel<false><<<blocks, kThreads, stack, st>>>(
        rays, tris, tree, start, count, t_out, slot_out, n_rays, n_clusters,
        tree_depth, n_tri_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

// Dense nearest hit for Hopper (sm_90a), bound with ctypes.
//
// Replaces no TPU kernel.  On the TPU, XLA fused the chain of
// ops/intersect.py::intersect_brute (Möller–Trumbore of every ray against
// every triangle, then the first index of the minimum) into one pass; eager
// PyTorch runs it as ~66 kernels over (rays, T) and (rays, T, 3)
// temporaries, which made the brute intersection of the differentiable
// path (diff._intersect_brute_chunked: a recovery step's ten calls of
// 3,145,728 rays against 32 rows) most of the step's device time.  This
// kernel is that function in one launch: for each ray of a flat batch the
// nearest hit (t, triangle row) against the rows [v1, e1, e2].
//
// What bounds it on this card: fp32 issue, MT_OPS (46) operations and one
// IEEE division a row test, every row for every ray; the only device-memory
// traffic is 24 bytes of ray read and 8 bytes of hit written a ray.  Design:
// one thread per ray, kThreads a block; the rows go through shared memory
// in tiles of kTileRows, each padded to 16 bytes a vector so that a test
// reads its row as three LDS.128 broadcasts (every lane of a warp reads the
// same row).  Any row count takes the same kernel, and the memory is the
// rays and hits alone, so a batch of any size is one launch.
//
// Rounding: ptk::mt_hit is intersect_brute's operation order and the
// library builds with --fmad=false.  The reciprocal is the IEEE 1.0f / a:
// rcp_in_range needs |a| < 2^126, and |a| <= |e1| |e2| |d| has no bound for
// directions of any length without a pass over the rays.  Tie rule: a row
// replaces the best on ptk::nearer (a strict t < best_t, rows in order), so
// the first row of the minimum is kept, argmin's index.  best_t starts at
// +inf, not kInf: t is the minimum of every row's value as amin gives it
// (kInf for a row that fails), and the ray misses (-1) when that minimum is
// not below kInf, as intersect_brute rules.  So (t, row) is intersect_brute's
// bit for bit.

#include <cstdint>

#define PTK_KERNEL "brute_kernel"
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 256;   // 12 KB of shared memory a block

__global__ void __launch_bounds__(kThreads)
brute_kernel(const float* __restrict__ ray_o, const float* __restrict__ ray_d,
             const float* __restrict__ v1, const float* __restrict__ e1,
             const float* __restrict__ e2, float* __restrict__ t_out,
             int* __restrict__ tid_out, long long n_rays, int n_rows) {
  // Row j of a tile: [v1, 0 | e1, 0 | e2, 0] at float4s 3j, 3j + 1, 3j + 2
  // (the fourth lanes are never read).
  __shared__ float4 rows[3 * kTileRows];
  float* flat = reinterpret_cast<float*>(rows);

  const long long r =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const bool live = r < n_rays;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  if (live) {
    const long long n = 3 * n_rays;
    ox = ray_o[PTK_IX(ray_o, 3 * r, n)];
    oy = ray_o[PTK_IX(ray_o, 3 * r + 1, n)];
    oz = ray_o[PTK_IX(ray_o, 3 * r + 2, n)];
    dx = ray_d[PTK_IX(ray_d, 3 * r, n)];
    dy = ray_d[PTK_IX(ray_d, 3 * r + 1, n)];
    dz = ray_d[PTK_IX(ray_d, 3 * r + 2, n)];
  }

  float best_t = __int_as_float(0x7f800000);   // +inf
  int best = -1;
  for (int base = 0; base < n_rows; base += kTileRows) {
    const int n = min(kTileRows, n_rows - base);
    __syncthreads();   // every thread is done with the last tile
    // Element i of the tile's (n, 3) slice of each array goes to column
    // i % 3 of its vector in row i / 3: consecutive threads read
    // consecutive floats.
    for (int i = threadIdx.x; i < 3 * n; i += kThreads) {
      const int g = PTK_IX(v1, 3 * base + i, 3 * n_rows);
      const int s = 12 * (i / 3) + i % 3;
      flat[PTK_IX(flat, s, 12 * kTileRows)] = v1[g];
      flat[PTK_IX(flat, s + 4, 12 * kTileRows)] = e1[g];
      flat[PTK_IX(flat, s + 8, 12 * kTileRows)] = e2[g];
    }
    __syncthreads();
    if (live) {
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const float4 a = rows[PTK_IX(rows, 3 * j, 3 * kTileRows)];
        const float4 b = rows[PTK_IX(rows, 3 * j + 1, 3 * kTileRows)];
        const float4 c = rows[PTK_IX(rows, 3 * j + 2, 3 * kTileRows)];
        const float t = ptk::mt_hit(a.x, a.y, a.z, b.x, b.y, b.z, c.x, c.y,
                                    c.z, ox, oy, oz, dx, dy, dz);
        if (ptk::nearer(t, base + j, best_t, best)) {
          best_t = t;
          best = base + j;
        }
      }
    }
  }
  if (live) {
    t_out[PTK_IX(t_out, r, n_rays)] = best_t;
    tid_out[PTK_IX(tid_out, r, n_rays)] = best_t < ptk::kInf ? best : -1;
  }
}

}  // namespace

// Nearest hits of `n_rays` rays (ray_o, ray_d: (n_rays, 3)) against
// `n_rows` rows (v1, e1 = v2 - v1, e2 = v3 - v1: (n_rows, 3) each, every
// row tested, degenerate ones failing |a| >= EPS).  Writes t (n_rays,),
// kInf on a miss, and the row (n_rays,), -1 on a miss.  Launches on `stream`
// of `device` and returns cudaGetLastError() as an int: 0 when the launch
// was accepted.
extern "C" int pt_brute_intersect(const float* ray_o, const float* ray_d,
                                  const float* v1, const float* e1,
                                  const float* e2, float* t_out,
                                  int* tid_out, long long n_rays, int n_rows,
                                  int device, void* stream) {
  const long long blocks = (n_rays + kThreads - 1) / kThreads;
  if (n_rays < 1 || n_rows < 1 || blocks > 0x7fffffffLL ||
      3LL * n_rows > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  brute_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      ray_o, ray_d, v1, e1, e2, t_out, tid_out, n_rays, n_rows);
  return static_cast<int>(cudaGetLastError());
}

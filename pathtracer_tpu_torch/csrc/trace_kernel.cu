// Path-tracing megakernel for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces pathtracer_tpu/ops/pallas/trace_kernel.py::_kernel, both of its
// intersection loops: "mt" (intersect_mt) and "plucker" (intersect_plucker).
// For each pixel of a film band starting at row h0 it adds the radiance SUM
// over the samples [s0, s0 + spp) into `film`, (band_h, width, 3) float32.
// The math is that of the plain PyTorch path (ops/trace.py::sample_radiance
// over ops/intersect.py::intersect_brute or intersect_plucker), operation
// for operation:
//   * RNG: seed = hash(hash(pix_seed ^ sidx * GOLDEN) ^ seed_mix) with
//     pix_seed = h + w * res_y + 1; two jitter draws; per bounce u, v and,
//     when the scene has a specular material, all 3 * SPECULAR_TRIES cube
//     draws (always all of them, so the stream stays aligned).
//   * Every triangle row in index order with a strict t < best_t: the
//     first-index tie rule of the plain path's argmin.
//   * IEEE division and sqrtf; the library builds with --fmad=false so no
//     multiply-add is contracted and every rounding matches the unfused
//     elementwise ops of the plain path.  Films are bit-identical to the
//     plain version of the same loop on the card.
//
// What bounds it on this card: fp32 issue in the triangle loop.  Per live
// ray segment every row is tested: Möller–Trumbore is 46 floating-point
// operations (one IEEE division) per test, the Plücker form 38 (a 3-term
// dot, the division, two 6-term dots, a 4-term sum, four more).  The
// only device-memory traffic is one read-modify-write of the film per pixel
// per launch.  What the design does about it:
//   * Path regeneration from a warp pool.  The sample and bounce loops
//     are one loop over segments, and the paths of a warp's 32 pixels over
//     a window of kWindow samples are one pool: a lane whose path ends
//     (miss, light, or depth) stores its radiance in the path's slot in
//     shared memory and takes the next path of the pool in the same
//     iteration, whichever pixel it belongs to.  The lanes stay busy until
//     the pool runs dry, so a warp pays about the mean path length of its
//     pool, not the longest path of every sample (a sample loop around a
//     bounce loop) nor the longest per-pixel total (regeneration per
//     thread).  Each pixel's lane then sums its slots in sample order and
//     each (pixel, sample) stream is derived afresh, so nothing changes a
//     bit.
//   * Rows padded to 16 bytes: "mt" [v1, 0 | e1, 0 | e2, 0] is three
//     LDS.128 broadcasts per test, "plucker" reads five of its seven
//     float4s (below); rows padded to a multiple of kUnroll with zero rows,
//     which fail |a| >= EPS.
//   * kUnroll tests are independent of each other and of best_t, so their
//     arithmetic overlaps; their results are applied in row order.
//   * Camera constants are read from global memory (a broadcast through
//     L1) when a sample starts, not held in registers.
//   * The IEEE reciprocal 1/a without the range check, slow-path call and
//     branch of the compiler's expansion (ptk::rcp_in_range: the same bits
//     wherever the test can accept), about six instructions of each test.
// Plücker rows, seven float4 (cols of trace_kernel._triangle_params_plucker
// in brackets):
//   0: Na.x Na.y Na.z N.x      1: N.y N.z e2.x e2.y    2: e2.z me1.x me1.y me1.z
//   3: kp.x kp.y kp.z nv       4: kq.x kq.y kq.z 0     (a later bounce)
//   5: pc.x pc.y pc.z r0       6: qc.x qc.y qc.z 0     (bounce 0)
// Every test computes p = e2.(c) + P.d, q = me1.(c) + Q.d, r = N.(o) + R in
// the plain version's left-to-right order.  A lane at a later bounce uses
// its moment c = o x d, its origin, and rows 3-4; a lane at bounce 0 uses
// c = 0, o = 0 and rows 5-6, which is the plain version's bounce-0 collapse
// (p = pc.d, q = qc.d, r = r0) up to the sign of an exact zero, which no
// test reads.  With regeneration the lanes of a warp sit at different
// bounces, so one form with a per-lane row offset serves them all.
// FMA contraction and an approximate reciprocal would each be faster and
// flip near-tie hits; both are left out.
// Measured on an H100 80GB HBM3 at 700 W (PERF.md): 5.0-5.2 ms per 16-spp
// launch of the 1024^2 Cornell box ("plucker"; "mt" 5.4-5.8 ms) against an
// operation bound of 0.97 ms (the Plücker test's operations: 20 at bounce
// 0, 38 later); the triangle loop is 55.25 instructions a Plücker test in
// the SASS (61 for "mt"), 3.1 ms of issue slots alone.
// What limits it beyond that: the serial path start and shading of each
// iteration, and 80 registers (24 warps an SM).

#include <climits>
#include <cstdint>

#define PTK_KERNEL "trace_kernel"
#include "common.cuh"

namespace {

using ptk::kEps;
using ptk::kInf;

// The last three were chosen by timing their neighbours on the card
// (PERF.md): none of 2 or 8 rows tested together, budgets of 6 to 8
// blocks, or pools of 8 or 32 samples was faster on both scenes.
constexpr int kMaxRows = 512;
constexpr int kTabCols = 8;
constexpr int kThreads = 128;
constexpr int kMinBlocks = 4;   // 128 registers a thread at most
constexpr int kUnroll = 4;      // rows tested together
constexpr int kWindow = 16;     // samples per warp pool
constexpr int kLoopMt = 0;
constexpr int kLoopPlucker = 1;

template <int kLoop>
struct RowWidth {
  static constexpr int value = kLoop == kLoopPlucker ? 7 : 3;  // float4s
};

// Möller–Trumbore against the row [v1, 0 | e1, 0 | e2, 0]; kInf on a miss.
__device__ __forceinline__ float test_mt(const float4* r, float ox, float oy,
                                         float oz, float dx, float dy,
                                         float dz) {
  const float4 v1 = r[0], e1 = r[1], e2 = r[2];
  return ptk::mt_hit<true>(v1.x, v1.y, v1.z, e1.x, e1.y, e1.z, e2.x, e2.y,
                           e2.z, ox, oy, oz, dx, dy, dz);
}

// Plücker test against the row r with its per-lane coefficients pq (row 3
// or 5 of r); (ox, oy, oz) and (cx, cy, cz) are zero at bounce 0.  kInf on
// a miss.  u <= 1 follows from v >= 0 and u + v <= 1.  Both tests take
// the reciprocal by ptk::rcp_in_range: the wrapper refuses rows whose
// determinant could reach 2^125, and |a| < EPS is rejected.
__device__ __forceinline__ float test_plucker(const float4* r,
                                              const float4* pq, float ox,
                                              float oy, float oz, float cx,
                                              float cy, float cz, float dx,
                                              float dy, float dz) {
  const float4 a0 = r[0], a1 = r[1], a2 = r[2], b0 = pq[0], b1 = pq[1];
  const float a = a0.x * dx + a0.y * dy + a0.z * dz;
  const float f = ptk::rcp_in_range(a);
  const float p = a1.z * cx + a1.w * cy + a2.x * cz + b0.x * dx + b0.y * dy +
                  b0.z * dz;
  const float q = a2.y * cx + a2.z * cy + a2.w * cz + b1.x * dx + b1.y * dy +
                  b1.z * dz;
  const float rr = a0.w * ox + a1.x * oy + a1.y * oz + b0.w;
  const float t = f * rr;
  const float u = f * p;
  const float v = f * q;
  const bool ok = fabsf(a) >= kEps && u >= 0.0f && v >= 0.0f &&
                  u + v <= 1.0f && t > 0.0f;
  return ok ? t : kInf;
}

template <bool kHasSpecular, int kLoop>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
trace_kernel(const float4* __restrict__ rows, const float* __restrict__ tab,
             const float* __restrict__ cam, float* __restrict__ film,
             int n_rows, int n_tris, int width, int band_h, int res_y, int h0,
             uint32_t s0, int spp, int depth, uint32_t seed_mix) {
  constexpr int kW = RowWidth<kLoop>::value;
  extern __shared__ float4 smem[];
  float4* s_rows = smem;
  float* s_tab = reinterpret_cast<float*>(smem + n_rows * kW);
  for (int i = threadIdx.x; i < n_rows * kW; i += blockDim.x)
    s_rows[PTK_IX(s_rows, i, n_rows * kW)] =
        rows[PTK_IX(rows, i, n_rows * kW)];
  for (int i = threadIdx.x; i < n_tris * kTabCols; i += blockDim.x)
    s_tab[PTK_IX(s_tab, i, n_tris * kTabCols)] =
        tab[PTK_IX(tab, i, n_tris * kTabCols)];
  __syncthreads();

  // The warp's pool: its first n_valid pixels (a prefix: the last warp of
  // the film may be short) times a window of kWindow samples.  Item i is
  // pixel lane i % n_valid, sample i / n_valid of the window; a lane that
  // finishes a path takes the next item, so all 32 lanes work until the
  // window's items run out.  Each path's radiance goes to its slot in
  // shared memory, and each pixel's own lane sums its slots in sample
  // order, as the plain version sums its samples.
  const int lane = threadIdx.x & 31;
  const int warp_pix0 = blockIdx.x * blockDim.x + (threadIdx.x & ~31);
  const int n_valid = min(32, width * band_h - warp_pix0);
  if (n_valid <= 0) return;  // the whole warp: no pixel of the band
  float* s_slot =
      s_tab + n_tris * kTabCols +
      static_cast<size_t>(PTK_IX(s_slot, threadIdx.x & ~31, kThreads)) *
          kWindow * 3;
  const int n_samples = depth > 0 ? spp : 0;

  // Path state.  cam: [pos(3), right(3), up(3), distance * forward(3),
  // cell, v_res.x / 2, v_res.y / 2, pixel_offset].
  uint32_t seed = 0;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  float thr_r = 1.0f, thr_g = 1.0f, thr_b = 1.0f;
  int b = 0;     // bounce of the current segment
  int slot = 0;  // the path's slot: (pixel lane * kWindow + sample) * 3
  auto start_path = [&](int item, int w0) {
    const int pl = item % n_valid;
    const int k = item / n_valid;
    const int pix = warp_pix0 + pl;
    const int w = pix % width;
    const int h = pix / width + h0;
    const uint32_t pix_seed = static_cast<uint32_t>(h) +
                              static_cast<uint32_t>(w) *
                                  static_cast<uint32_t>(res_y) +
                              1u;
    const uint32_t sidx = s0 + static_cast<uint32_t>(w0 + k);
    seed = ptk::hash_u32(pix_seed ^ (sidx * ptk::kGolden));
    seed = ptk::hash_u32(seed ^ seed_mix);
    const float j1 = ptk::rand01(seed);
    const float j2 = ptk::rand01(seed);
    const float pix_off = __ldg(cam + 15);
    const float cell = __ldg(cam + 12);
    const float x =
        (static_cast<float>(w) + pix_off + j1) * cell - __ldg(cam + 13);
    const float y =
        (static_cast<float>(h) + pix_off + j2) * cell - __ldg(cam + 14);
    dx = x * __ldg(cam + 3) + y * __ldg(cam + 6) + __ldg(cam + 9);
    dy = x * __ldg(cam + 4) + y * __ldg(cam + 7) + __ldg(cam + 10);
    dz = x * __ldg(cam + 5) + y * __ldg(cam + 8) + __ldg(cam + 11);
    const float dlen = sqrtf(dx * dx + dy * dy + dz * dz);
    dx = dx / dlen;
    dy = dy / dlen;
    dz = dz / dlen;
    ox = __ldg(cam + 0);
    oy = __ldg(cam + 1);
    oz = __ldg(cam + 2);
    thr_r = thr_g = thr_b = 1.0f;
    b = 0;
    slot = PTK_IX(s_slot, pl * kWindow + k, 32 * kWindow) * 3;
  };

  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  const unsigned lanes_below = (1u << lane) - 1u;
  for (int w0 = 0; w0 < n_samples; w0 += kWindow) {
    const int n_items = n_valid * min(kWindow, n_samples - w0);
    int next = 0;        // items handed out, the same in every lane
    bool busy = false;   // this lane holds a path
    while (true) {
      const unsigned idle = __ballot_sync(0xFFFFFFFFu, !busy);
      const int item = next + __popc(idle & lanes_below);
      next += __popc(idle);
      if (!busy && item < n_items) {
        start_path(item, w0);
        busy = true;
      }
      if (!__any_sync(0xFFFFFFFFu, busy)) break;
      if (!busy) continue;
      // Nearest hit over all rows.
      float best_t = kInf;
      int best = -1;
      if (kLoop == kLoopPlucker) {
        const bool primary = b == 0;
        const float tx = primary ? 0.0f : ox;
        const float ty = primary ? 0.0f : oy;
        const float tz = primary ? 0.0f : oz;
        const float cx = primary ? 0.0f : oy * dz - oz * dy;
        const float cy = primary ? 0.0f : oz * dx - ox * dz;
        const float cz = primary ? 0.0f : ox * dy - oy * dx;
        const int sel = primary ? 5 : 3;
#pragma unroll 1
        for (int k = 0; k < n_rows; k += kUnroll) {
          float t[kUnroll];
#pragma unroll
          for (int i = 0; i < kUnroll; ++i) {
            const float4* r = s_rows + PTK_IX(s_rows, k + i, n_rows) * kW;
            t[i] = test_plucker(r, r + sel, tx, ty, tz, cx, cy, cz, dx, dy,
                                dz);
          }
#pragma unroll
          for (int i = 0; i < kUnroll; ++i) {
            if (t[i] < best_t) {
              best_t = t[i];
              best = k + i;
            }
          }
        }
      } else {
#pragma unroll 1
        for (int k = 0; k < n_rows; k += kUnroll) {
          float t[kUnroll];
#pragma unroll
          for (int i = 0; i < kUnroll; ++i)
            t[i] = test_mt(s_rows + PTK_IX(s_rows, k + i, n_rows) * kW, ox,
                           oy, oz, dx, dy, dz);
#pragma unroll
          for (int i = 0; i < kUnroll; ++i) {
            if (t[i] < best_t) {
              best_t = t[i];
              best = k + i;
            }
          }
        }
      }

      // The path ends at a miss, at a light, or after its last bounce.
      bool ends = best < 0;
      float rad_r = 0.0f, rad_g = 0.0f, rad_b = 0.0f;
      if (!ends) {
        const float* row = s_tab + PTK_IX(s_tab, best, n_tris) * kTabCols;
        const float col_r = row[0], col_g = row[1], col_b = row[2];
        const float flags = row[7];
        if (flags > 1.5f) {  // EMIT: add the emission
          rad_r = rad_r + thr_r * col_r;
          rad_g = rad_g + thr_g * col_g;
          rad_b = rad_b + thr_b * col_b;
          ends = true;
        } else if (b + 1 == depth) {
          ends = true;
        } else {
          // Non-EMIT rows carry zero emission (checked by the wrapper).
          // Double-sided normal, flipped toward the incoming ray.
          float nx = row[4], ny = row[5], nz = row[6];
          if (!(nx * dx + ny * dy + nz * dz < 0.0f)) {
            nx = -nx;
            ny = -ny;
            nz = -nz;
          }

          const float bu = ptk::rand01(seed);
          const float bv = ptk::rand01(seed);
          const float xx = 2.0f * bu - 1.0f;
          const float ct = sqrtf(fmaxf(1.0f - xx * xx, 0.0f));
          const float phi = ptk::kTwoPi * bv;
          float ndx = ct * cosf(phi);
          float ndy = ct * sinf(phi);
          float ndz = -xx;
          if (ndx * nx + ndy * ny + ndz * nz < 0.0f) {
            ndx = -ndx;
            ndy = -ndy;
            ndz = -ndz;
          }

          if (kHasSpecular) {
            const bool is_spec = flags > 0.5f;
            const float rough = row[3];
            const float ddn = 2.0f * (dx * nx + dy * ny + dz * nz);
            const float mx = dx - nx * ddn;
            const float my = dy - ny * ddn;
            const float mz = dz - nz * ddn;
            float cx = mx, cy = my, cz = mz;  // fallback: the pure mirror
            bool found = false;
            for (int k = 0; k < ptk::kSpecularTries; ++k) {
              const float c1 = ptk::rand01(seed);
              const float c2 = ptk::rand01(seed);
              const float c3 = ptk::rand01(seed);
              if (is_spec && !found) {
                const float jx = mx + (c1 - 0.5f) * rough;
                const float jy = my + (c2 - 0.5f) * rough;
                const float jz = mz + (c3 - 0.5f) * rough;
                if (jx * nx + jy * ny + jz * nz >= 0.0f) {
                  cx = jx;
                  cy = jy;
                  cz = jz;
                  found = true;
                }
              }
            }
            if (is_spec) {
              const float clen = sqrtf(cx * cx + cy * cy + cz * cz);
              ndx = cx / clen;
              ndy = cy / clen;
              ndz = cz / clen;
            }
          }

          const float cosw = nx * ndx + ny * ndy + nz * ndz;
          thr_r = thr_r * (2.0f * col_r * cosw);
          thr_g = thr_g * (2.0f * col_g * cosw);
          thr_b = thr_b * (2.0f * col_b * cosw);

          ox = (ox + dx * best_t) + nx * ptk::kShiftBias;
          oy = (oy + dy * best_t) + ny * ptk::kShiftBias;
          oz = (oz + dz * best_t) + nz * ptk::kShiftBias;
          dx = ndx;
          dy = ndy;
          dz = ndz;
          ++b;
        }
      }
      if (ends) {
        s_slot[slot] = rad_r;
        s_slot[slot + 1] = rad_g;
        s_slot[slot + 2] = rad_b;
        busy = false;
      }
    }
    __syncwarp();
    if (lane < n_valid) {
      for (int k = 0; k < min(kWindow, n_samples - w0); ++k) {
        const float* r =
            s_slot + PTK_IX(s_slot, lane * kWindow + k, 32 * kWindow) * 3;
        acc_r = acc_r + r[0];
        acc_g = acc_g + r[1];
        acc_b = acc_b + r[2];
      }
    }
    __syncwarp();
  }
  if (lane < n_valid) {
    float* out =
        film +
        static_cast<size_t>(PTK_IX(film, warp_pix0 + lane, width * band_h)) *
            3;
    out[0] = out[0] + acc_r;
    out[1] = out[1] + acc_g;
    out[2] = out[2] + acc_b;
  }
}

template <bool kHasSpecular, int kLoop>
cudaError_t launch(const float* rows, const float* tab, const float* cam,
                   float* film, int n_rows, int n_tris, int width,
                   int band_h, int res_y, int h0, uint32_t s0, int spp,
                   int depth, uint32_t seed_mix, int device,
                   cudaStream_t stream) {
  auto kernel = trace_kernel<kHasSpecular, kLoop>;
  const size_t smem =
      static_cast<size_t>(n_rows) * RowWidth<kLoop>::value * sizeof(float4) +
      static_cast<size_t>(n_tris) * kTabCols * sizeof(float) +
      static_cast<size_t>(kThreads) * kWindow * 3 * sizeof(float);
  cudaError_t err = ptk::prepare_smem(kernel, smem, device);
  if (err != cudaSuccess) return err;
  const int n_pix = width * band_h;
  const int blocks = (n_pix + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, smem, stream>>>(
      reinterpret_cast<const float4*>(rows), tab, cam, film, n_rows, n_tris,
      width, band_h, res_y, h0, s0, spp, depth, seed_mix);
  return cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream` (a cudaStream_t) of `device` and returns
// cudaGetLastError() as an int: 0 when the launch was accepted.  `rows` is
// (n_rows, 12) float32 for loop 0 ("mt") or (n_rows, 28) for loop 1
// ("plucker"), n_rows a multiple of pt_trace_row_multiple() and at most
// 512; `tab` is the (n_tris, 8) packed shade table.
extern "C" int pt_trace_render(const float* rows, const float* tab,
                               const float* cam, float* film, int n_rows,
                               int n_tris, int width, int band_h, int res_y,
                               int h0, uint32_t s0, int spp, int depth,
                               uint32_t seed_mix, int has_specular, int loop,
                               int device, void* stream) {
  if (n_rows < 1 || n_rows > kMaxRows || n_rows % kUnroll != 0 ||
      n_tris < 1 || n_tris > n_rows || width < 1 || band_h < 1 ||
      res_y < 1 || h0 < 0 || spp < 0 || depth < 0 ||
      (loop != kLoopMt && loop != kLoopPlucker) ||
      static_cast<long long>(width) * band_h > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PT_TRACE_LAUNCH(SPEC, LOOP)                                         \
  launch<SPEC, LOOP>(rows, tab, cam, film, n_rows, n_tris, width, band_h,   \
                     res_y, h0, s0, spp, depth, seed_mix, device, st)
  if (loop == kLoopPlucker) {
    err = has_specular ? PT_TRACE_LAUNCH(true, kLoopPlucker)
                       : PT_TRACE_LAUNCH(false, kLoopPlucker);
  } else {
    err = has_specular ? PT_TRACE_LAUNCH(true, kLoopMt)
                       : PT_TRACE_LAUNCH(false, kLoopMt);
  }
#undef PT_TRACE_LAUNCH
  return static_cast<int>(err);
}

// The multiple that pt_trace_render's n_rows must be: kUnroll.
extern "C" int pt_trace_row_multiple() { return kUnroll; }

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

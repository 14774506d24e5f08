// Path-tracing megakernel for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces pathtracer_tpu/ops/pallas/trace_kernel.py::_kernel ("mt" loop).
// For each pixel of a film band starting at row h0 it adds the radiance SUM
// over the samples [s0, s0 + spp) into `film`, (band_h, width, 3) float32.
// The math is that of the plain PyTorch path (ops/trace.py::sample_radiance
// over ops/intersect.py::intersect_brute), operation for operation:
//   * RNG: seed = hash(hash(pix_seed ^ sidx * GOLDEN) ^ seed_mix) with
//     pix_seed = h + w * res_y + 1; two jitter draws; per bounce u, v and,
//     when the scene has a specular material, all 3 * SPECULAR_TRIES cube
//     draws (always all of them, so the stream stays aligned).
//   * Möller–Trumbore against every triangle in index order with a strict
//     t < best_t: the first-index tie rule of the plain path's argmin.
//   * IEEE division and sqrtf; the library builds with --fmad=false so no
//     multiply-add is contracted and every rounding matches the unfused
//     elementwise ops of the plain path.
// A path breaks out of the bounce loop once it dies; the next sample
// re-derives its seed from (pixel, sample), so this changes no radiance.
//
// Layout: one thread per pixel; the triangle rows [v1, e1, e2] (T, 9) and
// the packed shade rows [color, rough, normal, flags] (T, 8) are copied to
// shared memory once per block.  All threads of a warp read the same
// triangle at the same time, so every shared-memory read is a broadcast.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTris = 512;
constexpr int kTriCols = 9;
constexpr int kTabCols = 8;
constexpr int kSpecularTries = 8;
constexpr int kThreads = 128;

constexpr float kEps = 1e-6f;
constexpr float kInf = 1e30f;
constexpr float kShiftBias = 1e-4f;
constexpr float kTwoPi = static_cast<float>(2.0 * 3.14159265358979323846);
constexpr float kInvU24 = 1.0f / 16777216.0f;
constexpr uint32_t kGolden = 0x9E3779B9u;

__device__ __forceinline__ uint32_t hash_u32(uint32_t s) {
  s ^= 2747636419u;
  s *= 2654435769u;
  s ^= s >> 16;
  s *= 2654435769u;
  s ^= s >> 16;
  s *= 2654435769u;
  return s;
}

__device__ __forceinline__ float rand01(uint32_t& s) {
  s = hash_u32(s);
  return static_cast<float>(static_cast<int>(s >> 8)) * kInvU24;
}

template <bool kHasSpecular>
__global__ void __launch_bounds__(kThreads)
trace_kernel(const float* __restrict__ tri, const float* __restrict__ tab,
             const float* __restrict__ cam, float* __restrict__ film,
             int n_tris, int width, int band_h, int res_y, int h0,
             uint32_t s0, int spp, int depth, uint32_t seed_mix) {
  extern __shared__ float smem[];
  float* s_tri = smem;
  float* s_tab = smem + n_tris * kTriCols;
  for (int i = threadIdx.x; i < n_tris * kTriCols; i += blockDim.x)
    s_tri[i] = tri[i];
  for (int i = threadIdx.x; i < n_tris * kTabCols; i += blockDim.x)
    s_tab[i] = tab[i];
  __syncthreads();

  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= width * band_h) return;
  const int w = pix % width;
  const int h = pix / width + h0;
  const uint32_t pix_seed = static_cast<uint32_t>(h) +
                            static_cast<uint32_t>(w) *
                                static_cast<uint32_t>(res_y) +
                            1u;
  const float wf = static_cast<float>(w);
  const float hf = static_cast<float>(h);

  // cam: [pos(3), right(3), up(3), distance * forward(3), cell,
  //       v_res.x / 2, v_res.y / 2, pixel_offset]
  const float px = cam[0], py = cam[1], pz = cam[2];
  const float rx = cam[3], ry = cam[4], rz = cam[5];
  const float ux = cam[6], uy = cam[7], uz = cam[8];
  const float fx = cam[9], fy = cam[10], fz = cam[11];
  const float cell = cam[12], hvx = cam[13], hvy = cam[14];
  const float pix_off = cam[15];

  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  for (int s = 0; s < spp; ++s) {
    const uint32_t sidx = s0 + static_cast<uint32_t>(s);
    uint32_t seed = hash_u32(pix_seed ^ (sidx * kGolden));
    seed = hash_u32(seed ^ seed_mix);

    const float j1 = rand01(seed);
    const float j2 = rand01(seed);
    const float x = (wf + pix_off + j1) * cell - hvx;
    const float y = (hf + pix_off + j2) * cell - hvy;
    float dx = x * rx + y * ux + fx;
    float dy = x * ry + y * uy + fy;
    float dz = x * rz + y * uz + fz;
    const float dlen = sqrtf(dx * dx + dy * dy + dz * dz);
    dx = dx / dlen;
    dy = dy / dlen;
    dz = dz / dlen;
    float ox = px, oy = py, oz = pz;

    float thr_r = 1.0f, thr_g = 1.0f, thr_b = 1.0f;
    float rad_r = 0.0f, rad_g = 0.0f, rad_b = 0.0f;
    for (int b = 0; b < depth; ++b) {
      // Nearest hit over all triangles (Möller–Trumbore).
      float best_t = kInf;
      int best = -1;
      for (int k = 0; k < n_tris; ++k) {
        const float* r = s_tri + k * kTriCols;
        const float v1x = r[0], v1y = r[1], v1z = r[2];
        const float e1x = r[3], e1y = r[4], e1z = r[5];
        const float e2x = r[6], e2y = r[7], e2z = r[8];
        const float hx = dy * e2z - dz * e2y;
        const float hy = dz * e2x - dx * e2z;
        const float hz = dx * e2y - dy * e2x;
        const float a = e1x * hx + e1y * hy + e1z * hz;
        const float f = 1.0f / a;
        const float sx = ox - v1x, sy = oy - v1y, sz = oz - v1z;
        const float u = f * (sx * hx + sy * hy + sz * hz);
        const float qx = sy * e1z - sz * e1y;
        const float qy = sz * e1x - sx * e1z;
        const float qz = sx * e1y - sy * e1x;
        const float v = f * (dx * qx + dy * qy + dz * qz);
        const float t = f * (e2x * qx + e2y * qy + e2z * qz);
        // u <= 1 follows from v >= 0 and u + v <= 1.
        if (fabsf(a) >= kEps && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
            t > 0.0f && t < best_t) {
          best_t = t;
          best = k;
        }
      }
      if (best < 0) break;  // miss: the path dies

      const float* row = s_tab + best * kTabCols;
      const float col_r = row[0], col_g = row[1], col_b = row[2];
      const float flags = row[7];
      if (flags > 1.5f) {  // EMIT: add the emission, the path dies
        rad_r = rad_r + thr_r * col_r;
        rad_g = rad_g + thr_g * col_g;
        rad_b = rad_b + thr_b * col_b;
        break;
      }
      // Non-EMIT rows carry zero emission (checked by the wrapper).

      // Double-sided normal, flipped toward the incoming ray.
      float nx = row[4], ny = row[5], nz = row[6];
      if (!(nx * dx + ny * dy + nz * dz < 0.0f)) {
        nx = -nx;
        ny = -ny;
        nz = -nz;
      }

      const float bu = rand01(seed);
      const float bv = rand01(seed);
      const float xx = 2.0f * bu - 1.0f;
      const float ct = sqrtf(fmaxf(1.0f - xx * xx, 0.0f));
      const float phi = kTwoPi * bv;
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
        for (int k = 0; k < kSpecularTries; ++k) {
          const float c1 = rand01(seed);
          const float c2 = rand01(seed);
          const float c3 = rand01(seed);
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

      ox = (ox + dx * best_t) + nx * kShiftBias;
      oy = (oy + dy * best_t) + ny * kShiftBias;
      oz = (oz + dz * best_t) + nz * kShiftBias;
      dx = ndx;
      dy = ndy;
      dz = ndz;
    }
    acc_r = acc_r + rad_r;
    acc_g = acc_g + rad_g;
    acc_b = acc_b + rad_b;
  }
  float* out = film + static_cast<size_t>(pix) * 3;
  out[0] = out[0] + acc_r;
  out[1] = out[1] + acc_g;
  out[2] = out[2] + acc_b;
}

}  // namespace

// Launches the kernel on `stream` (a cudaStream_t) of `device` and returns
// cudaGetLastError() as an int: 0 when the launch was accepted.
extern "C" int pt_trace_render(const float* tri, const float* tab,
                               const float* cam, float* film, int n_tris,
                               int width, int band_h, int res_y, int h0,
                               uint32_t s0, int spp, int depth,
                               uint32_t seed_mix, int has_specular,
                               int device, void* stream) {
  if (n_tris < 1 || n_tris > kMaxTris || width < 1 || band_h < 1 ||
      res_y < 1 || h0 < 0 || spp < 0 || depth < 0 ||
      static_cast<long long>(width) * band_h > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_pix = width * band_h;
  const int blocks = (n_pix + kThreads - 1) / kThreads;
  const size_t smem =
      static_cast<size_t>(n_tris) * (kTriCols + kTabCols) * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (has_specular) {
    trace_kernel<true><<<blocks, kThreads, smem, st>>>(
        tri, tab, cam, film, n_tris, width, band_h, res_y, h0, s0, spp, depth,
        seed_mix);
  } else {
    trace_kernel<false><<<blocks, kThreads, smem, st>>>(
        tri, tab, cam, film, n_tris, width, band_h, res_y, h0, s0, spp, depth,
        seed_mix);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Coherent-beam path-tracing kernel for large scenes on Hopper (sm_90a),
// bound with ctypes.
//
// Replaces pathtracer_tpu/ops/pallas/beam_kernel.py::_kernel.  The film is
// defined by the estimator, not by the TPU schedule:
//   * pixels are traced in device order: 64x64 squares rastered row-major
//     over the film padded to 64-multiples, Morton order inside a square;
//     device pixel `pix` belongs to the 2048-pixel tile pix >> 11;
//   * the pixel stream hash(hash(pix_seed ^ sidx * GOLDEN) ^ seed_mix), with
//     pix_seed = h + w * res_y + 1, gives the two jitter draws only;
//   * the tile stream hash(hash((tile + 0x9E377) ^ sidx * GOLDEN) ^
//     seed_mix) gives every bounce's uniforms, so all pixels of a tile share
//     them (coherent sampling): per bounce u1, u2 and, when the scene has a
//     specular material, all 3 * SPECULAR_TRIES cube draws;
//   * each pixel keeps its own normal flip and its own flip of the shared
//     hemisphere direction.
// The TPU's bit-planes, DMA to SMEM, scalar walks, positional chunks and
// staged windows are its schedule, not part of the result: every test here
// is exact per ray, so the film is that of any exact nearest-hit traversal
// (ops/cuda/beam_kernel.py::render_tiles_beam_reference, dense over all
// rows).  Only an exact tie in t between two rows can resolve differently.
//
// Traversal, per ray: the supercluster boxes (shared memory) front to back
// in sc_order[octant], the octant taken from the warp's summed camera
// direction at bounce 0 and from the shared bounce sample after that; a
// passing supercluster's cluster boxes; a passing cluster's 8 rows.  Every
// box test is the slab test with tmin < best_t; the row test is
// Möller–Trumbore with IEEE 1.0f / a and a strict t < best_t.
//
// What bounds it on this card: fp32 issue in the box and triangle loops and
// divergence between the rays of a warp, which pay for the union of their
// traversals.  Design: one thread per pixel; the small hot tables (at most
// 1008 supercluster boxes, firsts and counts, about 40 KB) in shared
// memory; cluster boxes and 64-byte triangle rows read from global memory
// through L1/L2 with 16-byte loads.
//
// Rounding: shading in the plain version's order, --fmad=false, rsqrtf for
// the camera ray, the normal and the specular direction as torch.rsqrt.

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;       // 2048 % kThreads == 0: a block never
                                    // straddles a tile
constexpr int kTileLog2 = 11;       // 2048-pixel tiles
constexpr int kSquareLog2 = 12;     // 64 x 64 squares
constexpr uint32_t kTileMix = 0x9E377u;

__device__ __forceinline__ uint32_t even_bits(uint32_t v) {
  v &= 0x55555555u;
  v = (v | (v >> 1)) & 0x33333333u;
  v = (v | (v >> 2)) & 0x0F0F0F0Fu;
  v = (v | (v >> 4)) & 0x00FF00FFu;
  v = (v | (v >> 8)) & 0x0000FFFFu;
  return v;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int k = 16; k > 0; k >>= 1) x += __shfl_xor_sync(0xFFFFFFFFu, x, k);
  return __shfl_sync(0xFFFFFFFFu, x, 0);  // one value for every lane
}

template <bool kHasSpecular, bool kInline>
__global__ void __launch_bounds__(kThreads)
beam_kernel(const float* __restrict__ cam, const float* __restrict__ sc_bounds,
            const int* __restrict__ sc_first, const int* __restrict__ sc_ncl,
            const int* __restrict__ sc_order, const float* __restrict__ mats,
            const float* __restrict__ cl_bounds,
            const float* __restrict__ tri_cols, float* __restrict__ film,
            int* __restrict__ counts, int n_sc, int ctris, int n_pix,
            int res_y, int nsq_x, int tile0, uint32_t s0, int spp, int depth,
            uint32_t seed_mix) {
  extern __shared__ float4 smem[];
  float4* s_box = smem;  // 2 float4 per supercluster
  int* s_first = reinterpret_cast<int*>(smem + 2 * n_sc);
  int* s_ncl = s_first + n_sc;
  const float4* scb4 = reinterpret_cast<const float4*>(sc_bounds);
  for (int i = threadIdx.x; i < 2 * n_sc; i += blockDim.x) s_box[i] = scb4[i];
  for (int i = threadIdx.x; i < n_sc; i += blockDim.x) {
    s_first[i] = sc_first[i];
    s_ncl[i] = sc_ncl[i];
  }
  __syncthreads();

  const int local = blockIdx.x * blockDim.x + threadIdx.x;
  if (local >= n_pix) return;  // never: the launch covers whole tiles
  const uint32_t pix = (static_cast<uint32_t>(tile0) << kTileLog2) +
                       static_cast<uint32_t>(local);
  const uint32_t tile = pix >> kTileLog2;
  const int sq = static_cast<int>(pix >> kSquareLog2);
  const int sq_row = sq / nsq_x;
  const int sq_col = sq - sq_row * nsq_x;
  const uint32_t in_sq = pix & ((1u << kSquareLog2) - 1u);
  const int w = sq_col * 64 + static_cast<int>(even_bits(in_sq));
  const int h = sq_row * 64 + static_cast<int>(even_bits(in_sq >> 1));
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

  const float4* clb4 = reinterpret_cast<const float4*>(cl_bounds);
  const float4* row4 = reinterpret_cast<const float4*>(tri_cols);
  int tests = 0;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  for (int s = 0; s < spp; ++s) {
    const uint32_t sidx = s0 + static_cast<uint32_t>(s);
    uint32_t seed = ptk::hash_u32(pix_seed ^ (sidx * ptk::kGolden));
    seed = ptk::hash_u32(seed ^ seed_mix);
    uint32_t tseed =
        ptk::hash_u32((tile + kTileMix) ^ (sidx * ptk::kGolden));
    tseed = ptk::hash_u32(tseed ^ seed_mix);

    const float j1 = ptk::rand01(seed);
    const float j2 = ptk::rand01(seed);
    const float x = (wf + pix_off + j1) * cell - hvx;
    const float y = (hf + pix_off + j2) * cell - hvy;
    float dx = x * rx + y * ux + fx;
    float dy = x * ry + y * uy + fy;
    float dz = x * rz + y * uz + fz;
    const float inv = rsqrtf(dx * dx + dy * dy + dz * dz);
    dx = dx * inv;
    dy = dy * inv;
    dz = dz * inv;
    float ox = px, oy = py, oz = pz;
    float thr_r = 1.0f, thr_g = 1.0f, thr_b = 1.0f;
    float rad_r = 0.0f, rad_g = 0.0f, rad_b = 0.0f;
    float sdx = 0.0f, sdy = 0.0f, sdz = 0.0f;  // last shared bounce sample

    for (int b = 0; b < depth; ++b) {
      const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
      float mdx = sdx, mdy = sdy, mdz = sdz;
      if (b == 0) {  // every lane is alive at bounce 0
        mdx = warp_sum(dx);
        mdy = warp_sum(dy);
        mdz = warp_sum(dz);
      }
      const int oct = (mdx > 0.0f ? 1 : 0) + (mdy > 0.0f ? 2 : 0) +
                      (mdz > 0.0f ? 4 : 0);
      const int* visit = sc_order + oct * n_sc;

      float best_t = ptk::kInf;
      int best = -1;
      for (int k = 0; k < n_sc; ++k) {
        const int sc = __ldg(visit + k);
        const float4 a0 = s_box[2 * sc];
        const float4 a1 = s_box[2 * sc + 1];
        if (!ptk::slab_hit(a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, ox, oy, oz,
                           ix, iy, iz, best_t))
          continue;
        const int c0 = s_first[sc];
        const int c1 = c0 + s_ncl[sc];
        for (int c = c0; c < c1; ++c) {
          const float4 q0 = __ldg(clb4 + 2 * c);
          const float4 q1 = __ldg(clb4 + 2 * c + 1);
          if (!ptk::slab_hit(q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, ox, oy, oz,
                             ix, iy, iz, best_t))
            continue;
          tests += ctris;
          const int r0 = c * ctris;
          for (int j = 0; j < ctris; ++j) {
            const float4 p0 = __ldg(row4 + 4 * (r0 + j));
            const float4 p1 = __ldg(row4 + 4 * (r0 + j) + 1);
            const float4 p2 = __ldg(row4 + 4 * (r0 + j) + 2);
            const float t = ptk::mt_hit(p0.x, p0.y, p0.z, p0.w, p1.x, p1.y,
                                        p1.z, p1.w, p2.x, ox, oy, oz, dx, dy,
                                        dz);
            if (t < best_t) {
              best_t = t;
              best = r0 + j;
            }
          }
        }
      }
      if (best < 0) break;  // miss: the path dies

      // Row [.., mat, Nx, Ny | Nz, color(3)]: cols 9..15.
      const float4 p2 = __ldg(row4 + 4 * best + 2);
      const float4 p3 = __ldg(row4 + 4 * best + 3);
      const float f_mat = p2.y;
      float col_r, col_g, col_b, rough, flags;
      if (kInline) {
        col_r = p3.y;
        col_g = p3.z;
        col_b = p3.w;
        flags = floorf(f_mat * 0.125f);
        rough = f_mat - 8.0f * flags;
      } else {
        const float* m = mats + 8 * static_cast<int>(f_mat);
        col_r = __ldg(m);
        col_g = __ldg(m + 1);
        col_b = __ldg(m + 2);
        rough = __ldg(m + 3);
        flags = __ldg(m + 4);
      }
      const float inv_n =
          rsqrtf(fmaxf(p2.z * p2.z + p2.w * p2.w + p3.x * p3.x, 1e-30f));
      float nx = p2.z * inv_n, ny = p2.w * inv_n, nz = p3.x * inv_n;

      if (flags > 1.5f) {  // EMIT: add the emission, the path dies
        rad_r = rad_r + thr_r * col_r;
        rad_g = rad_g + thr_g * col_g;
        rad_b = rad_b + thr_b * col_b;
        break;
      }
      if (!(nx * dx + ny * dy + nz * dz < 0.0f)) {  // face the ray
        nx = -nx;
        ny = -ny;
        nz = -nz;
      }

      // Shared hemisphere sample; each ray flips it to its own side.
      const float tu1 = ptk::rand01(tseed);
      const float tu2 = ptk::rand01(tseed);
      const float xx = 2.0f * tu1 - 1.0f;
      const float ct = sqrtf(fmaxf(1.0f - xx * xx, 0.0f));
      const float phi = ptk::kTwoPi * tu2;
      sdx = ct * cosf(phi);
      sdy = ct * sinf(phi);
      sdz = -xx;
      float ndx = sdx, ndy = sdy, ndz = sdz;
      if (sdx * nx + sdy * ny + sdz * nz < 0.0f) {
        ndx = -ndx;
        ndy = -ndy;
        ndz = -ndz;
      }

      if (kHasSpecular) {
        const float ddn = 2.0f * (dx * nx + dy * ny + dz * nz);
        const float mx = dx - ddn * nx;
        const float my = dy - ddn * ny;
        const float mz = dz - ddn * nz;
        float cx = mx, cy = my, cz = mz;  // fallback: the pure mirror
        bool found = false;
        for (int k = 0; k < ptk::kSpecularTries; ++k) {
          const float c1 = ptk::rand01(tseed);
          const float c2 = ptk::rand01(tseed);
          const float c3 = ptk::rand01(tseed);
          if (!found) {  // the first candidate above the surface wins
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
        if (flags > 0.5f) {
          const float invs = rsqrtf(cx * cx + cy * cy + cz * cz);
          ndx = cx * invs;
          ndy = cy * invs;
          ndz = cz * invs;
        }
      }

      const float w2c = 2.0f * (nx * ndx + ny * ndy + nz * ndz);
      thr_r = thr_r * (w2c * col_r);
      thr_g = thr_g * (w2c * col_g);
      thr_b = thr_b * (w2c * col_b);
      ox = (ox + dx * best_t) + nx * ptk::kShiftBias;
      oy = (oy + dy * best_t) + ny * ptk::kShiftBias;
      oz = (oz + dz * best_t) + nz * ptk::kShiftBias;
      dx = ndx;
      dy = ndy;
      dz = ndz;
    }
    acc_r = acc_r + rad_r;
    acc_g = acc_g + rad_g;
    acc_b = acc_b + rad_b;
  }
  film[local] = film[local] + acc_r;
  film[n_pix + local] = film[n_pix + local] + acc_g;
  film[2 * n_pix + local] = film[2 * n_pix + local] + acc_b;
  if (counts != nullptr) counts[local] = counts[local] + tests;
}

template <bool kHasSpecular, bool kInline>
cudaError_t launch(int blocks, size_t smem, cudaStream_t st, const float* cam,
                   const float* sc_bounds, const int* sc_first,
                   const int* sc_ncl, const int* sc_order, const float* mats,
                   const float* cl_bounds, const float* tri_cols, float* film,
                   int* counts, int n_sc, int ctris, int n_pix, int res_y,
                   int nsq_x, int tile0, uint32_t s0, int spp, int depth,
                   uint32_t seed_mix, int device) {
  auto kernel = beam_kernel<kHasSpecular, kInline>;
  cudaError_t err = ptk::prepare_smem(kernel, smem, device);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, smem, st>>>(
      cam, sc_bounds, sc_first, sc_ncl, sc_order, mats, cl_bounds, tri_cols,
      film, counts, n_sc, ctris, n_pix, res_y, nsq_x, tile0, s0, spp, depth,
      seed_mix);
  return cudaGetLastError();
}

}  // namespace

// Adds the radiance sums of the samples [s0, s0 + spp) of the `n_tiles`
// 2048-pixel tiles from `tile0` into `film` (3, n_tiles * 2048), channel
// planes in device order, and, when `counts` (n_tiles * 2048,) is not null,
// each pixel's tested triangle rows into `counts`.  The accel arrays are
// those of clusters.BeamAccel; `mats_inline` selects the inline material
// columns.  Launches on `stream` of `device` and returns cudaGetLastError()
// as an int: 0 when the launch was accepted.
extern "C" int pt_beam_render(const float* cam, const float* sc_bounds,
                              const int* sc_first, const int* sc_ncl,
                              const int* sc_order, const float* mats,
                              const float* cl_bounds, const float* tri_cols,
                              float* film, int* counts, int n_sc, int ctris,
                              int n_tiles, int res_y, int nsq_x, int tile0,
                              uint32_t s0, int spp, int depth,
                              uint32_t seed_mix, int has_specular,
                              int mats_inline, int device, void* stream) {
  if (n_sc < 1 || ctris < 1 || n_tiles < 1 || res_y < 1 || nsq_x < 1 ||
      tile0 < 0 || spp < 0 || depth < 0 ||
      (static_cast<long long>(tile0) + n_tiles) << kTileLog2 > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_pix = n_tiles << kTileLog2;
  const int blocks = n_pix / kThreads;
  const size_t smem =
      static_cast<size_t>(n_sc) * (2 * sizeof(float4) + 2 * sizeof(int));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PT_BEAM_LAUNCH(SPEC, INL)                                            \
  launch<SPEC, INL>(blocks, smem, st, cam, sc_bounds, sc_first, sc_ncl,      \
                    sc_order, mats, cl_bounds, tri_cols, film, counts, n_sc, \
                    ctris, n_pix, res_y, nsq_x, tile0, s0, spp, depth,       \
                    seed_mix, device)
  if (has_specular) {
    err = mats_inline ? PT_BEAM_LAUNCH(true, true)
                      : PT_BEAM_LAUNCH(true, false);
  } else {
    err = mats_inline ? PT_BEAM_LAUNCH(false, true)
                      : PT_BEAM_LAUNCH(false, false);
  }
#undef PT_BEAM_LAUNCH
  return static_cast<int>(err);
}

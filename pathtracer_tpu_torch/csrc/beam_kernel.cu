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
// rows), ties included: a row replaces the best on a nearer t, or on an
// equal t with a lower packed row (argmin's first index), and a box opens
// on tmin <= best_t, so the visit order cannot change the hit.
//
// Traversal, per ray segment: a walk of the box tree over the
// superclusters (ptk::walk_tree: the top of the SAH BVH the accel was cut
// from, both children's boxes in one 64-byte node, near child first, the
// far one on a short stack); in each supercluster it enters, the cluster
// boxes; in each cluster it enters, the 8 rows by Möller–Trumbore with the
// IEEE reciprocal's fast path (ptk::rcp_in_range: the wrapper refuses rows
// whose determinant could reach 2^125).
//
// What bounds it on this card: fp32 issue in the box and triangle tests and
// divergence between the rays of a warp, which pay for the union of their
// traversals.  Design: a thread traces one pixel's samples of one sample
// run; the tree's nodes (64 B each, at most 64.4 KB), each thread's stack
// slice (8 B an entry, the tree's depth in entries) and the superclusters'
// firsts and counts in shared memory; cluster boxes and 64-byte triangle
// rows read from global memory through L1/L2 with 16-byte loads.  The walk
// opens one to two dozen nodes where a loop over every supercluster box
// tested 117 (sphere9812) to 608 (garden105708) boxes a segment.
//
// Schedule: a block is kThreads adjacent device-order pixels (a warp 32 of
// them, all in one tile, so its lanes share the tile's bounce stream) under
// one run of consecutive samples.  The wrapper's launch plan
// (ops/cuda/beam_kernel.py::launch_plan) cuts a launch's samples into
// `groups` runs, as few as still give the card several waves of resident
// blocks: the blocks' work differs by 2x and more across a film (walls and
// sky against the meshes), and a launch of one block a pixel block, which
// a 256 x 256 frame is, lasts as long as its slowest block.  Each sample's
// radiance goes to `scratch` (spp, 3, n_pix), and beam_kernel_sum adds the
// samples to the film in sample order, so the film keeps the bits of one
// thread summing its pixel's samples in turn.
//
// Rounding: shading in the plain version's order, --fmad=false, rsqrtf for
// the camera ray, the normal and the specular direction as torch.rsqrt.

#include <climits>
#include <cstdint>

#define PTK_KERNEL "beam_kernel"
#include "common.cuh"

namespace {

constexpr int kThreads = 256;       // 2048 % kThreads == 0: a block never
                                    // straddles a tile
// Three blocks an SM, as many as the garden's 68 KB of shared memory a
// block allows: ptxas then fits 80 registers a thread without spilling.
// Left free it takes 82-88 and the card holds two blocks an SM, a third
// fewer warps to hide the walk's loads.  With the block size alone it
// budgets 64 and spills 28-124 bytes a thread.
constexpr int kMinBlocks = 3;
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

template <bool kHasSpecular, bool kInline>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
beam_kernel(const float* __restrict__ cam, const float* __restrict__ sc_tree,
            const int* __restrict__ sc_first, const int* __restrict__ sc_ncl,
            const float* __restrict__ mats,
            const float* __restrict__ cl_bounds,
            const float* __restrict__ tri_cols,
            float* __restrict__ scratch, int* __restrict__ counts, int n_sc,
            int tree_depth, int ctris, int n_pix, int res_y, int nsq_x,
            int tile0, uint32_t s0, int spp, int groups, int depth,
            uint32_t seed_mix, int n_mats, int n_cl_rows, int n_tri_rows) {
  // Shared memory: the tree's nodes, each thread's stack slice (entry k of
  // thread x at k * kThreads + x), the superclusters' first clusters and
  // cluster counts.
  extern __shared__ float4 smem[];
  const int n_nodes = n_sc - 1;
  float4* s_node = smem;
  float2* s_stack = reinterpret_cast<float2*>(smem + 4 * n_nodes);
  int* s_first = reinterpret_cast<int*>(s_stack + tree_depth * kThreads);
  int* s_ncl = s_first + n_sc;
  const float4* tree4 = reinterpret_cast<const float4*>(sc_tree);
  for (int i = threadIdx.x; i < 4 * n_nodes; i += blockDim.x)
    s_node[PTK_IX(s_node, i, 4 * n_nodes)] =
        tree4[PTK_IX(sc_tree, i, 4 * n_nodes)];
  for (int i = threadIdx.x; i < n_sc; i += blockDim.x) {
    s_first[PTK_IX(s_first, i, n_sc)] = sc_first[PTK_IX(sc_first, i, n_sc)];
    s_ncl[PTK_IX(s_ncl, i, n_sc)] = sc_ncl[PTK_IX(sc_ncl, i, n_sc)];
  }
  __syncthreads();
  float2* stack = s_stack + threadIdx.x;

  // Block b: pixel block b % pixel_blocks, sample run b / pixel_blocks of
  // the `groups` runs that cut [0, spp) into lengths differing by <= 1.
  const int pixel_blocks = n_pix / kThreads;
  const int group = static_cast<int>(blockIdx.x) / pixel_blocks;
  const int local =
      (static_cast<int>(blockIdx.x) - group * pixel_blocks) * kThreads +
      static_cast<int>(threadIdx.x);
  const int s_lo = static_cast<int>(static_cast<long long>(group) * spp /
                                    groups);
  const int s_hi = static_cast<int>(static_cast<long long>(group + 1) * spp /
                                    groups);
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
  const long long n3 = 3LL * n_pix;
  int tests = 0;
  for (int s = s_lo; s < s_hi; ++s) {
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

    for (int b = 0; b < depth; ++b) {
      const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;

      // The supercluster tree, then in each supercluster it enters the
      // cluster boxes, and in each cluster it enters the cluster's rows.
      float best_t = ptk::kInf;
      int best = -1;
      ptk::walk_tree<false>(
          s_node, n_nodes, stack, kThreads, tree_depth, ox, oy, oz, ix, iy,
          iz, best_t, [&](int sc) {
            const int c0 = s_first[PTK_IX(s_first, sc, n_sc)];
            const int c1 = c0 + s_ncl[PTK_IX(s_ncl, sc, n_sc)];
            for (int c = c0; c < c1; ++c) {
              const float4* q = clb4 + 2 * PTK_IX(cl_bounds, c, n_cl_rows);
              const float4 q0 = __ldg(q);
              const float4 q1 = __ldg(q + 1);
              float tmin;
              if (!ptk::slab_enter(q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, ox,
                                   oy, oz, ix, iy, iz, best_t, tmin))
                continue;
              tests += ctris;
              const int r0 = c * ctris;
              for (int j = 0; j < ctris; ++j) {
                const float4* p = row4 + 4 * PTK_IX(tri_cols, r0 + j,
                                                    n_tri_rows);
                const float4 p0 = __ldg(p);
                const float4 p1 = __ldg(p + 1);
                const float4 p2 = __ldg(p + 2);
                const float t = ptk::mt_hit<true>(
                    p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w, p2.x, ox,
                    oy, oz, dx, dy, dz);
                if (ptk::nearer(t, r0 + j, best_t, best)) {
                  best_t = t;
                  best = r0 + j;
                }
              }
            }
          });
      if (best < 0) break;  // miss: the path dies

      // Row [.., mat, Nx, Ny | Nz, color(3)]: cols 9..15.
      const float4* hit = row4 + 4 * PTK_IX(tri_cols, best, n_tri_rows);
      const float4 p2 = __ldg(hit + 2);
      const float4 p3 = __ldg(hit + 3);
      const float f_mat = p2.y;
      float col_r, col_g, col_b, rough, flags;
      if (kInline) {
        col_r = p3.y;
        col_g = p3.z;
        col_b = p3.w;
        flags = floorf(f_mat * 0.125f);
        rough = f_mat - 8.0f * flags;
      } else {
        const float* m =
            mats + 8 * PTK_IX(mats, static_cast<int>(f_mat), n_mats);
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
      const float sdx = ct * cosf(phi);
      const float sdy = ct * sinf(phi);
      const float sdz = -xx;
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
    const long long at = s * n3 + local;
    scratch[PTK_IX(scratch, at, spp * n3)] = rad_r;
    scratch[PTK_IX(scratch, at + n_pix, spp * n3)] = rad_g;
    scratch[PTK_IX(scratch, at + 2 * n_pix, spp * n3)] = rad_b;
  }
  // Other runs of this pixel add theirs; integers sum in any order.
  if (counts != nullptr)
    atomicAdd(&counts[PTK_IX(counts, local, n_pix)], tests);
}

// film[i] += ((scratch[0][i] + scratch[1][i]) + ...) + scratch[spp - 1][i]
// over the (3 * n_pix) film: each pixel's samples in sample order, as one
// thread summing them in turn would.
__global__ void __launch_bounds__(kThreads)
beam_kernel_sum(const float* __restrict__ scratch, float* __restrict__ film,
                int n3, int spp) {
  const int i = static_cast<int>(blockIdx.x) * kThreads +
                static_cast<int>(threadIdx.x);
  if (i >= n3) return;
  const long long stride = n3;
  float acc = 0.0f;
  for (int s = 0; s < spp; ++s)
    acc = acc + scratch[PTK_IX(scratch, s * stride + i, spp * stride)];
  film[PTK_IX(film, i, n3)] = film[PTK_IX(film, i, n3)] + acc;
}

// The instance for the scene's materials.
decltype(&beam_kernel<false, false>) instance(int has_specular,
                                              int mats_inline) {
  if (has_specular)
    return mats_inline ? beam_kernel<true, true> : beam_kernel<true, false>;
  return mats_inline ? beam_kernel<false, true> : beam_kernel<false, false>;
}

// Dynamic shared memory a block: the tree's nodes, the stack slices, the
// superclusters' firsts and counts.
size_t smem_bytes(int n_sc, int tree_depth) {
  return static_cast<size_t>(n_sc - 1) * 4 * sizeof(float4) +
         static_cast<size_t>(tree_depth) * kThreads * sizeof(float2) +
         static_cast<size_t>(n_sc) * 2 * sizeof(int);
}

}  // namespace

// The deepest box tree the cluster and beam kernels walk (their stacks'
// capacity): a wrapper refuses a deeper tree.
extern "C" int pt_tree_stack_size() { return ptk::kTreeStack; }

// The blocks of one instance that the card `device` holds at once (blocks
// an SM, as cudaOccupancyMaxActiveBlocksPerMultiprocessor reports them for
// the accel's shared memory, times the SMs), or a negative cudaError.  The
// wrapper's launch plan cuts a launch's samples by it.
extern "C" int pt_beam_resident_blocks(int n_sc, int tree_depth,
                                       int has_specular, int mats_inline,
                                       int device) {
  if (n_sc < 1 || tree_depth < 0 || tree_depth > ptk::kTreeStack)
    return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  const auto kernel = instance(has_specular, mats_inline);
  const size_t smem = smem_bytes(n_sc, tree_depth);
  if (err == cudaSuccess) err = ptk::prepare_smem(kernel, smem, device);
  int per_sm = 0, sms = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  return err == cudaSuccess ? per_sm * sms : -static_cast<int>(err);
}

// Adds the radiance sums of the samples [s0, s0 + spp) of the `n_tiles`
// 2048-pixel tiles from `tile0` into `film` (3, n_tiles * 2048), channel
// planes in device order, and, when `counts` (n_tiles * 2048,) is not null,
// each pixel's tested triangle rows into `counts`.  `scratch` (spp, 3,
// n_tiles * 2048) takes each sample's radiance; `groups` (1 to spp) is the
// launch plan's sample runs, the grid n_tiles * 2048 / kThreads * groups
// blocks.  The accel arrays are those of clusters.BeamAccel: `sc_tree` the
// (n_sc - 1, 16) tree over the superclusters, `tree_depth` its depth (at
// most kTreeStack; 0 for one supercluster); `mats_inline` selects the
// inline material columns; `n_mats`, `n_cl_rows` and `n_tri_rows` are the
// rows of `mats` (8 floats each), `cl_bounds` (8) and `tri_cols` (16),
// which only the checked build reads (PTK_IX).  Launches the kernel and
// beam_kernel_sum on `stream` of `device` and returns cudaGetLastError()
// as an int: 0 when both launches were accepted.
extern "C" int pt_beam_render(const float* cam, const float* sc_tree,
                              const int* sc_first, const int* sc_ncl,
                              const float* mats, const float* cl_bounds,
                              const float* tri_cols, float* film,
                              float* scratch, int* counts, int n_sc,
                              int tree_depth, int ctris, int n_tiles,
                              int res_y, int nsq_x, int tile0, uint32_t s0,
                              int spp, int groups, int depth,
                              uint32_t seed_mix, int has_specular,
                              int mats_inline, int n_mats, int n_cl_rows,
                              int n_tri_rows, int device, void* stream) {
  if (n_sc < 1 || tree_depth < 0 || tree_depth > ptk::kTreeStack ||
      n_mats < 0 || n_cl_rows < 1 || n_tri_rows < 1 ||
      (n_sc == 1) != (tree_depth == 0) || ctris < 1 || n_tiles < 1 ||
      res_y < 1 || nsq_x < 1 || tile0 < 0 || spp < 0 || depth < 0 ||
      groups < 1 || groups > (spp > 0 ? spp : 1) ||
      (static_cast<long long>(tile0) + n_tiles) << kTileLog2 > INT_MAX ||
      (static_cast<long long>(n_tiles) << kTileLog2) / kThreads * groups >
          INT_MAX ||
      3 * (static_cast<long long>(n_tiles) << kTileLog2) > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_pix = n_tiles << kTileLog2;
  const auto kernel = instance(has_specular, mats_inline);
  const size_t smem = smem_bytes(n_sc, tree_depth);
  err = ptk::prepare_smem(kernel, smem, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  kernel<<<n_pix / kThreads * groups, kThreads, smem, st>>>(
      cam, sc_tree, sc_first, sc_ncl, mats, cl_bounds, tri_cols, scratch,
      counts, n_sc, tree_depth, ctris, n_pix, res_y, nsq_x, tile0, s0, spp,
      groups, depth, seed_mix, n_mats, n_cl_rows, n_tri_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  beam_kernel_sum<<<3 * n_pix / kThreads, kThreads, 0, st>>>(scratch, film,
                                                             3 * n_pix, spp);
  return static_cast<int>(cudaGetLastError());
}

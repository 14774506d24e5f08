// The shade table's gather by triangle id, and its gradient, for Hopper
// (sm_90a), bound with ctypes.
//
// Replaces no TPU kernel.  On the TPU the gather is XLA's (jnp.take in
// pathtracer_tpu/ops/trace.py::gather_features); eager PyTorch ran it as
// four launches a bounce (clamp, int64 cast, index_select, where), and its
// backward as index_add_, which adds every ray's row of gradient into its
// table row with float atomics.  On a large mesh most paths hit a few wall
// triangles, so those rows' addresses take hundreds of thousands of
// serialised atomics a call, in an order that changes from run to run; the
// misses added zeros into row 0 besides.
//
// Forward, gather_rows_kernel: one thread a 16-byte quad of an output row;
// an id < 0 writes zeros.  What bounds it: bytes, 4 of id and C * 4 of row
// written an id (218 MB for the garden recovery's 4,194,304 ids of 12
// floats, ~0.065 ms at 3.35 TB/s), the table resident in L2.  The output is
// a copy of the rows, so it is index_select + where's bits.
//
// Backward: the ids sorted stably (torch.sort, in the wrapper) give every
// table row its gradient rows as one contiguous segment, in a fixed order.
// segment_sum_kernel: a block takes kChunk sorted ids, a thread kItems of
// them in order, summing each run of equal ids; a run inside one thread is
// written out by that thread, and the runs that cross threads are finished
// by a segmented scan over the block's threads, a fixed tree.  A run that
// reaches past either end of the block's chunk leaves its partial sum in the
// chunk's head or tail slot instead; finish_rows_kernel, a thread a table
// row, adds those slots in chunk order for the rows whose ids span chunks,
// and writes zeros for the rows no id names.  Every table row is written by
// exactly one thread, ids < 0 are skipped, and no float atomic is taken: the
// sums, and so the gradient, are the same bits on every run.  What bounds
// it: bytes, the sorted ids and their positions (12 bytes an id) and a
// gradient row gathered by position (~64 bytes of sectors for 48), ~0.1 ms
// at the garden's shape; the sort costs as much again.

#include <cstdint>

#define PTK_KERNEL "gather_kernel"
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;                    // sorted ids a thread
constexpr int kChunk = kThreads * kItems;    // sorted ids a block
constexpr int kMaxQuads = 4;                 // 16-byte quads a backward pass

__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float4* __restrict__ table,
                   const int* __restrict__ ids, float4* __restrict__ out,
                   long long n_ids, int n_rows, int quads) {
  const long long g =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long n = n_ids * quads;
  if (g >= n) return;
  const long long i = g / quads;
  const int q = static_cast<int>(g - i * quads);
  const int id = ids[PTK_IX(ids, i, n_ids)];
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (id >= 0) {
    v = table[PTK_IX(table, static_cast<long long>(id) * quads + q,
                     static_cast<long long>(n_rows) * quads)];
  }
  out[PTK_IX(out, g, n)] = v;
}

template <int Q>
struct Row {
  float4 q[Q];
};

template <int Q>
__device__ __forceinline__ Row<Q> zero_row() {
  Row<Q> r;
#pragma unroll
  for (int k = 0; k < Q; ++k) r.q[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  return r;
}

// a + b, left operand first.
template <int Q>
__device__ __forceinline__ Row<Q> add(const Row<Q>& a, const Row<Q>& b) {
  Row<Q> r;
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    r.q[k] = make_float4(a.q[k].x + b.q[k].x, a.q[k].y + b.q[k].y,
                         a.q[k].z + b.q[k].z, a.q[k].w + b.q[k].w);
  }
  return r;
}

// Quads [q0, q0 + Q) of row `row` of a (rows, stride) float4 array.
template <int Q>
__device__ __forceinline__ Row<Q> load_row(const float4* __restrict__ a,
                                           long long row, long long rows,
                                           int stride, int q0) {
  Row<Q> r;
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    r.q[k] = a[PTK_IX(a, row * stride + q0 + k, rows * stride)];
  }
  return r;
}

template <int Q>
__device__ __forceinline__ void store_row(float4* __restrict__ a,
                                          long long row, long long rows,
                                          int stride, int q0,
                                          const Row<Q>& r) {
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    a[PTK_IX(a, row * stride + q0 + k, rows * stride)] = r.q[k];
  }
}

// A run's sum within the chunk: to the chunk's head slot if the run goes on
// to the left of the chunk (its id is `left`, the id before the chunk), to
// its tail slot if it goes on to the right, else to the table row itself.
template <int Q>
__device__ __forceinline__ void emit(int id, const Row<Q>& sum, int left,
                                     int right, float4* __restrict__ out,
                                     int n_rows, int stride, int q0,
                                     float4* __restrict__ head,
                                     float4* __restrict__ tail,
                                     long long n_chunks) {
  if (id == left) store_row(head, blockIdx.x, n_chunks, Q, 0, sum);
  if (id == right) store_row(tail, blockIdx.x, n_chunks, Q, 0, sum);
  if (id != left && id != right) {
    store_row(out, id, n_rows, stride, q0, sum);
  }
}

template <int Q>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const int* __restrict__ keys,
                   const long long* __restrict__ pos,
                   const float4* __restrict__ grad, float4* __restrict__ out,
                   float4* __restrict__ head, float4* __restrict__ tail,
                   long long n_ids, int n_rows, int stride, int q0) {
  __shared__ Row<Q> s_sum[kThreads];
  __shared__ int s_first[kThreads];
  __shared__ int s_last[kThreads];
  __shared__ int s_flag[kThreads];

  const int t = threadIdx.x;
  const long long n_chunks = (n_ids + kChunk - 1) / kChunk;
  const long long base = static_cast<long long>(blockIdx.x) * kChunk;
  const long long end = min(base + kChunk, n_ids);
  // The ids just outside the chunk (-1, which no run emits, at the ends).
  const int left = base > 0 ? keys[PTK_IX(keys, base - 1, n_ids)] : -1;
  const int right = end < n_ids ? keys[PTK_IX(keys, end, n_ids)] : -1;

  // This thread's kItems positions in order; past the end an id of -1,
  // which is skipped like a miss.
  const long long p0 = base + static_cast<long long>(t) * kItems;
  Row<Q> acc = zero_row<Q>();
  Row<Q> first_sum = zero_row<Q>();
  int first = -1, cur = -1;
  bool multi = false;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long p = p0 + j;
    const int k = p < end ? keys[PTK_IX(keys, p, n_ids)] : -1;
    if (j == 0) {
      first = cur = k;
    } else if (k != cur) {
      if (!multi) {
        first_sum = acc;   // the first run may have begun in earlier threads
      } else if (cur >= 0) {
        // A run between the thread's first and last: whole in this thread,
        // and neither `left` nor `right` (the ids are sorted).
        store_row(out, cur, n_rows, stride, q0, acc);
      }
      multi = true;
      cur = k;
      acc = zero_row<Q>();
    }
    if (k >= 0) {
      acc = add(acc, load_row<Q>(grad, pos[PTK_IX(pos, p, n_ids)], n_ids,
                                 stride, q0));
    }
  }

  // Inclusive segmented scan of the threads' last runs: a segment starts at
  // a thread whose last run begins in it.
  s_first[PTK_IX(s_first, t, kThreads)] = first;
  s_last[PTK_IX(s_last, t, kThreads)] = cur;
  __syncthreads();
  const bool from_left = t > 0 && s_last[PTK_IX(s_last, t - 1, kThreads)] == first;
  int flag = multi || !from_left;
  Row<Q> v = acc;
  for (int d = 1; d < kThreads; d <<= 1) {
    s_sum[PTK_IX(s_sum, t, kThreads)] = v;
    s_flag[PTK_IX(s_flag, t, kThreads)] = flag;
    __syncthreads();
    if (t >= d && !flag) {
      v = add(s_sum[PTK_IX(s_sum, t - d, kThreads)], v);
      flag = s_flag[PTK_IX(s_flag, t - d, kThreads)];
    }
    __syncthreads();
  }
  s_sum[PTK_IX(s_sum, t, kThreads)] = v;
  __syncthreads();

  // The first run of a thread with more than one ends in it: the scan of
  // the threads before it, then its own sum.
  if (multi && first >= 0) {
    const Row<Q> sum = from_left
        ? add(s_sum[PTK_IX(s_sum, t - 1, kThreads)], first_sum)
        : first_sum;
    emit(first, sum, left, right, out, n_rows, stride, q0, head, tail,
         n_chunks);
  }
  // The last run ends here unless the next thread goes on with it.
  const bool to_right =
      t + 1 < kThreads && s_first[PTK_IX(s_first, t + 1, kThreads)] == cur;
  if (!to_right && cur >= 0) {
    emit(cur, v, left, right, out, n_rows, stride, q0, head, tail, n_chunks);
  }
}

// The first position of `keys` (sorted, n_ids) whose id is >= `id`.
__device__ __forceinline__ long long lower_bound(const int* __restrict__ keys,
                                                 long long n_ids, int id) {
  long long lo = 0, hi = n_ids;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (keys[PTK_IX(keys, mid, n_ids)] < id) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <int Q>
__global__ void __launch_bounds__(kThreads)
finish_rows_kernel(const int* __restrict__ keys,
                   const float4* __restrict__ head,
                   const float4* __restrict__ tail, float4* __restrict__ out,
                   long long n_ids, int n_rows, int stride, int q0) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_rows) return;
  const long long n_chunks = (n_ids + kChunk - 1) / kChunk;
  const long long lo = lower_bound(keys, n_ids, r);
  const long long hi = lower_bound(keys, n_ids, r + 1);
  if (lo == hi) {
    store_row(out, r, n_rows, stride, q0, zero_row<Q>());
    return;
  }
  const long long c0 = lo / kChunk;
  const long long c1 = (hi - 1) / kChunk;
  if (c0 == c1) return;   // segment_sum_kernel wrote the row
  Row<Q> sum = load_row<Q>(tail, c0, n_chunks, Q, 0);
  for (long long c = c0 + 1; c <= c1; ++c) {
    sum = add(sum, load_row<Q>(head, c, n_chunks, Q, 0));
  }
  store_row(out, r, n_rows, stride, q0, sum);
}

template <int Q>
cudaError_t backward_pass(const int* keys, const long long* pos,
                          const float4* grad, float4* out, float4* head,
                          float4* tail, long long n_ids, int n_rows,
                          int stride, int q0, cudaStream_t stream) {
  const long long chunks = (n_ids + kChunk - 1) / kChunk;
  if (chunks > 0) {
    segment_sum_kernel<Q><<<static_cast<unsigned>(chunks), kThreads, 0,
                            stream>>>(keys, pos, grad, out, head, tail, n_ids,
                                      n_rows, stride, q0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  finish_rows_kernel<Q><<<(n_rows + kThreads - 1) / kThreads, kThreads, 0,
                          stream>>>(keys, head, tail, out, n_ids, n_rows,
                                    stride, q0);
  return cudaGetLastError();
}

}  // namespace

// Ids a block of the backward sums: the wrapper sizes the partial slots by
// it.
extern "C" int pt_gather_chunk() { return kChunk; }

// out (n_ids, 4 * quads) = rows `ids` of table (n_rows, 4 * quads), zeros
// where an id is < 0; every id must be < n_rows.  Launches on `stream` of
// `device` and returns cudaGetLastError() as an int: 0 when the launch was
// accepted.
extern "C" int pt_gather_rows(const float* table, const int* ids, float* out,
                              long long n_ids, int n_rows, int quads,
                              int device, void* stream) {
  const long long threads = n_ids * quads;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (n_ids < 1 || n_rows < 1 || quads < 1 || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_rows_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(table), ids,
      reinterpret_cast<float4*>(out), n_ids, n_rows, quads);
  return static_cast<int>(cudaGetLastError());
}

// grad_table (n_rows, 4 * quads) = the sum, for each table row, of the rows
// of grad (n_ids, 4 * quads) whose id names it, in the order of `keys` (the
// ids sorted stably) and `pos` (their positions); ids < 0 are skipped, and a
// row no id names is zero.  head and tail: 2 * ceil(n_ids / kChunk) * 4 *
// min(quads, kMaxQuads) floats of scratch, split in two.  Two launches a
// pass of up to kMaxQuads quads on `stream` of `device`; returns
// cudaGetLastError() as an int: 0 when the launches were accepted.
extern "C" int pt_gather_rows_backward(const int* keys, const long long* pos,
                                       const float* grad, float* grad_table,
                                       float* scratch, long long n_ids,
                                       int n_rows, int quads, int device,
                                       void* stream) {
  const long long chunks = (n_ids + kChunk - 1) / kChunk;
  if (n_ids < 0 || n_rows < 1 || quads < 1 || chunks > 0x7fffffffLL ||
      static_cast<long long>(n_rows) * quads > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* g = reinterpret_cast<const float4*>(grad);
  auto* out = reinterpret_cast<float4*>(grad_table);
  auto* head = reinterpret_cast<float4*>(scratch);
  for (int q0 = 0; q0 < quads; q0 += kMaxQuads) {
    const int q = min(kMaxQuads, quads - q0);
    float4* tail = head + chunks * q;
    switch (q) {
      case 1:
        err = backward_pass<1>(keys, pos, g, out, head, tail, n_ids, n_rows,
                               quads, q0, s);
        break;
      case 2:
        err = backward_pass<2>(keys, pos, g, out, head, tail, n_ids, n_rows,
                               quads, q0, s);
        break;
      case 3:
        err = backward_pass<3>(keys, pos, g, out, head, tail, n_ids, n_rows,
                               quads, q0, s);
        break;
      default:
        err = backward_pass<4>(keys, pos, g, out, head, tail, n_ids, n_rows,
                               quads, q0, s);
        break;
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

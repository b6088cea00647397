// sorted_segment_sum: out[s, c] = sum of data[row(i), c] over the i with
// ids[i] == s, added in increasing i, where row(i) = order[i] when an
// order is given and i otherwise; ids are sorted ascending.
//
// Replaces jax.ops.segment_sum(..., indices_are_sorted=True) as
// g4s_tpu/ops/segment.py:23 sorted_segment_sum calls it (XLA, no Pallas
// kernel). On CUDA, index_add_ adds atomically, so its sums land in an
// order that changes from run to run; here every sum has one fixed order.
//
// Design: one thread per (segment, column). It finds the first i of its
// segment by binary search over ids, then walks the run and adds it in
// index order, starting from 0, and writes once: no atomics, no reduction
// across threads. The result is bitwise repeatable and equal to the host
// CPU's index_add_, which adds the same terms in the same order. Empty
// segments write 0; ids outside [0, num_segments) are dropped, as JAX
// drops them. Consecutive threads take consecutive columns of one segment,
// so a row of data is read as one coalesced piece.
//
// Bound: device-memory bytes. Each data element and id is read once, each
// output written once (plus the order entries when given); one add per
// element. The binary search reads about log2(n) ids per thread, mostly
// from L2.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ long long lower_bound(const long long* __restrict__ ids,
                                                 long long n, long long s) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (__ldg(ids + mid) < s) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <typename T>
__global__ void sorted_segment_sum_kernel(const T* __restrict__ data,
                                          const long long* __restrict__ ids,
                                          const long long* __restrict__ order,
                                          long long n, long long d,
                                          T* __restrict__ out,
                                          long long num_segments) {
  const long long total = num_segments * d;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const long long s = t / d;
    const long long c = t - s * d;
    T acc = T(0);
    for (long long i = lower_bound(ids, n, s); i < n && __ldg(ids + i) == s;
         ++i) {
      const long long row = order ? __ldg(order + i) : i;
      acc += __ldg(data + row * d + c);
    }
    out[t] = acc;
  }
}

template <typename T>
int launch(const void* data, const void* ids, const void* order, long long n,
           long long d, void* out, long long num_segments, void* stream) {
  if (n < 0 || d <= 0 || num_segments < 0) return (int)cudaErrorInvalidValue;
  const long long total = num_segments * d;
  if (total == 0) return (int)cudaGetLastError();
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;
  sorted_segment_sum_kernel<T><<<(unsigned)blocks, threads, 0,
                                 (cudaStream_t)stream>>>(
      (const T*)data, (const long long*)ids, (const long long*)order, n, d,
      (T*)out, num_segments);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int g4s_sorted_segment_sum_f32(const void* data, const void* ids,
                                          const void* order, long long n,
                                          long long d, void* out,
                                          long long num_segments,
                                          void* stream) {
  return launch<float>(data, ids, order, n, d, out, num_segments, stream);
}

extern "C" int g4s_sorted_segment_sum_f64(const void* data, const void* ids,
                                          const void* order, long long n,
                                          long long d, void* out,
                                          long long num_segments,
                                          void* stream) {
  return launch<double>(data, ids, order, n, d, out, num_segments, stream);
}

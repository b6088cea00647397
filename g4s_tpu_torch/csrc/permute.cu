// permute_gather: out[i] = z[sigma[i]] for i < m, one static permutation.
//
// Replaces two Pallas kernels of the JAX package, which together with two
// XLA transposes compute exactly this function:
//   g4s_tpu/ops/route.py  _lane_benes_kernel (launched by lane_benes) and
//   g4s_tpu/ops/route.py  _mid_kernel (launched inside apply_permute).
// The TPU executes the permutation as a Clos network of Benes butterflies
// because its gathers are serial; Hopper gathers at memory speed, so the
// whole network collapses into one gather over an int32 sigma.
//
// Bound: device-memory bytes. Per element it reads 4 bytes of sigma and
// writes sizeof(T) of out, both coalesced, and reads sizeof(T) of z at a
// data-dependent address, which costs a 32-byte sector when neighbours do
// not share it. There is no arithmetic to speak of.
//
// Design: a grid-stride loop, one element per thread per step, so sigma and
// out are read and written by consecutive threads at consecutive addresses;
// z goes through the read-only cache (__ldg). The result is bit-exact: it
// is a copy.
//
// sigma must hold values in [0, len(z)); the Python wrapper's plans and the
// dispatcher's RCM orders guarantee this on the host.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void permute_gather_kernel(const T* __restrict__ z,
                                      const int* __restrict__ sigma,
                                      T* __restrict__ out, long long m) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += stride) {
    out[i] = __ldg(z + __ldg(sigma + i));
  }
}

template <typename T>
int launch(const void* z, const void* sigma, void* out, long long m,
           void* stream) {
  if (m <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  long long blocks = (m + threads - 1) / threads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;
  permute_gather_kernel<T><<<(unsigned)blocks, threads, 0,
                             (cudaStream_t)stream>>>(
      (const T*)z, (const int*)sigma, (T*)out, m);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int g4s_permute_gather_f32(const void* z, const void* sigma,
                                      void* out, long long m, void* stream) {
  return launch<float>(z, sigma, out, m, stream);
}

extern "C" int g4s_permute_gather_f64(const void* z, const void* sigma,
                                      void* out, long long m, void* stream) {
  return launch<double>(z, sigma, out, m, stream);
}

// permute_gather: one static permutation with the pad around it fused in.
//
//   out[i] = z[sigma[i]]  for i < m where sigma[i] lies in [0, n_z),
//   out[i] = 0            for i < m where it does not (compared unsigned),
//   out[i] = 0            for m <= i < n_out.
//
// Replaces two Pallas kernels of the JAX package, which together with two
// XLA transposes compute the gather:
//   g4s_tpu/ops/route.py  _lane_benes_kernel (launched by lane_benes) and
//   g4s_tpu/ops/route.py  _mid_kernel (launched inside apply_permute).
// The TPU executes the permutation as a Clos network of Benes butterflies
// because its gathers are serial; Hopper gathers at memory speed, so the
// whole network collapses into one gather over an int32 sigma. The JAX
// callers pad z with zeros to the plan's length and slice the result; the
// zero rules above let the callers here pass z unpadded and ask for a
// padded output, so that pad costs no launches of its own.
//
// Bound: device-memory bytes. The function reads 4 bytes of sigma and
// sizeof(T) of z per gathered element and writes sizeof(T) per output
// element; there is no arithmetic. On the engine's paths sigma is random
// (a renumbered mesh, a random matrix), so neighbouring threads read z at
// unrelated addresses and each 4-byte read of z is a request for its own
// 32-byte sector: about 8x the bytes the bound counts. z is read whole once
// it is in L2 (50 MB), so device memory sees about the bound's bytes; what
// limits the kernel on the H100 is the rate at which L2 serves those
// random sector requests (PERF.md: the same kernel over the identity sigma
// takes half the time at n = 1M).
//
// Design: one output per thread, 256-thread blocks, no grid-stride loop:
// sigma and out move in whole lines per warp instruction, and the grid
// (one thread per output up to n_out) fills the 132 SMs several times
// over at the paths' sizes. Measured on the H100 (PERF.md), this layout
// is as fast warm as any tried and the fastest cold: 4 or 8 outputs per
// thread with 16-byte loads of sigma and stores of out (4 or 8 loads of z
// in flight per thread) and a staged form that reads z in whole lines
// through three shuffles in shared memory (a Clos network, as the TPU
// routes it) were all slower. The load of z is unconditional (index 0 out
// of range; the launcher never gathers with n_z == 0) and a select zeroes
// it, so no branch sits between sigma and z. The result is bit-exact: a
// copy.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
permute_gather_kernel(const T* __restrict__ z, unsigned long long n_z,
                      const int* __restrict__ sigma, long long m,
                      T* __restrict__ out, long long n_out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_out) return;
  T v = T(0);
  if (i < m) {
    const unsigned s = (unsigned)__ldg(sigma + i);
    const bool hit = s < n_z;
    v = __ldg(z + (hit ? s : 0u));
    v = hit ? v : T(0);
  }
  out[i] = v;
}

template <typename T>
int launch(const void* z, long long n_z, const void* sigma, long long m,
           void* out, long long n_out, void* stream) {
  if (n_z < 0 || m < 0 || n_out < m || n_out <= 0)
    return (int)cudaErrorInvalidValue;
  if (n_z == 0) m = 0;   // every output is 0: a zero fill
  const long long blocks = (n_out + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  permute_gather_kernel<T><<<(unsigned)blocks, kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const T*)z, (unsigned long long)n_z, (const int*)sigma, m, (T*)out,
      n_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int g4s_permute_gather_f32(const void* z, long long n_z,
                                      const void* sigma, long long m,
                                      void* out, long long n_out,
                                      void* stream) {
  return launch<float>(z, n_z, sigma, m, out, n_out, stream);
}

extern "C" int g4s_permute_gather_f64(const void* z, long long n_z,
                                      const void* sigma, long long m,
                                      void* out, long long n_out,
                                      void* stream) {
  return launch<double>(z, n_z, sigma, m, out, n_out, stream);
}

// permute_gather: one static permutation with the pad around it fused in.
//
//   out[i] = z[sigma[i]]  for i < m where sigma[i] lies in [0, n_z),
//   out[i] = 0            for i < m where it does not (compared unsigned),
//   out[i] = 0            for m <= i < n_out.
//
// Replaces two Pallas kernels of the JAX package, which together with two
// XLA transposes compute the gather:
//   g4s_tpu/ops/route.py:417  _lane_benes_kernel (launched by lane_benes),
//   g4s_tpu/ops/route.py:438  _mid_kernel (launched inside apply_permute).
// The TPU executes the permutation as a Clos network of Benes butterflies
// because its gathers are serial; Hopper gathers at memory speed, so the
// whole network collapses into one gather over an int32 sigma. The JAX
// callers pad z with zeros to the plan's length and slice the result; the
// zero rules above let the callers here pass z unpadded and ask for a
// padded output, so that pad costs no launches of its own.
//
// What bounds it on the H100: the random reads of z. The bytes bound
// counts 4 bytes of sigma and sizeof(T) of z per gathered element and
// sizeof(T) per output, but on the engine's paths sigma is random (a
// renumbered mesh, a random matrix), so each read of z is a request for a
// 32-byte L2 sector of its own. chip_ab.py times m random reads of z alone
// (no sigma read, no out written) beside this kernel: at the stencil
// permutation (m = 1,030,301; NVIDIA H100 80GB HBM3, 700 W) the reads
// alone take 0.0132-0.0133 ms and the whole f32 gather 0.0137-0.0139, and
// the f64 gather (the same requests, twice the bytes) 0.0142-0.0144. The
// streams of sigma and out already run under the random reads: no
// schedule of them can bring the kernel below those reads.
//
// Design: one output per thread, 256-thread blocks, no grid-stride loop:
// sigma and out move in whole lines per warp instruction, and the grid
// (one thread per output up to n_out) fills the 132 SMs several times
// over at the paths' sizes. The load of z is unconditional (index 0 out
// of range; the launcher never gathers with n_z == 0) and a select zeroes
// it, so no branch sits between sigma and z. The result is bit-exact: a
// copy. Designs measured slower on the H100 (PERF.md section 6 keeps
// every time; f32 at the stencil permutation, warm, against 0.0137-0.0140
// for this kernel in the same runs):
//   - 4 or 8 outputs per thread with 16-byte loads of sigma and stores of
//     out (4 or 8 loads of z in flight per thread): 0.0144-0.0166 ms;
//   - a staged form that reads z in whole lines through three shuffles in
//     shared memory (a Clos network, as the TPU routes it): 0.0179;
//   - a persistent grid whose producer warp brings sigma tiles into a
//     shared-memory ring with TMA bulk copies (mbarrier-completed, L2
//     evict-first) while consumer warps keep 2-16 loads of z in flight per
//     thread (L2 evict-last) and write out by bulk stores or plain ones,
//     at tiles of 512-8,192 outputs and 2-4 stages: 0.0148-0.0164, and
//     9-81 % slower at the other stream paths. Its bulk copy of sigma
//     adds a latency ahead of the first gather, and it hides nothing that
//     this kernel does not already hide.

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

// The launch for an n_out-element output of the given dtype (f64 when
// `f64` is not 0) on the current device, without launching: shape[0..4]
// = outputs per block, threads per block, blocks an SM holds, grid,
// dynamic shared memory bytes per block.
extern "C" int g4s_permute_gather_shape(int f64, long long n_out,
                                        long long* shape) {
  if (n_out <= 0) return (int)cudaErrorInvalidValue;
  int per_sm = 0;
  const cudaError_t e =
      f64 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, permute_gather_kernel<double>, kThreads, 0)
          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, permute_gather_kernel<float>, kThreads, 0);
  if (e) return (int)e;
  const long long v[5] = {kThreads, kThreads, per_sm,
                          (n_out + kThreads - 1) / kThreads, 0};
  for (int i = 0; i < 5; ++i) shape[i] = v[i];
  return (int)cudaSuccess;
}

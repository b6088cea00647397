// wsell_spmv: y = A @ x over the WSELL-K pack, read exactly as the host
// packer lays it out.
//
// Replaces g4s_tpu/ops/pallas_spmv.py _wsell_kernel (launched by
// spmv_wsell_chain, one pallas_call per K-group of tiles).
//
// The pack: rows come in packs of rpp = 8 * (128 / W) rows; each row owns
// W consecutive entries, so in flat order row r's entries sit at
// [r * W, r * W + W). Each entry stores an int16 code slot * 128 + offset
// and an f32 value; its column is starts[pack * k + slot] * 128 + offset,
// where `starts` names the pack's K 128-aligned windows of x. Padding
// entries carry value 0 and code 0, so they read a finite x and add 0,
// exactly as the TPU kernel does.
//
// Bound: device-memory bytes. Per stored slot it moves 2 bytes of code and
// 4 of value, plus x reads (mostly cache hits: a pack's windows are few
// and local after RCM) and 4 bytes of y per row. Arithmetic is one FMA per
// slot.
//
// Design: one thread per row accumulates its W products in f32 and writes
// y once, so no reduction crosses threads. A warp covers 32 consecutive
// rows, i.e. 32 * W consecutive entries: every code and value byte it
// loads is used. For W a multiple of 8 a thread loads its codes 8 at a
// time as one 16-byte int4 and its values as float4 pairs. All tiles run
// in one launch; the pack's K-groups only unrolled the TPU's loops and are
// ignored here. Threads past the packed rows write the zero tail of the
// chain-padded output.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float term(int code, const int* st,
                                      const float* __restrict__ x, float v) {
  const long long col = (long long)__ldg(st + (code >> 7)) * 128 + (code & 127);
  return v * __ldg(x + col);
}

// code j of 8 packed little-endian int16 codes (all non-negative)
__device__ __forceinline__ int code_of(const int4& w, int j) {
  const int word = j < 2 ? w.x : j < 4 ? w.y : j < 6 ? w.z : w.w;
  return (j & 1) ? (int)((unsigned)word >> 16) : (word & 0xFFFF);
}

template <int W>
__global__ void wsell_spmv_kernel(const int* __restrict__ starts,
                                  const int16_t* __restrict__ lanes,
                                  const float* __restrict__ vals,
                                  const float* __restrict__ x,
                                  float* __restrict__ y, long long rows_padded,
                                  long long n_pad, int rows_per_pack,
                                  int k_stride) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       r < n_pad; r += stride) {
    float acc = 0.f;
    if (r < rows_padded) {
      const int* st = starts + (r / rows_per_pack) * k_stride;
      if constexpr (W % 8 == 0) {
        const int4* l4 = reinterpret_cast<const int4*>(lanes + r * W);
        const float4* v4 = reinterpret_cast<const float4*>(vals + r * W);
#pragma unroll
        for (int c = 0; c < W / 8; ++c) {
          const int4 lw = __ldg(l4 + c);
          const float4 va = __ldg(v4 + 2 * c);
          const float4 vb = __ldg(v4 + 2 * c + 1);
          acc += term(code_of(lw, 0), st, x, va.x);
          acc += term(code_of(lw, 1), st, x, va.y);
          acc += term(code_of(lw, 2), st, x, va.z);
          acc += term(code_of(lw, 3), st, x, va.w);
          acc += term(code_of(lw, 4), st, x, vb.x);
          acc += term(code_of(lw, 5), st, x, vb.y);
          acc += term(code_of(lw, 6), st, x, vb.z);
          acc += term(code_of(lw, 7), st, x, vb.w);
        }
      } else {
#pragma unroll
        for (int e = 0; e < W; ++e) {
          acc += term((int)__ldg(lanes + r * W + e), st, x,
                      __ldg(vals + r * W + e));
        }
      }
    }
    y[r] = acc;
  }
}

template <int W>
void launch(const int* starts, const int16_t* lanes, const float* vals,
            const float* x, float* y, long long rows_padded, long long n_pad,
            int rows_per_pack, int k_stride, cudaStream_t stream) {
  const int threads = 256;
  long long blocks = (n_pad + threads - 1) / threads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;
  wsell_spmv_kernel<W><<<(unsigned)blocks, threads, 0, stream>>>(
      starts, lanes, vals, x, y, rows_padded, n_pad, rows_per_pack, k_stride);
}

}  // namespace

extern "C" int g4s_wsell_spmv_f32(const void* starts, const void* lanes,
                                  const void* vals, const void* x, void* y,
                                  long long rows_padded, long long n_pad,
                                  int width, int rows_per_pack, int k_stride,
                                  void* stream) {
  if (n_pad <= 0 || rows_padded > n_pad || rows_per_pack <= 0)
    return (int)cudaErrorInvalidValue;
  const int* s = (const int*)starts;
  const int16_t* l = (const int16_t*)lanes;
  const float* v = (const float*)vals;
  const float* xx = (const float*)x;
  float* yy = (float*)y;
  cudaStream_t st = (cudaStream_t)stream;
  switch (width) {
    case 1: launch<1>(s, l, v, xx, yy, rows_padded, n_pad, rows_per_pack, k_stride, st); break;
    case 2: launch<2>(s, l, v, xx, yy, rows_padded, n_pad, rows_per_pack, k_stride, st); break;
    case 4: launch<4>(s, l, v, xx, yy, rows_padded, n_pad, rows_per_pack, k_stride, st); break;
    case 8: launch<8>(s, l, v, xx, yy, rows_padded, n_pad, rows_per_pack, k_stride, st); break;
    case 16: launch<16>(s, l, v, xx, yy, rows_padded, n_pad, rows_per_pack, k_stride, st); break;
    case 32: launch<32>(s, l, v, xx, yy, rows_padded, n_pad, rows_per_pack, k_stride, st); break;
    case 64: launch<64>(s, l, v, xx, yy, rows_padded, n_pad, rows_per_pack, k_stride, st); break;
    case 128: launch<128>(s, l, v, xx, yy, rows_padded, n_pad, rows_per_pack, k_stride, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

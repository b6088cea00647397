// bwell_spmv: y = A @ x over the BWELL pack, read exactly as the host
// packer lays it out.
//
// Replaces g4s_tpu/ops/pallas_spmv.py _kernel (launched by spmv_bwell).
//
// The pack: rows come in packs of rpp = 8 * (128 / W) rows; each row owns
// W consecutive entries, so in flat order row r's entries sit at
// [r * W, r * W + W). Each entry stores an int32 lane in [0, 256) and an
// f32 value; its column is starts[w(r)] * 128 + lane, where the window w(r)
// is the row's pack (mode "pack") or its gather row of 128 / W consecutive
// rows, 8 per pack (mode "row"). Padding entries carry value 0 and a lane
// in range, so they read a finite x and add 0, as the TPU kernel does. The
// wrapper pads x with 256 zeros past n_cols, so every window read is in
// range and the kernel does no bound checks.
//
// Bound: device-memory bytes. Per stored slot it moves 4 bytes of lane and
// 4 of value, plus x reads (cache hits: a window is 256 floats shared by a
// pack or a gather row) and 4 bytes of y per row. Arithmetic is one FMA per
// slot.
//
// Design: one thread per row sums its W products in f32 (fmaf, no TF32)
// and writes y once, so no reduction crosses threads. A warp covers 32
// consecutive rows, i.e. 32 * W consecutive entries: every lane and value
// byte it loads is used. For W a multiple of 4 a thread loads its lanes as
// int4 and its values as float4. The TPU's two-block staging, lane-select
// pair and one-hot segment matmul existed for its vregs and have no
// counterpart; packs_per_batch only tiled the TPU loop and is not passed.

#include <cuda_runtime.h>

namespace {

template <int W>
__global__ void bwell_spmv_kernel(const int* __restrict__ starts,
                                  const int* __restrict__ lanes,
                                  const float* __restrict__ vals,
                                  const float* __restrict__ x,
                                  float* __restrict__ y,
                                  long long rows_padded, int rows_per_pack,
                                  int row_mode) {
  constexpr int kRowsPerGather = 128 / W;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       r < rows_padded; r += stride) {
    const long long pack = r / rows_per_pack;
    const long long w =
        row_mode ? pack * 8 + (r % rows_per_pack) / kRowsPerGather : pack;
    const float* xw = x + (long long)__ldg(starts + w) * 128;
    float acc = 0.f;
    if constexpr (W % 4 == 0) {
      const int4* l4 = reinterpret_cast<const int4*>(lanes + r * W);
      const float4* v4 = reinterpret_cast<const float4*>(vals + r * W);
#pragma unroll
      for (int c = 0; c < W / 4; ++c) {
        const int4 l = __ldg(l4 + c);
        const float4 v = __ldg(v4 + c);
        acc = fmaf(v.x, __ldg(xw + l.x), acc);
        acc = fmaf(v.y, __ldg(xw + l.y), acc);
        acc = fmaf(v.z, __ldg(xw + l.z), acc);
        acc = fmaf(v.w, __ldg(xw + l.w), acc);
      }
    } else {
#pragma unroll
      for (int e = 0; e < W; ++e) {
        acc = fmaf(__ldg(vals + r * W + e), __ldg(xw + __ldg(lanes + r * W + e)),
                   acc);
      }
    }
    y[r] = acc;
  }
}

template <int W>
void launch(const int* starts, const int* lanes, const float* vals,
            const float* x, float* y, long long rows_padded,
            int rows_per_pack, int row_mode, cudaStream_t stream) {
  const int threads = 256;
  long long blocks = (rows_padded + threads - 1) / threads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;
  bwell_spmv_kernel<W><<<(unsigned)blocks, threads, 0, stream>>>(
      starts, lanes, vals, x, y, rows_padded, rows_per_pack, row_mode);
}

}  // namespace

extern "C" int g4s_bwell_spmv_f32(const void* starts, const void* lanes,
                                  const void* vals, const void* x, void* y,
                                  long long rows_padded, int width,
                                  int rows_per_pack, int row_mode,
                                  void* stream) {
  if (rows_padded <= 0 || width <= 0 || 128 % width != 0 ||
      rows_per_pack != 8 * (128 / width))
    return (int)cudaErrorInvalidValue;
  const int* s = (const int*)starts;
  const int* l = (const int*)lanes;
  const float* v = (const float*)vals;
  const float* xx = (const float*)x;
  float* yy = (float*)y;
  cudaStream_t st = (cudaStream_t)stream;
  switch (width) {
    case 1: launch<1>(s, l, v, xx, yy, rows_padded, rows_per_pack, row_mode, st); break;
    case 2: launch<2>(s, l, v, xx, yy, rows_padded, rows_per_pack, row_mode, st); break;
    case 4: launch<4>(s, l, v, xx, yy, rows_padded, rows_per_pack, row_mode, st); break;
    case 8: launch<8>(s, l, v, xx, yy, rows_padded, rows_per_pack, row_mode, st); break;
    case 16: launch<16>(s, l, v, xx, yy, rows_padded, rows_per_pack, row_mode, st); break;
    case 32: launch<32>(s, l, v, xx, yy, rows_padded, rows_per_pack, row_mode, st); break;
    case 64: launch<64>(s, l, v, xx, yy, rows_padded, rows_per_pack, row_mode, st); break;
    case 128: launch<128>(s, l, v, xx, yy, rows_padded, rows_per_pack, row_mode, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

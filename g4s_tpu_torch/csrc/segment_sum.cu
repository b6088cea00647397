// sorted_segment_sum: out[s, c] = sum of data[row(i), c] over the i with
// ids[i] == s, added in increasing i, where row(i) = order[i] when an
// order is given and i otherwise; ids are sorted ascending.
//
// Replaces jax.ops.segment_sum(..., indices_are_sorted=True) as
// g4s_tpu/ops/segment.py:23 sorted_segment_sum calls it (XLA, no Pallas
// kernel). On CUDA, index_add_ adds atomically, so its sums land in an
// order that changes from run to run; here every sum has one fixed order:
// one thread adds each (segment, column) run, starting from 0, in index
// order, with no atomics and no reduction across threads. The result is
// bitwise repeatable and equal to the host CPU's index_add_, which adds
// the same terms in the same order. Empty segments write 0; ids outside
// [0, num_segments) are dropped, as JAX drops them.
//
// Bound: device-memory bytes. Each gathered data element, id and order
// entry is read once and each output written once; one add per element.
// What held the first design (a thread per (segment, column) with its own
// binary search, then a walk whose every step waited on the load before
// it) was latency, so this one keeps every load of a chunk in flight at
// once and adds from shared memory:
//
// - Partition by rows, once per block. Block b takes rows_per_block rows
//   from row0 = b * rows_per_block and owns the segments whose runs start
//   there: those above ids[row0 - 1] up to ids[row0 + rows_per_block - 1]
//   (the last block owns every segment above its ids). No search: every
//   segment has exactly one owner, and every owned run starts inside the
//   block's rows. Only the last owned run can go on past them, into the
//   rows the next block skips.
// - A chunk of rows goes through shared memory in five steps. (1) Its ids
//   and order entries, read coalesced in one round trip (the first chunk
//   also reads the id before the block; the ownership bounds then come
//   from shared memory). (2) Per row, by ballots over 32 rows: a bit for
//   each run head and for each head the block owns, and each owned row's
//   source offset. (3) The owned rows' data, gathered with cp.async,
//   consecutive threads taking consecutive columns of one row (a 72-byte
//   f64 row of the stencil build is one piece), while one warp numbers
//   the owned runs by a prefix count of their bits. (4) Each owned run's
//   first row and end, in run order. (5) One thread per (owned run,
//   column) adds the run from shared memory in index order and writes
//   the sum (and 0 into the empty segments before it). The first chunk
//   covers the block's rows plus 32 more, so runs of up to 32 rows never
//   need a second chunk.
// - Long runs (CitcomS's layer sums: 1,089 rows) go on chunk by chunk, up
//   to 2,048 rows (2,304 elements) at a time: the block gathers a chunk
//   with every thread and the owning thread adds it, its partial sum
//   carried between chunks in shared memory, so a run costs one add per
//   element from shared memory plus two round trips per chunk.
// - Columns come in tiles of up to 16 (blockIdx.y), so wide rows still
//   fit a chunk; each (segment, column) keeps its one thread and order.
// - ids and order are int32 or int64 (the CitcomS plans pass int32).
//
// Writes go straight from the adding threads: consecutive threads write
// consecutive columns of one segment, and a block's segments are one
// contiguous range, so L2 merges them into whole sectors.
//
// Measured on an H100 (PERF.md, section 6): the kernel is bound by the
// instructions it issues per element, not by waiting on memory. Taking
// the adds out of an earlier design cut about a third of its time and
// taking the gather out a tenth, while a block that walks several chunks
// with the next one's gather in flight behind its adds (two buffers),
// batches of loads issued ahead of the adds, and unrolled element loops
// were no faster. Steps (2) and (4) move the per-element work to rows and
// runs: the gather reads one offset per element, and only owned runs'
// (run, column) pairs add, which took the f64 stencil build from about
// 0.045 to 0.035 ms against a 0.018 ms bound.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_COLS = 16;       // columns per block (a column tile)
constexpr int CHUNK_ELEMS = 2304;  // gathered elements per chunk, 9 a thread
constexpr int MAX_ROWS = 2048;     // rows per chunk
constexpr int LOOKAHEAD = 32;      // rows a block's chunk reads past its own

// rows per chunk for a tile of dc columns: a multiple of 32
__host__ __device__ inline int chunk_rows(int dc) {
  const int r = CHUNK_ELEMS / dc;
  return (r < MAX_ROWS ? r : MAX_ROWS) & ~31;
}

// dynamic shared memory of a chunk: the gathered elements, each row's
// source offset, the ids of its rows and the row after it, their source
// rows, each owned run's first row and end, and per 32 rows the head
// bits, the owned head bits and the owned runs before them
template <typename T, typename I>
__host__ __device__ inline int chunk_smem(int dc) {
  const int rows = chunk_rows(dc);
  return rows * dc * (int)sizeof(T) + rows * 8
         + (2 * rows + 1) * (int)sizeof(I) + 2 * rows * 4
         + 3 * (rows / 32 + 1) * 4;
}

template <typename I> struct Sentinel;  // above every id a block owns
template <> struct Sentinel<int> { static constexpr int value = INT_MAX; };
template <> struct Sentinel<long long> {
  static constexpr long long value = LLONG_MAX;
};

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
               "l"(gmem), "n"(BYTES)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the first run head after row r (bit `rows` is always set)
__device__ __forceinline__ int next_head(const unsigned* heads, int r) {
  int w = (r + 1) >> 5;
  unsigned m = heads[w] & (~0u << ((r + 1) & 31));
  while (!m) m = heads[++w];
  return (w << 5) + __ffs(m) - 1;
}

// acc + buf[r][c] + buf[r + 1][c] + ... + buf[end - 1][c], in that order:
// batches of 8 loads ahead of their adds, then one term at a time (the
// shortest code; variants that issued the loads further ahead ran slower
// at the stencil build, where runs are 1-8 long)
template <typename T>
__device__ __forceinline__ T add_run(const T* buf, int r, int end, int dc,
                                     int c, T acc) {
  const T* p = buf + r * dc + c;
  int k = end - r;
  for (; k >= 8; k -= 8, p += 8 * dc) {
    T v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = p[j * dc];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc += v[j];
  }
  for (; k > 0; --k, p += dc) acc += *p;
  return acc;
}

// element e = tid + k * THREADS of a chunk is (row r, column c) of its
// gathered rows; each step moves to the thread's next element with no
// division
struct Walk {
  int r, c, dr, dcr, dc;
  __device__ Walk(int tid, int dc_)
      : r(tid / dc_), c(tid % dc_), dr(THREADS / dc_), dcr(THREADS % dc_),
        dc(dc_) {}
  __device__ void step() {
    r += dr;
    c += dcr;
    if (c >= dc) {
      c -= dc;
      ++r;
    }
  }
};

template <typename T, typename I>
__global__ void __launch_bounds__(THREADS) sorted_segment_sum_kernel(
    const T* __restrict__ data, const I* __restrict__ ids,
    const I* __restrict__ order, long long n, int d, T* __restrict__ out,
    long long num_segments, long long rows_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T carry[2][MAX_COLS];       // a run's sum between chunks
  __shared__ long long prev_id, next_out;
  __shared__ int open_out, n_runs;

  const int tid = threadIdx.x;
  const int c0 = blockIdx.y * MAX_COLS;
  const int dc = min(MAX_COLS, d - c0);
  const int rows_cap = chunk_rows(dc);
  const int words_cap = rows_cap / 32 + 1;
  T* buf = reinterpret_cast<T*>(smem);
  long long* src = reinterpret_cast<long long*>(buf + rows_cap * dc);
  I* sid = reinterpret_cast<I*>(src + rows_cap);
  I* sord = sid + rows_cap + 1;
  int* run_row = reinterpret_cast<int*>(sord + rows_cap);
  int* run_end = run_row + rows_cap;
  unsigned* heads = reinterpret_cast<unsigned*>(run_end + rows_cap);
  unsigned* owned_heads = heads + words_cap;
  int* before = reinterpret_cast<int*>(owned_heads + words_cap);

  const long long row0 = (long long)blockIdx.x * rows_per_block;
  const long long row_end = min(n, row0 + rows_per_block);
  long long s_lo = 0, s_hi = 0;  // the owned segments, set from chunk 0
  long long next = 0;            // first owned segment not yet written
  bool open = false;             // carry holds a partial sum of `next`
  long long base = row0;
  // the first chunk reads the block's rows and 32 more; a run that goes
  // on past them continues in chunks of rows_cap rows
  const int rows_first =
      (int)min((long long)rows_cap, rows_per_block + LOOKAHEAD);
  for (int j = 0;; ++j) {
    const int rows = (int)min((long long)(j ? rows_cap : rows_first),
                              n - base);
    // 1. the chunk's ids (and the next row's) and order, coalesced, in
    // one round trip; chunk 0 also reads the id before the block
    for (int r = tid; r <= rows; r += THREADS) {
      const long long i = base + r;
      sid[r] = i < n ? ids[i] : Sentinel<I>::value;
      if (r < rows) sord[r] = order ? order[i] : (I)i;
    }
    if (j == 0 && tid == 0)
      prev_id = row0 == 0 ? -1 : (long long)ids[row0 - 1];
    __syncthreads();
    if (j == 0) {
      // the block owns the segments whose runs start in its rows: those
      // above the id before them up to its last row's id (the last block:
      // every segment above)
      s_lo = max(0LL, min(prev_id + 1, num_segments));
      s_hi = row_end == n ? num_segments
                          : max(0LL, min((long long)sid[row_end - 1 - row0]
                                             + 1, num_segments));
      if (s_lo >= s_hi) return;  // inside another block's run
      next = s_lo;
    }
    // 2. per row: a bit for each run head and for each owned one, and
    // the source offset of each owned row (-1 for a row the block skips)
    const I lo = (I)next, hi = (I)s_hi;  // the owned ids still to write
    const int words = rows / 32 + 1;
    for (int g = tid >> 5; g < words; g += WARPS) {
      const int r = g * 32 + (tid & 31);
      bool h = false, own = false;
      if (r <= rows) {
        const I s = sid[r];
        h = r == 0 || r == rows || s != sid[r - 1];
        own = r < rows && s >= lo && s < hi;
        if (r < rows) src[r] = own ? (long long)sord[r] * d + c0 : -1;
      }
      const unsigned m = __ballot_sync(0xffffffffu, h);
      const unsigned mo = __ballot_sync(0xffffffffu, h && own);
      if ((tid & 31) == 0) {
        heads[g] = m;
        owned_heads[g] = mo;
      }
    }
    if (tid == 0) {
      next_out = next;
      open_out = 0;
    }
    __syncthreads();
    // 3. gather the owned rows' elements into buf; the first warp counts
    // the owned runs before each word of head bits
    const int elems = rows * dc;
    Walk w(tid, dc);
    for (int e = tid; e < elems; e += THREADS, w.step()) {
      const long long off = src[w.r];
      if (off >= 0) cp_async<sizeof(T)>(buf + e, data + off + w.c);
    }
    if (tid < 32) {
      int total = 0;
      for (int g0 = 0; g0 < words; g0 += 32) {
        const int g = g0 + tid;
        const int cnt = g < words ? __popc(owned_heads[g]) : 0;
        int x = cnt;
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, x, o);
          if (tid >= o) x += y;
        }
        if (g < words) before[g] = total + x - cnt;
        total += __shfl_sync(0xffffffffu, x, 31);
      }
      if (tid == 0) n_runs = total;
    }
    __syncthreads();
    // 4. the owned runs in order: each one's first row and end
    for (int g = tid >> 5; g < words; g += WARPS) {
      const int lane = tid & 31;
      const unsigned mo = owned_heads[g];
      if ((mo >> lane) & 1u) {
        const int k = before[g] + __popc(mo & ((1u << lane) - 1u));
        run_row[k] = g * 32 + lane;
        run_end[k] = next_head(heads, g * 32 + lane);
      }
    }
    cp_async_wait_all();
    __syncthreads();
    // 5. add each owned run in index order: one thread per (run, column)
    const int tasks = n_runs * dc;
    Walk v(tid, dc);
    for (int t = tid; t < tasks; t += THREADS, v.step()) {
      const int r = run_row[v.r], end = run_end[v.r], c = v.c;
      const long long s = sid[r];
      T acc = open && s == next ? carry[j & 1][c] : T(0);
      acc = add_run(buf, r, end, dc, c, acc);
      // the owned segments between the previous run and this one are empty
      long long g = r == 0 ? next : max((long long)sid[r - 1] + 1, next);
      for (; g < s; ++g) out[g * d + c0 + c] = T(0);
      if (end == rows && (long long)sid[rows] == s) {  // goes on
        carry[(j + 1) & 1][c] = acc;
        if (c == 0) {
          next_out = s;
          open_out = 1;
        }
      } else {
        out[s * d + c0 + c] = acc;
        if (c == 0 && (end == rows || (long long)sid[end] >= s_hi))
          next_out = s + 1;  // the chunk's last owned run
      }
    }
    __syncthreads();
    next = next_out;
    open = open_out;
    if (!open) break;
    base += rows;
  }
  // the owned segments after the last run are empty
  const long long rest = (s_hi - next) * dc;
  for (long long k = tid; k < rest; k += THREADS) {
    const long long s = next + k / dc;
    out[s * d + c0 + (int)(k % dc)] = T(0);
  }
}

template <typename T, typename I>
int launch(const void* data, const void* ids, const void* order, long long n,
           long long d, void* out, long long num_segments, void* stream) {
  if (n < 0 || d <= 0 || d > INT_MAX || num_segments < 0)
    return (int)cudaErrorInvalidValue;
  if (num_segments == 0) return (int)cudaGetLastError();
  // int32 ids: every row index and id below the sentinel
  if (sizeof(I) == 4 && (n >= INT_MAX || num_segments >= INT_MAX))
    return (int)cudaErrorInvalidValue;
  // rows per block: enough blocks (4 per SM of an H100) to keep loads in
  // flight at small n, at most a chunk less the lookahead
  const int dc = d < MAX_COLS ? (int)d : MAX_COLS;
  long long per = (n / (4 * 132) + 31) & ~31LL;
  if (per < 32) per = 32;
  if (per > chunk_rows(dc) - LOOKAHEAD) per = chunk_rows(dc) - LOOKAHEAD;
  long long blocks = n == 0 ? 1 : (n + per - 1) / per;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  // the larger of the first and the last column tile's chunk
  const int last = (int)(d - (d - 1) / MAX_COLS * MAX_COLS);
  const int smem = max(chunk_smem<T, I>(dc), chunk_smem<T, I>(last));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sorted_segment_sum_kernel<T, I>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)blocks, (unsigned)((d + MAX_COLS - 1) / MAX_COLS));
  sorted_segment_sum_kernel<T, I><<<grid, THREADS, smem,
                                    (cudaStream_t)stream>>>(
      (const T*)data, (const I*)ids, (const I*)order, n, (int)d, (T*)out,
      num_segments, per);
  return (int)cudaGetLastError();
}

}  // namespace

#define G4S_SEGMENT_SUM(NAME, T, I)                                        \
  extern "C" int NAME(const void* data, const void* ids, const void* order, \
                      long long n, long long d, void* out,                  \
                      long long num_segments, void* stream) {               \
    return launch<T, I>(data, ids, order, n, d, out, num_segments, stream); \
  }

G4S_SEGMENT_SUM(g4s_sorted_segment_sum_f32, float, long long)
G4S_SEGMENT_SUM(g4s_sorted_segment_sum_f64, double, long long)
G4S_SEGMENT_SUM(g4s_sorted_segment_sum_f32_i32, float, int)
G4S_SEGMENT_SUM(g4s_sorted_segment_sum_f64_i32, double, int)

// Native host-side kernels of g4s_tpu_torch (a copy of the JAX package's
// runtime/native/host_kernels.cc, cut to the entry points the port calls).
//
// The device path is PyTorch + CUDA; these C++ kernels cover the host-side
// work that Cantera's and the SpGEMM suite's own code keeps native:
//   - Matrix-Market body parsing (the data-loader role of the SpGEMM
//     suite's istream reader, mm/inc/CSR.h:480-669),
//   - the SpGEMM symbolic phase (the graph-builder role: expansion map +
//     key sort + duplicate collapse that sizes C exactly, the host analog
//     of hash_mult.h's symbolic pass, done once per sparsity pattern),
//   - the ESC SpGEMM plan core (every O(flop) pass of ops/spgemm_esc.py's
//     esc_plan in a few fused loops and one radix sort).
//
// Exposed with a plain C ABI for ctypes (no pybind11 dependency).
// Build (runtime/native_lib.py does this at first use):
//   g++ -O3 -std=c++17 -shared -fPIC host_kernels.cc -o libg4s_host.so

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <numeric>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Fast text triplet parser. buf: whitespace-separated numbers; fills out
// row-major [n_entries x ncomp]. Returns entries parsed (<= max_entries).
// ---------------------------------------------------------------------------
long g4s_parse_numbers(const char* buf, long len, long ncomp, double* out,
                       long max_entries) {
  const char* p = buf;
  const char* end = buf + len;
  long count = 0;
  long comp = 0;
  while (p < end && count < max_entries) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
      ++p;
    if (p >= end) break;
    char* next = nullptr;
    double v = strtod(p, &next);
    if (next == p) break;  // unparseable garbage
    p = next;
    out[count * ncomp + comp] = v;
    if (++comp == ncomp) {
      comp = 0;
      ++count;
    }
  }
  return count;
}

// ---------------------------------------------------------------------------
// SpGEMM symbolic phase (graph builder). Inputs: CSR of A (m x k) and B
// (k x n). Phase 1 (g4s_spgemm_flops) returns the expansion size F so the
// caller can allocate. Phase 2 fills:
//   src_a[F], src_b[F]  : sorted product -> (A nnz, B nnz) sources
//   slot[F]             : output slot of each product in C.data
//   c_rows/c_cols[<=F]  : structure of C (first *nnz_out entries valid)
// Returns nnz of C.
// ---------------------------------------------------------------------------
long g4s_spgemm_flops(const int64_t* a_indptr, const int64_t* a_indices,
                      long a_rows, const int64_t* b_indptr) {
  long f = 0;
  const long annz = a_indptr[a_rows];
  for (long t = 0; t < annz; ++t) {
    const int64_t k = a_indices[t];
    f += b_indptr[k + 1] - b_indptr[k];
  }
  return f;
}

long g4s_spgemm_symbolic(const int64_t* a_indptr, const int64_t* a_indices,
                         long a_rows, const int64_t* b_indptr,
                         const int64_t* b_indices, long b_cols, long F,
                         int64_t* src_a, int64_t* src_b, int32_t* slot,
                         int64_t* c_rows, int64_t* c_cols) {
  // Thread-parallel over FLOP-balanced row blocks (the role of the
  // reference's BIN prefix-sum work split, mm/inc/BIN.h:100-122).
  // Keys are row-major (r * b_cols + col), and blocks are row-aligned, so
  // per-block sorted runs concatenate into a globally sorted expansion
  // with NO merge step, and duplicate keys never straddle blocks.
  int T = (int)std::thread::hardware_concurrency();
  if (T < 1) T = 1;
  if (T > 16) T = 16;
  if (a_rows < 4 * T) T = 1;

  // expansion offset of each row (prefix sum of per-row flops)
  std::vector<int64_t> rowoff(a_rows + 1, 0);
  for (long r = 0; r < a_rows; ++r) {
    int64_t f = 0;
    for (int64_t t = a_indptr[r]; t < a_indptr[r + 1]; ++t) {
      const int64_t k = a_indices[t];
      f += b_indptr[k + 1] - b_indptr[k];
    }
    rowoff[r + 1] = rowoff[r] + f;
  }

  // row-aligned block boundaries balanced by flops
  std::vector<long> rb(T + 1, a_rows);
  rb[0] = 0;
  for (int t = 1; t < T; ++t) {
    const int64_t target = rowoff[a_rows] * t / T;
    rb[t] = std::lower_bound(rowoff.begin(), rowoff.end(), target)
            - rowoff.begin();
    if (rb[t] > a_rows) rb[t] = a_rows;
    if (rb[t] < rb[t - 1]) rb[t] = rb[t - 1];
  }

  std::vector<int64_t> key(F);
  std::vector<long> block_nnz(T, 0);

  auto expand_block = [&](int t) {
    std::vector<int64_t> order;
    long nnz_local = 0;
    int64_t prev = -1;
    for (long r = rb[t]; r < rb[t + 1]; ++r) {
      const int64_t f0 = rowoff[r];
      long f = f0;
      for (int64_t u = a_indptr[r]; u < a_indptr[r + 1]; ++u) {
        const int64_t k = a_indices[u];
        for (int64_t w = b_indptr[k]; w < b_indptr[k + 1]; ++w) {
          src_a[f] = u;
          src_b[f] = w;
          key[f] = r * b_cols + b_indices[w];
          ++f;
        }
      }
      const long fn = f;
      // sort this row's products by key (stable: deterministic sources)
      order.resize(fn - f0);
      std::iota(order.begin(), order.end(), f0);
      std::stable_sort(order.begin(), order.end(),
                       [&](int64_t x, int64_t y) { return key[x] < key[y]; });
      // apply the permutation in place via temporaries (rows are short)
      std::vector<int64_t> ta(fn - f0), tb(fn - f0), tk(fn - f0);
      for (long i = 0; i < fn - f0; ++i) {
        ta[i] = src_a[order[i]];
        tb[i] = src_b[order[i]];
        tk[i] = key[order[i]];
      }
      for (long i = 0; i < fn - f0; ++i) {
        src_a[f0 + i] = ta[i];
        src_b[f0 + i] = tb[i];
        key[f0 + i] = tk[i];
        if (tk[i] != prev) {
          ++nnz_local;
          prev = tk[i];
        }
      }
    }
    block_nnz[t] = nnz_local;
  };

  if (T == 1) {
    expand_block(0);
  } else {
    std::vector<std::thread> ths;
    for (int t = 0; t < T; ++t) ths.emplace_back(expand_block, t);
    for (auto& th : ths) th.join();
  }

  // global slot bases per block
  std::vector<long> base(T + 1, 0);
  for (int t = 0; t < T; ++t) base[t + 1] = base[t] + block_nnz[t];

  auto fill_block = [&](int t) {
    long nnz = base[t] - 1;
    int64_t prev = -1;
    for (long i = rowoff[rb[t]]; i < rowoff[rb[t + 1]]; ++i) {
      const int64_t kk = key[i];
      if (kk != prev) {
        ++nnz;
        prev = kk;
        c_rows[nnz] = kk / b_cols;
        c_cols[nnz] = kk % b_cols;
      }
      slot[i] = static_cast<int32_t>(nnz);
    }
  };
  if (T == 1) {
    fill_block(0);
  } else {
    std::vector<std::thread> ths;
    for (int t = 0; t < T; ++t) ths.emplace_back(fill_block, t);
    for (auto& th : ths) th.join();
  }
  return base[T];
}

// ---------------------------------------------------------------------------
// ESC SpGEMM plan core: the O(flop) heavy passes of the symbolic phase
// (ops/spgemm_esc.py esc_plan) as fused single-core loops — the host
// graph-builder role the reference keeps native (hash_mult.h:495-508's
// thread-parallel symbolic). The Python side does the K-scale class
// partition (lexsort over active inner columns) and passes class-ordered
// per-block arrays; this kernel emits every flop-scale plan array in a
// handful of memory passes plus one LSD radix sort of the product keys:
//   pass A/B  A-side (CSC order) and B-side (CSR order) ranks + conflict-
//             free spread distances into the class-major slabs
//   pass P    product stream: pad-compaction distances + device sort keys
//   radix     sorted key stream (values only — run metadata depends only
//             on the sorted keys, not on a stable argsort)
//   pass S    run heads -> off_c / d_head / C structure (indices + indptr)
// Replaces ~50 numpy passes (12 s at 7 M flops, 158 s at 67 M) with ~6.
//
// Inputs (class-ordered, one entry per active inner column block):
//   kk[nblk]          inner column index k
//   Mv/Lv[nblk]       real A-column count / B-row length
//   Wv[nblk]          padded B width; Mh[nblk] padded A height
//   a_off/b_off/p_off[nblk]  slab/product offsets (exclusive prefix sums)
// plus CSC(A) arrays, the CSC->CSR position map, CSR(B) arrays and sizes.
// Outputs are preallocated by the caller; meta[8] returns nnz and the max
// shift distances (for stages_for). order_row: 1 = row-major C (CSR),
// 0 = column-major (the HeapSpGEMM role, CSC). two_key: split int32 keys.
// Returns nnz of C, or -1 on inconsistent sizes.
// ---------------------------------------------------------------------------
long g4s_esc_plan_core(
    const int64_t* kk, const int64_t* Mv, const int64_t* Lv,
    const int64_t* Mh, const int64_t* Wv, const int64_t* a_off,
    const int64_t* b_off, const int64_t* p_off, long nblk,
    const int64_t* ac_indptr, const int64_t* ac_rows,
    const int64_t* csc_of_csr, long nnz_a,
    const int64_t* b_indptr, const int64_t* b_indices, long nnz_b,
    long n_min, long n_major, long F, long na, long nb_len, long m2,
    long order_row, long two_key,
    int32_t* a_rank, int32_t* b_rank, int32_t* d_a, int32_t* d_b,
    int32_t* d_pad, int32_t* keys_dev, int32_t* keys_minor,
    int32_t* off_c, int32_t* d_head, int32_t* c_indices,
    int64_t* c_indptr, int64_t* meta) {
  // ---- pass A: CSC entries -> class-major (block, r) rank + spread ----
  for (long t = 0; t < nnz_a; ++t) a_rank[t] = INT32_MAX;
  long ra = 0;
  int64_t max_da = 0;
  for (long b = 0; b < nblk; ++b) {
    const int64_t s = ac_indptr[kk[b]];
    const int64_t dest0 = a_off[b];
    for (int64_t r = 0; r < Mv[b]; ++r) {
      a_rank[csc_of_csr[s + r]] = (int32_t)ra;
      const int64_t d = dest0 + r - ra;
      d_a[ra] = (int32_t)d;
      if (d > max_da) max_da = d;
      ++ra;
    }
  }
  if (ra > na) return -1;
  for (long t = ra; t < na; ++t) d_a[t] = -1;

  // ---- pass B: CSR(B) entries -> class-major block rank + spread -----
  for (long t = 0; t < nnz_b; ++t) b_rank[t] = INT32_MAX;
  long rb = 0;
  int64_t max_db = 0;
  for (long b = 0; b < nblk; ++b) {
    const int64_t s = b_indptr[kk[b]];
    const int64_t dest0 = b_off[b];
    for (int64_t l = 0; l < Lv[b]; ++l) {
      b_rank[s + l] = (int32_t)rb;
      const int64_t d = dest0 + l - rb;
      d_b[rb] = (int32_t)d;
      if (d > max_db) max_db = d;
      ++rb;
    }
  }
  if (rb > nb_len) return -1;
  for (long t = rb; t < nb_len; ++t) d_b[t] = -1;

  // ---- super-bucket offsets from per-major-row flop counts ------------
  // The sorted key order is row-major (all products of C-row r form a
  // contiguous run under kmaj*n_min+kmin), and each row's run length is
  // its flop count — known from the inputs WITHOUT touching the product
  // stream. So the global sort becomes a cache-aware MSD partition:
  // pass P scatters each product's packed (kmaj_lo, kmin) key into its
  // SUPER-bucket (a ~0.5 MB contiguous kmaj row range — few active
  // write streams, so no TLB/cacheline thrash, unlike one cursor per
  // row), then each super-bucket is LSD-radix-sorted entirely in cache.
  // This host is a single throttled core at ~2-4 GB/s with ~100 M
  // random accesses/s: bytes moved and locality ARE the cost model; a
  // flat per-row scatter or a global 16-bit LSD radix both lose 2-4x.
  int64_t* boff = (int64_t*)malloc(sizeof(int64_t) * (size_t)(n_major + 1));
  if (!boff) return -1;
  std::memset(boff, 0, sizeof(int64_t) * (size_t)(n_major + 1));
  if (order_row) {
    for (long b = 0; b < nblk; ++b) {
      const int64_t sA = ac_indptr[kk[b]], Lb = Lv[b];
      for (int64_t r = 0; r < Mv[b]; ++r) boff[ac_rows[sA + r] + 1] += Lb;
    }
  } else {
    for (long b = 0; b < nblk; ++b) {
      const int64_t sB = b_indptr[kk[b]], Mb = Mv[b];
      for (int64_t l = 0; l < Lv[b]; ++l) boff[b_indices[sB + l] + 1] += Mb;
    }
  }
  for (long r = 0; r < n_major; ++r) boff[r + 1] += boff[r];
  if (boff[n_major] != F) {
    free(boff);
    return -1;
  }
  // rows per super-bucket = 2^rshift, targeting ~64k products (~0.5 MB)
  int nmin_bits = 1;
  while ((1L << nmin_bits) < n_min) ++nmin_bits;
  int maj_bits = 1;
  while ((1L << maj_bits) < n_major) ++maj_bits;
  int rshift = 0;
  while ((n_major >> rshift) > std::max(1L, F >> 16)) ++rshift;
  if (rshift > maj_bits) rshift = maj_bits;
  const long nsb = ((n_major - 1) >> rshift) + 1;
  int64_t* sb_off = (int64_t*)malloc(sizeof(int64_t) * (size_t)(nsb + 1));
  int64_t* sb_cur = (int64_t*)malloc(sizeof(int64_t) * (size_t)nsb);
  int64_t* pairs = (int64_t*)malloc(sizeof(int64_t) * (size_t)F);
  if (!sb_off || !sb_cur || !pairs) {
    free(boff); free(sb_off); free(sb_cur); free(pairs);
    return -1;
  }
  for (long s = 0; s <= nsb; ++s)
    sb_off[s] = boff[std::min((int64_t)s << rshift, (int64_t)n_major)];
  std::memcpy(sb_cur, sb_off, sizeof(int64_t) * (size_t)nsb);
  const int64_t lo_mask = (rshift >= 63) ? -1 : ((1L << rshift) - 1);

  // ---- pass P: product stream — pad distances, device sort keys, and
  // the super-bucket scatter of packed (kmaj_lo << nmin_bits) | kmin ---
  std::memset(d_pad, 0, sizeof(int32_t) * m2);
  long f = 0;
  int64_t max_dpad = 0;
  for (long b = 0; b < nblk; ++b) {
    const int64_t k = kk[b];
    const int64_t sA = ac_indptr[k], sB = b_indptr[k];
    const int64_t Wb = Wv[b], Lb = Lv[b];
    int64_t rowpos = p_off[b];
    for (int64_t r = 0; r < Mv[b]; ++r, rowpos += Wb) {
      const int64_t i = ac_rows[sA + r];
      for (int64_t l = 0; l < Lb; ++l) {
        const int64_t j = b_indices[sB + l];
        const int64_t pos = rowpos + l;
        const int64_t d = pos - f;
        d_pad[pos] = (int32_t)d;          // pos is monotone: sequential
        if (d > max_dpad) max_dpad = d;
        const int64_t kmaj = order_row ? i : j;
        const int64_t kmin = order_row ? j : i;
        pairs[sb_cur[kmaj >> rshift]++] =
            ((kmaj & lo_mask) << nmin_bits) | kmin;
        if (two_key) {
          keys_dev[f] = (int32_t)kmaj;
          keys_minor[f] = (int32_t)kmin;
        } else {
          keys_dev[f] = (int32_t)(kmaj * n_min + kmin);
        }
        ++f;
      }
    }
  }
  free(sb_cur);
  if (f != F) {
    free(boff); free(sb_off); free(pairs);
    return -1;
  }

  // ---- per-super-bucket in-cache LSD radix + fused pass S: run heads
  // -> off_c / d_head / C structure ------------------------------------
  const int kbits = rshift + nmin_bits;   // varying bits per packed key
  const int DIG = 11;                      // 2048-entry count table (16 KB)
  const long NDIG = 1L << DIG;
  int64_t max_sb = 0;
  for (long s = 0; s < nsb; ++s)
    max_sb = std::max(max_sb, sb_off[s + 1] - sb_off[s]);
  int64_t* tmp = (int64_t*)malloc(sizeof(int64_t) * (size_t)max_sb);
  int64_t* count = (int64_t*)malloc(sizeof(int64_t) * (size_t)NDIG);
  if ((!tmp && max_sb > 0) || !count) {
    free(boff); free(sb_off); free(pairs); free(tmp); free(count);
    return -1;
  }
  long nnz = 0;
  int64_t max_off = 0, max_dh = 0;
  c_indptr[0] = 0;
  int64_t next_row = 0;                    // c_indptr rows emitted so far
  const int64_t min_mask = (1L << nmin_bits) - 1;
  for (long s = 0; s < nsb; ++s) {
    const int64_t lo = sb_off[s], hi = sb_off[s + 1];
    const long cnt = (long)(hi - lo);
    if (cnt == 0) continue;
    int64_t* src = pairs + lo;
    int64_t* dst = tmp;
    for (int sh = 0; sh < kbits; sh += DIG) {
      std::memset(count, 0, sizeof(int64_t) * (size_t)NDIG);
      for (long t = 0; t < cnt; ++t) ++count[(src[t] >> sh) & (NDIG - 1)];
      int64_t acc = 0;
      for (long d2 = 0; d2 < NDIG; ++d2) {
        const int64_t c = count[d2];
        count[d2] = acc;
        acc += c;
      }
      for (long t = 0; t < cnt; ++t)
        dst[count[(src[t] >> sh) & (NDIG - 1)]++] = src[t];
      std::swap(src, dst);
    }
    // pass S walk over the sorted chunk
    const int64_t row_base = (int64_t)s << rshift;
    int64_t prev = -1, head_pos = lo;
    for (long t = 0; t < cnt; ++t) {
      const int64_t kx = src[t];
      const int64_t p = lo + t;
      if (kx != prev) {
        head_pos = p;
        const int64_t d = p - nnz;
        d_head[p] = (int32_t)d;
        if (d > max_dh) max_dh = d;
        const int64_t row = row_base + (kx >> nmin_bits);
        while (next_row < row) c_indptr[++next_row] = nnz;
        c_indices[nnz] = (int32_t)(kx & min_mask);
        ++nnz;
        prev = kx;
      } else {
        d_head[p] = 0;
      }
      const int64_t o = p - head_pos;
      off_c[p] = (int32_t)o;
      if (o > max_off) max_off = o;
    }
  }
  while (next_row < n_major) c_indptr[++next_row] = nnz;
  free(tmp);
  free(count);
  free(pairs);
  free(sb_off);
  free(boff);

  meta[0] = nnz;
  meta[1] = max_da;
  meta[2] = max_db;
  meta[3] = max_dpad;
  meta[4] = max_off;
  meta[5] = max_dh;
  return nnz;
}

}  // extern "C"

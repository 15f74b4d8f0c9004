// Designs of kernel B2's bin order that tools/b2_sweep.py times against
// the one the port keeps (csrc/cand_rows.cu: the key pass, scan and
// scatter over tiles, the probe a chunk of a coarse bucket a block, put
// in bin order in shared memory, and the unsort over tiles).  Built by
// the sweep alone into its own library; the port never loads it.
//
//   the first design (the port's until the runs): a bin pass (each
//     query's flat bin and its rank there from an atomic count a bin in
//     device memory, 1.9M+ counts on the main table), a scan of the
//     counts (torch.cumsum), a scatter of the permutation a query at a
//     time (perm[ends[bin] - 1 - rank] = q, slot[q] its inverse), the
//     probe in the order of perm (each group reads perm, then its query
//     r[3 perm[s]], then its row), records written at the slot, and an
//     unsort that reads each query's record back by slot[q]: four
//     random accesses a query besides the rows;
//   the wide chunk: the port's chain with the probe at 1024 threads a
//     block (one block an SM) and chunks of up to 8192 queries, so that
//     coarse keys of twice the bins fit a chunk, and tiles make runs
//     twice as long;
//   the 6k chunk: the same keys of twice the bins, with the probe at 512
//     threads a block and chunks of up to 6144 queries, whose records
//     still let two blocks share an SM;
//   the separate sort: the port's key pass, scan and scatter, then a
//     kernel that puts each chunk in bin order in shared memory and
//     writes it back in that order, each record followed by its
//     coarse-order position, and a probe that takes the sorted records
//     coalesced, a group of lanes a query, and writes each result at its
//     coarse-order position; then the port's unsort.
//
// The probe arithmetic (probe_group) is the port's, so every design is
// torch.equal to ops/cand_kernel.py:probe_rows_plain.

#include "../interpolate_unstructured_tpu_torch/csrc/cand_rows.cu"

namespace {

constexpr int kAltThreads = 256;

// Bin pass: each query's flat bin and its rank among its bin's queries,
// from an atomic count a bin.
template <typename R, typename T>
__global__ void alt_bin_pass_kernel(const R* __restrict__ r, int n,
                                    iu::BinGrid<T> bins,
                                    int* __restrict__ counts,
                                    int* __restrict__ bin_out,
                                    int* __restrict__ rank_out) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n) return;
  const int b = flat_bin(bins, r[3 * q + 0], r[3 * q + 1], r[3 * q + 2]);
  bin_out[q] = b;
  rank_out[q] = atomicAdd(counts + b, 1);
}

// Scatter: query q to slot ends[b] - 1 - rank of its bin b (ends: the
// inclusive scan of the counts); slot[q] keeps the way back.
__global__ void alt_bin_scatter_kernel(const int* __restrict__ bin,
                                       const int* __restrict__ rank,
                                       const int* __restrict__ ends, int n,
                                       int* __restrict__ perm,
                                       int* __restrict__ slot) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n) return;
  const int s = ends[bin[q]] - 1 - rank[q];
  perm[s] = q;
  slot[q] = s;
}

// Probe in the order of perm: the group of slot s reads query perm[s] as
// given (float32, the quantized rows of the main table) and writes its
// record at s.
template <int NF, int LAYOUT, bool VEC>
__global__ void __launch_bounds__(kAltThreads)
alt_rows_perm_kernel(const float* __restrict__ table, int W,
                     const float* __restrict__ r,
                     const int* __restrict__ perm, int n, int log2_g,
                     iu::BinGrid<float> bins, int K, int id_role,
                     int count_col, float eps, int ovf_base, float qinv,
                     int n_vars, const int* __restrict__ vroles,
                     int* __restrict__ rec) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int s = (int)(t >> log2_g);
  const int lane = threadIdx.x & ((1 << log2_g) - 1);
  const bool live = s < n;
  const int q = perm[live ? s : 0];
  const float qh[3] = {r[3 * q + 0], r[3 * q + 1], r[3 * q + 2]};
  const float ql[3] = {0.0f, 0.0f, 0.0f};
  probe_group<NF, LAYOUT, VEC, false, float>(
      table, W, live, qh, ql, bins, K, id_role, count_col, eps, ovf_base,
      qinv, n_vars, vroles, ExtRows<float>{nullptr, 0, 0, 0}, log2_g, lane,
      rec, s, 2 + n_vars);
}

// Unsort: query q's record read back from its slot.
__global__ void alt_bin_unsort_kernel(const int* __restrict__ rec,
                                      const int* __restrict__ slot, int n,
                                      int n_vars, int* __restrict__ out_id,
                                      int* __restrict__ out_aux,
                                      float* __restrict__ out_vals) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n) return;
  const int* src = rec + (size_t)slot[q] * (2 + n_vars);
  out_id[q] = src[0];
  out_aux[q] = src[1];
  for (int v = 0; v < n_vars; ++v) {
    out_vals[(size_t)q * n_vars + v] = __int_as_float(src[2 + v]);
  }
}

// The separate sort: a block a chunk (as the port's probe finds it), its
// float32 records counting-sorted by flat bin in shared memory and
// written back at the chunk's positions in that order, 4 words each: x,
// y, z and the record's coarse-order position.
__global__ void __launch_bounds__(kProbeThreads)
alt_chunk_sort_kernel(const int* __restrict__ rec_in,
                      const int* __restrict__ starts,
                      const int* __restrict__ counts,
                      const int* __restrict__ chunk_end, int n_keys,
                      int span_shift, int chunk, iu::BinGrid<float> bins,
                      int* __restrict__ sorted) {
  constexpr int kItems = kMaxChunk / kProbeThreads;
  const int span = 1 << span_shift;
  extern __shared__ __align__(16) int sort_smem[];
  int* srec = sort_smem;          // chunk x 3 words
  int* shist = srec + 3 * chunk;  // span counts
  const int c = blockIdx.x;
  if (c >= chunk_end[n_keys - 1]) return;
  int lo = 0, hi = n_keys - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (chunk_end[mid] > c) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  const int key = lo;
  const int in_bucket = (c - (key > 0 ? chunk_end[key - 1] : 0)) * chunk;
  const int base = starts[key] + in_bucket;
  const int n = min(chunk, counts[key] - in_bucket);
  for (int b = threadIdx.x; b < span; b += kProbeThreads) shist[b] = 0;
  for (int x = threadIdx.x; x < 3 * n; x += kProbeThreads) {
    srec[x] = rec_in[(size_t)base * 3 + x];
  }
  __syncthreads();
  int fine[kItems], local[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int iq = threadIdx.x + it * kProbeThreads;
    if (iq < n) {
      fine[it] = flat_bin(bins, __int_as_float(srec[3 * iq]),
                          __int_as_float(srec[3 * iq + 1]),
                          __int_as_float(srec[3 * iq + 2])) -
                 (key << span_shift);
      local[it] = atomicAdd(shist + fine[it], 1);
    }
  }
  __syncthreads();
  block_scan_smem<kProbeThreads, kMaxSpan / kProbeThreads>(shist, span);
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int iq = threadIdx.x + it * kProbeThreads;
    if (iq < n) {
      int* dst = sorted + (size_t)(base + shist[fine[it]] + local[it]) * 4;
      dst[0] = srec[3 * iq];
      dst[1] = srec[3 * iq + 1];
      dst[2] = srec[3 * iq + 2];
      dst[3] = base + iq;
    }
  }
}

// The probe of the sorted records: the group of position s reads record
// s (coalesced) and writes its result at the record's coarse position.
template <int NF, int LAYOUT, bool VEC>
__global__ void __launch_bounds__(kAltThreads)
alt_rows_sorted_kernel(const float* __restrict__ table, int W,
                       const int* __restrict__ sorted, int n, int log2_g,
                       iu::BinGrid<float> bins, int K, int id_role,
                       int count_col, float eps, int ovf_base, float qinv,
                       int n_vars, const int* __restrict__ vroles,
                       int* __restrict__ rec) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int s = (int)(t >> log2_g);
  const int lane = threadIdx.x & ((1 << log2_g) - 1);
  const bool live = s < n;
  const int4 w = reinterpret_cast<const int4*>(sorted)[live ? s : 0];
  const float qh[3] = {__int_as_float(w.x), __int_as_float(w.y),
                       __int_as_float(w.z)};
  const float ql[3] = {0.0f, 0.0f, 0.0f};
  probe_group<NF, LAYOUT, VEC, false, float>(
      table, W, live, qh, ql, bins, K, id_role, count_col, eps, ovf_base,
      qinv, n_vars, vroles, ExtRows<float>{nullptr, 0, 0, 0}, log2_g, lane,
      rec, w.w, 2 + n_vars);
}

int blocks_of(long long threads) {
  return (int)((threads + kAltThreads - 1) / kAltThreads);
}

}  // namespace

// The first design's entry points, float32 queries and grid.
// alt_bin_pass: counts ((n_bins,) int32, zeroed by the caller), bin_out
// and rank_out ((B,) int32).
extern "C" int alt_bin_pass(const float* r, int n, const float* rmin,
                            const float* inv_h, int nbx, int nby, int nbz,
                            int* counts, int* bin_out, int* rank_out,
                            void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  alt_bin_pass_kernel<float, float>
      <<<blocks_of(n), kAltThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          r, n, iu::BinGrid<float>{rmin, inv_h, nbx, nby, nbz}, counts,
          bin_out, rank_out);
  return (int)cudaGetLastError();
}

// alt_bin_scatter: perm and slot ((B,) int32) from bin, rank and ends.
extern "C" int alt_bin_scatter(const int* bin, const int* rank,
                               const int* ends, int n, int* perm, int* slot,
                               void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  alt_bin_scatter_kernel<<<blocks_of(n), kAltThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      bin, rank, ends, n, perm, slot);
  return (int)cudaGetLastError();
}

// alt_rows_perm: the probe in the order of perm of a quantized tet table
// with 16-byte rows (layout 0, nf 4, K % 4 == 0), records (B, 2 +
// n_vars) by slot.
extern "C" int alt_rows_perm(const float* table, int W, const float* r,
                             const int* perm, int n, int lanes,
                             const float* rmin, const float* inv_h, int nbx,
                             int nby, int nbz, int K, int id_role,
                             int count_col, float eps, int ovf_base,
                             float qinv, int n_vars, const int* vroles,
                             int* rec, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (K % 4 != 0 || W % 4 != 0 || lanes < 1 || lanes > 32 ||
      (lanes & (lanes - 1)) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  alt_rows_perm_kernel<4, 0, true>
      <<<blocks_of((long long)n * lanes), kAltThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          table, W, r, perm, n, __builtin_ctz(lanes),
          iu::BinGrid<float>{rmin, inv_h, nbx, nby, nbz}, K, id_role,
          count_col, eps, ovf_base, qinv, n_vars, vroles, rec);
  return (int)cudaGetLastError();
}

// alt_bin_unsort: records by slot back in query order.
extern "C" int alt_bin_unsort(const int* rec, const int* slot, int n,
                              int n_vars, int* out_id, int* out_aux,
                              float* out_vals, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  alt_bin_unsort_kernel<<<blocks_of(n), kAltThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      rec, slot, n, n_vars, out_id, out_aux, out_vals);
  return (int)cudaGetLastError();
}

// alt_chunk_sort: the port's scatter records (float32, 3 words) of each
// chunk in bin order, (B, 4) words into sorted.
extern "C" int alt_chunk_sort(const int* rec_in, const int* starts,
                              const int* counts, const int* chunk_end,
                              int n_keys, int span_shift, int chunk,
                              int max_chunks, const float* rmin,
                              const float* inv_h, int nbx, int nby, int nbz,
                              int* sorted, void* stream) {
  if (max_chunks <= 0) return (int)cudaSuccess;
  if (chunk > kMaxChunk || (1 << span_shift) > kMaxSpan) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(int) * (3 * (size_t)chunk + (1 << span_shift));
  static unsigned allowed = 0;
  const cudaError_t err = allow_smem(alt_chunk_sort_kernel, &allowed);
  if (err != cudaSuccess) return (int)err;
  alt_chunk_sort_kernel<<<max_chunks, kProbeThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      rec_in, starts, counts, chunk_end, n_keys, span_shift, chunk,
      iu::BinGrid<float>{rmin, inv_h, nbx, nby, nbz}, sorted);
  return (int)cudaGetLastError();
}

// alt_rows_sorted: the probe of the sorted records (layout 0, nf 4, 16-byte
// rows), results (B, 2 + n_vars) in coarse order.
extern "C" int alt_rows_sorted(const float* table, int W, const int* sorted,
                               int n, int lanes, const float* rmin,
                               const float* inv_h, int nbx, int nby, int nbz,
                               int K, int id_role, int count_col, float eps,
                               int ovf_base, float qinv, int n_vars,
                               const int* vroles, int* rec, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (K % 4 != 0 || W % 4 != 0 || lanes < 1 || lanes > 32 ||
      (lanes & (lanes - 1)) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  alt_rows_sorted_kernel<4, 0, true>
      <<<blocks_of((long long)n * lanes), kAltThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          table, W, sorted, n, __builtin_ctz(lanes),
          iu::BinGrid<float>{rmin, inv_h, nbx, nby, nbz}, K, id_role,
          count_col, eps, ovf_base, qinv, n_vars, vroles, rec);
  return (int)cudaGetLastError();
}

// The port's chunk probe at THREADS threads a block and chunks of up to
// CHUNK queries, for a quantized tet table with 16-byte rows (layout 0,
// nf 4, K % 4 == 0), no extension rows; arguments as
// iu_cand_rows_chunked's.
template <int THREADS, int CHUNK>
int alt_rows_chunked_as(
    const float* table, int W, const int* rec_in, const int* starts,
    const int* counts, const int* chunk_end, int n_keys, int span_shift,
    int chunk, int max_chunks, int lanes, const float* rmin,
    const float* inv_h, int nbx, int nby, int nbz, int K, int id_role,
    int count_col, float eps, int ovf_base, float qinv, int n_vars,
    const int* vroles, int* rec_out, void* stream) {
  if (max_chunks <= 0) return (int)cudaSuccess;
  if (K % 4 != 0 || W % 4 != 0 || lanes < 1 || lanes > 32 ||
      (lanes & (lanes - 1)) != 0 || chunk < 1 || chunk > CHUNK ||
      (1 << span_shift) > kMaxSpan || n_keys < 1 || n_keys > kMaxKeys) {
    return (int)cudaErrorInvalidValue;
  }
  const int os = 2 + n_vars, sw = os > 3 ? os : 3;
  const size_t smem = sizeof(int) * ((size_t)chunk * sw + (1 << span_shift)) +
                      sizeof(unsigned short) * (size_t)chunk;
  if (smem > (size_t)kSmemCap) return (int)cudaErrorInvalidValue;
  auto kernel = cand_rows_chunk_kernel<4, 0, true, false, float, THREADS,
                                       CHUNK>;
  static unsigned allowed = 0;
  const cudaError_t err = allow_smem(kernel, &allowed);
  if (err != cudaSuccess) return (int)err;
  kernel<<<max_chunks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      table, W, rec_in, starts, counts, chunk_end, n_keys, span_shift, chunk,
      __builtin_ctz(lanes), iu::BinGrid<float>{rmin, inv_h, nbx, nby, nbz},
      K, id_role, count_col, eps, ovf_base, qinv, n_vars, vroles, rec_out,
      ExtRows<float>{nullptr, 0, 0, 0});
  return (int)cudaGetLastError();
}

#define IU_ALT_CHUNKED(NAME_, THREADS_, CHUNK_)                              \
  extern "C" int NAME_(                                                      \
      const float* table, int W, const int* rec_in, const int* starts,       \
      const int* counts, const int* chunk_end, int n_keys, int span_shift,   \
      int chunk, int max_chunks, int lanes, const float* rmin,               \
      const float* inv_h, int nbx, int nby, int nbz, int K, int id_role,     \
      int count_col, float eps, int ovf_base, float qinv, int n_vars,        \
      const int* vroles, int* rec_out, void* stream) {                       \
    return alt_rows_chunked_as<THREADS_, CHUNK_>(                            \
        table, W, rec_in, starts, counts, chunk_end, n_keys, span_shift,     \
        chunk, max_chunks, lanes, rmin, inv_h, nbx, nby, nbz, K, id_role,    \
        count_col, eps, ovf_base, qinv, n_vars, vroles, rec_out, stream);    \
  }

// alt_rows_chunked_wide: 1024 threads a block (one block an SM), chunks of
// up to 8192 queries.
IU_ALT_CHUNKED(alt_rows_chunked_wide, 1024, 8192)
// alt_rows_chunked_6k: 512 threads a block, chunks of up to 6144 queries,
// whose records (12 bytes a query) still let two blocks share an SM.
IU_ALT_CHUNKED(alt_rows_chunked_6k, 512, 6144)
#undef IU_ALT_CHUNKED

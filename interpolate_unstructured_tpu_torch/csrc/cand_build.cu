// Device candidate-bin construction: kernel D1 (a counting sort of the
// kept (bin, cell) pairs into their bins, in two launches of one kernel)
// and kernel D2 (each bin's bucket ordered on chip and written to the id
// tables): build_candidate_bins_device (ops/cand_build.py) on a CUDA
// grid.
//
// No Pallas kernel is replaced: the JAX package builds the lists in XLA,
// interpolate_unstructured_tpu/ops/cand_build.py:_gen_pairs (:56, an
// unrolled loop over the bin offsets that gives every (offset, cell) slot
// a key, n_bins for a dropped slot), lax.sort((key, -score, cell),
// num_keys=2, is_stable=True) in _sort_rank_count (:114) over all the
// slots, and _fill_tables (:135, scatters by rank).  That sort orders the
// kept pairs by (bin, score_order, slot): a counting sort into the bins,
// which are known ahead, then a small sort inside each bin.
//
// D1, cand_bin_kernel<NF, kWrite, T>: pair slot s = o * C + c,
// offset-major as the JAX package stacks its per-offset arrays; offset o
// decodes to (i, j, k) within smax.  One thread takes one cell and a
// strided set of its offsets (group, + groups, ...); a block of cells'
// groups are neighbouring blocks, so the cells are swept once, in order.
// The count pass takes few groups (a cell's inputs read once for many
// offsets), the write pass one offset a thread (more stores in flight).
// Per
// slot, in the grid's dtype T and in _gen_pairs' operation order (built
// with --fmad=false): the bin center rmin + ((T)b + 0.5) * h (zc for z in
// a planar mesh), each face's projection (n0*cbx + n1*cby) + n2*cbz,
// separated = any(proj - reach > off + eps).  A slot outside the cell's
// span or separated is dropped and writes nothing.
//   count pass (kWrite false): each kept pair adds one to its bin's count.
//   write pass (kWrite true): next[] starts as the exclusive scan of the
//   counts; a kept pair takes position atomicAdd(&next[bin], 1) and writes
//   one 64-bit record (score_order << 32) | slot, score = (float)min(off -
//   proj) with NaN propagating, score_order the order-preserving bits of
//   -score (-0 and subnormals as +0, every NaN as one value above +inf, as
//   lax.sort compares float32 in the JAX package).
// After the write pass each bin's records fill its bucket [start, start +
// count) in an order the atomics chose.  Plain version:
// ops/cand_build.py:bin_pairs_plain (records in canonical order).
//
// D2, cand_order_*_kernel: ascending order of a bucket's records is the
// JAX order inside the bin (score descending, ties by slot); rank r <
// k_max goes to cand_ids[bin, r], k_max <= r < k_max + k_ext of an
// overflowing bin to ext_ids[ext_slot[bin], r - k_max], the cell being
// slot % C; every other entry of those rows is -1, so the tables need no
// fill beforehand.  Three routes by bucket size, all in the kernel:
//   up to 32 records: a record a lane, each record's rank counted over
//     the bucket by shuffles, one warp for 32 consecutive bins whose
//     counts and starts it reads at once (cand_order_warp_kernel,
//     launched over every bin; it hands larger bins on in two lists);
//   up to kSortRecords: one block a bin, a bitonic sort in shared memory
//     (cand_order_block_kernel, launched only where such bins occur);
//   larger: each record's rank by counting the smaller records of its
//     bucket, tiled through shared memory, only ranks < k_max + k_ext
//     written (cand_order_rank_kernel).
// The tables do not depend on the order inside a bucket.  Plain version:
// ops/cand_build.py:fill_tables_plain.
//
// What bounds them on an H100: bytes.  For the 998,250-tet box in float32
// (64 offsets, 19,789,566 kept pairs of 63,888,000 slots): the count pass
// reads 88 MB of cell inputs and updates 7.8 MB of counts; the write pass
// reads them again and writes 158 MB of records; D2 reads the records and
// writes 188 MB of tables.  The arithmetic, ~50 float32 operations a slot,
// takes a tenth of the count pass's time.  Only kept pairs are written
// (31% of the slots), each once, and no general sort runs.  Measured, the
// write pass is set by its scattered 8-byte stores, whose sectors leave
// the L2 half written when a bin's cells lie far apart in the mesh's
// order (tools/cand_build_sweep.py, PERF.md).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// Threads D1's count pass aims for: with fewer cells, more offset groups
constexpr long long kPairThreads = 1 << 21;
constexpr unsigned int kNanOrder = 0xFFC00000u;
constexpr unsigned long long kPad = ~0ull;  // above every record
// Largest bucket D2 sorts in one block's shared memory (128 KB)
constexpr int kSortRecords = 16384;
constexpr int kSortThreads = 512;
constexpr int kSortBlocks = 1024;
constexpr int kRankThreads = 256;
constexpr int kRankTile = 2048;
constexpr int kRankBlocks = 2048;

// Low half of a sort word: unsigned order of the result is float order
// of -score, -0 and subnormals as +0, every NaN above +inf
// (ops/cand_build.py:score_order)
__device__ __forceinline__ unsigned int score_order(float score) {
  const float neg = -score;
  if (isnan(neg)) return kNanOrder;
  unsigned int b = __float_as_uint(neg);
  if ((b & 0x7F800000u) == 0u) b = 0u;  // -0 and subnormals as +0
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// NaN-propagating min, as jnp.min and torch.amin reduce
template <typename T>
__device__ __forceinline__ T min_nan(T a, T b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return b < a ? b : a;
}

template <typename T>
struct BinFrame {
  T half[3], rmin[3], h[3];
  T eps, zc;
};

template <int NF, bool kWrite, typename T>
__global__ void __launch_bounds__(kThreads) cand_bin_kernel(
    const T* __restrict__ normals, const T* __restrict__ offs,
    const int* __restrict__ b0, const int* __restrict__ span, int n_cells,
    int s1, int s2, int n_offsets, int groups, int nby, int nbz,
    BinFrame<T> fr, int use_zc, int* __restrict__ counter,
    unsigned long long* __restrict__ rec) {
  const int group = blockIdx.x % groups;
  const int c = (blockIdx.x / groups) * kThreads + threadIdx.x;
  if (c >= n_cells) return;
  T n[NF][3], reach[NF], off[NF], off_eps[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
#pragma unroll
    for (int d = 0; d < 3; ++d) n[f][d] = normals[(c * NF + f) * 3 + d];
    reach[f] = (fabs(n[f][0]) * fr.half[0] + fabs(n[f][1]) * fr.half[1]) +
               fabs(n[f][2]) * fr.half[2];
    off[f] = offs[c * NF + f];
    off_eps[f] = off[f] + fr.eps;
  }
  const int bx0 = b0[c * 3], by0 = b0[c * 3 + 1], bz0 = b0[c * 3 + 2];
  const int sx = span[c * 3], sy = span[c * 3 + 1], sz = span[c * 3 + 2];
  for (int o = group; o < n_offsets; o += groups) {
    const int k = o % s2;
    const int t = o / s2;
    const int j = t % s1;
    const int i = t / s1;
    if (i >= sx || j >= sy || k >= sz) continue;
    const int bx = bx0 + i, by = by0 + j, bz = bz0 + k;
    const T cbx = fr.rmin[0] + ((T)bx + (T)0.5) * fr.h[0];
    const T cby = fr.rmin[1] + ((T)by + (T)0.5) * fr.h[1];
    const T cbz = use_zc ? fr.zc : fr.rmin[2] + ((T)bz + (T)0.5) * fr.h[2];
    bool separated = false;
    T m = 0;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const T proj = (n[f][0] * cbx + n[f][1] * cby) + n[f][2] * cbz;
      separated |= (proj - reach[f]) > off_eps[f];
      if constexpr (kWrite) {
        const T d = off[f] - proj;
        m = f == 0 ? d : min_nan(m, d);
      }
    }
    if (separated) continue;
    const int pbin = (bx * nby + by) * nbz + bz;
    if constexpr (kWrite) {
      const int pos = atomicAdd(&counter[pbin], 1);
      rec[pos] = ((unsigned long long)score_order((float)m) << 32) |
                 (unsigned int)(o * n_cells + c);
    } else {
      atomicAdd(&counter[pbin], 1);
    }
  }
}

__device__ __forceinline__ int rec_cell(unsigned long long r, int n_cells) {
  return (int)((unsigned int)r % (unsigned int)n_cells);
}

// Rank r of a bin's ordered records: main row below k_max, extension row
// (e >= 0) below k_max + k_ext
__device__ __forceinline__ void put_rank(int* cand_ids, int* ext_ids,
                                         int bin, int e, int k_max,
                                         int k_ext, int r, int cell) {
  if (r < k_max) {
    cand_ids[(size_t)bin * k_max + r] = cell;
  } else if (e >= 0 && r < k_max + k_ext) {
    ext_ids[(size_t)e * k_ext + (r - k_max)] = cell;
  }
}

// One warp for 32 consecutive bins, one after another.  Lane i reads bin
// i's count, start and extension slot at once; a bin of at most 32
// records puts record r in lane r, whose rank is the number of the
// bucket's records below it, counted over n shuffles, and the warp writes
// its whole rows while the next bin's records load.  Larger bins go to
// work's lists: work[0] / work[1] count the block route's and the rank
// route's bins, work[2 ..] and work[2 + cap ..] list them.
__global__ void __launch_bounds__(kThreads) cand_order_warp_kernel(
    const unsigned long long* __restrict__ rec, const int* __restrict__ start,
    const int* __restrict__ counts, const int* __restrict__ ext_slot,
    int n_bins, int n_cells, int k_max, int k_ext,
    int* __restrict__ cand_ids, int* __restrict__ ext_ids,
    int* __restrict__ work, int cap) {
  const long long first =
      (((long long)blockIdx.x * kThreads + threadIdx.x) >> 5) * 32;
  const int lane = threadIdx.x & 31;
  if (first >= n_bins) return;  // the whole warp
  const int bins = (int)min(32LL, n_bins - first);
  const int mine = (int)first + lane;
  const int my_n = lane < bins ? counts[mine] : 0;
  const int my_s = lane < bins ? start[mine] : 0;
  const int my_e = my_n > k_max ? ext_slot[mine] : -1;
  if (my_n > 32) {
    const int route = my_n > kSortRecords;
    const int w = atomicAdd(&work[route], 1);
    work[2 + route * cap + w] = mine;
  }
  auto load = [&](int b) {
    const int n = __shfl_sync(0xffffffffu, my_n, b);
    const int s = __shfl_sync(0xffffffffu, my_s, b);
    return n <= 32 && lane < n ? rec[s + lane] : kPad;
  };
  unsigned long long next = load(0);
  for (int b = 0; b < bins; ++b) {
    const unsigned long long v = next;
    if (b + 1 < bins) next = load(b + 1);
    const int n = __shfl_sync(0xffffffffu, my_n, b);
    const int e = __shfl_sync(0xffffffffu, my_e, b);
    if (n > 32) continue;
    const int bin = (int)first + b;
    int rank = 0;
    for (int q = 0; q < n; ++q) rank += __shfl_sync(0xffffffffu, v, q) < v;
    if (lane < n)
      put_rank(cand_ids, ext_ids, bin, e, k_max, k_ext, rank,
               rec_cell(v, n_cells));
    int* row = cand_ids + (size_t)bin * k_max;
    for (int r = n + lane; r < k_max; r += 32) row[r] = -1;
    if (e >= 0)
      for (int r = max(n - k_max, 0) + lane; r < k_ext; r += 32)
        ext_ids[(size_t)e * k_ext + r] = -1;
  }
}

// One block a bin of 33 .. kSortRecords records (work's first list): the
// bucket padded to a power of two in shared memory, bitonic sort, rows.
__global__ void __launch_bounds__(kSortThreads) cand_order_block_kernel(
    const unsigned long long* __restrict__ rec, const int* __restrict__ start,
    const int* __restrict__ counts, const int* __restrict__ ext_slot,
    int n_cells, int k_max, int k_ext, int* __restrict__ cand_ids,
    int* __restrict__ ext_ids, const int* __restrict__ work) {
  extern __shared__ unsigned long long sh[];
  const int n_list = work[0];
  for (int w = blockIdx.x; w < n_list; w += gridDim.x) {
    const int bin = work[2 + w];
    const int n = counts[bin], s = start[bin];
    int p = 64;
    while (p < n) p <<= 1;
    for (int i = threadIdx.x; i < p; i += kSortThreads)
      sh[i] = i < n ? rec[s + i] : kPad;
    __syncthreads();
    for (int k = 2; k <= p; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = threadIdx.x; i < p; i += kSortThreads) {
          const int x = i ^ j;
          if (x > i) {
            const unsigned long long a = sh[i], b = sh[x];
            if ((a > b) == ((i & k) == 0)) {
              sh[i] = b;
              sh[x] = a;
            }
          }
        }
        __syncthreads();
      }
    }
    const int e = n > k_max ? ext_slot[bin] : -1;
    const int rows = k_max + (e >= 0 ? k_ext : 0);
    for (int r = threadIdx.x; r < rows; r += kSortThreads)
      put_rank(cand_ids, ext_ids, bin, e, k_max, k_ext, r,
               r < n ? rec_cell(sh[r], n_cells) : -1);
    __syncthreads();  // sh is the next bin's
  }
}

// Bins past kSortRecords (work's second list), one after another: each
// record's rank is the number of smaller records in its bucket, counted
// over tiles of the bucket in shared memory by every block; a block stops
// once all its records rank past the rows.  Block 0 writes -1 at the
// ranks the bucket does not reach.
__global__ void __launch_bounds__(kRankThreads) cand_order_rank_kernel(
    const unsigned long long* __restrict__ rec, const int* __restrict__ start,
    const int* __restrict__ counts, const int* __restrict__ ext_slot,
    int n_cells, int k_max, int k_ext, int* __restrict__ cand_ids,
    int* __restrict__ ext_ids, const int* __restrict__ work, int cap) {
  __shared__ unsigned long long tile[kRankTile];
  const int n_list = work[1];
  for (int w = 0; w < n_list; ++w) {
    const int bin = work[2 + cap + w];
    const int n = counts[bin], s = start[bin];
    const int e = n > k_max ? ext_slot[bin] : -1;
    const int rows = k_max + (e >= 0 ? k_ext : 0);
    const int n_chunks = (n + kRankThreads - 1) / kRankThreads;
    for (int chunk = blockIdx.x; chunk < n_chunks; chunk += gridDim.x) {
      const int i = chunk * kRankThreads + threadIdx.x;
      const unsigned long long mine = i < n ? rec[s + i] : kPad;
      int rank = 0;
      for (int t0 = 0; t0 < n; t0 += kRankTile) {
        if (__syncthreads_and(i >= n || rank >= rows)) break;
        const int m = min(kRankTile, n - t0);
        for (int t = threadIdx.x; t < m; t += kRankThreads)
          tile[t] = rec[s + t0 + t];
        __syncthreads();
        for (int t = 0; t < m; ++t) rank += tile[t] < mine;
      }
      __syncthreads();  // tile is the next chunk's
      if (i < n && rank < rows)
        put_rank(cand_ids, ext_ids, bin, e, k_max, k_ext, rank,
                 rec_cell(mine, n_cells));
    }
    if (blockIdx.x == 0)
      for (int r = n + threadIdx.x; r < rows; r += kRankThreads)
        put_rank(cand_ids, ext_ids, bin, e, k_max, k_ext, r, -1);
  }
}

template <int NF, bool kWrite, typename T>
void launch_bin(const void* normals, const void* offs, const int* b0,
                const int* span, int n_cells, const int* smax, int nby,
                int nbz, const double* frame, int use_zc, int* counter,
                unsigned long long* rec, cudaStream_t s) {
  BinFrame<T> fr;
  for (int d = 0; d < 3; ++d) {
    fr.half[d] = (T)frame[d];
    fr.rmin[d] = (T)frame[3 + d];
    fr.h[d] = (T)frame[6 + d];
  }
  fr.eps = (T)frame[9];
  fr.zc = (T)frame[10];
  const int n_offsets = smax[0] * smax[1] * smax[2];
  long long groups = n_offsets;
  if (!kWrite) {
    groups = (kPairThreads + n_cells - 1) / n_cells;
    if (groups > n_offsets) groups = n_offsets;
    if (groups < 1) groups = 1;
  }
  const long long blocks = (n_cells + kThreads - 1) / kThreads * groups;
  cand_bin_kernel<NF, kWrite, T><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const T*>(normals), static_cast<const T*>(offs), b0, span,
      n_cells, smax[1], smax[2], n_offsets, (int)groups, nby, nbz, fr,
      use_zc, counter, rec);
}

template <bool kWrite>
int dispatch_bin(const void* normals, const void* offs, const int* b0,
                 const int* span, int n_cells, int nf, int f64,
                 const int* smax, int nby, int nbz, const double* frame,
                 int use_zc, int* counter, unsigned long long* rec,
                 cudaStream_t s) {
#define IU_BIN(NF_, T_)                                                      \
  launch_bin<NF_, kWrite, T_>(normals, offs, b0, span, n_cells, smax, nby,  \
                              nbz, frame, use_zc, counter, rec, s)
  if (nf == 3 && f64) {
    IU_BIN(3, double);
  } else if (nf == 3) {
    IU_BIN(3, float);
  } else if (nf == 4 && f64) {
    IU_BIN(4, double);
  } else if (nf == 4) {
    IU_BIN(4, float);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef IU_BIN
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point of D1 (bound with ctypes).  normals (C, nf, 3) and
// offs (C, nf) float32 (f64 = 0) or float64 (f64 = 1); b0, span (C, 3)
// int32; smax: host int[3], the offset grid; frame: host double[11], the
// bin half-size, origin and size (3 each), the separation eps and zc,
// rounded to the dtype here.  write = 0, the count pass: counter
// (n_bins,) int32 zeroed by the caller, rec unused.  write = 1, the write
// pass: counter (n_bins,) int32 holding each bin's first position, rec
// (kept pairs,) uint64.
extern "C" int iu_cand_bin(const void* normals, const void* offs,
                           const int* b0, const int* span, int n_cells,
                           int nf, int f64, const int* smax, int nby,
                           int nbz, const double* frame, int use_zc,
                           int write, int* counter, unsigned long long* rec,
                           void* stream) {
  if (n_cells <= 0) return (int)cudaSuccess;
  if (smax[0] < 1 || smax[1] < 1 || smax[2] < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return write ? dispatch_bin<true>(normals, offs, b0, span, n_cells, nf, f64,
                                    smax, nby, nbz, frame, use_zc, counter,
                                    rec, s)
               : dispatch_bin<false>(normals, offs, b0, span, n_cells, nf,
                                     f64, smax, nby, nbz, frame, use_zc,
                                     counter, rec, s);
}

// Plain C entry point of D2.  rec: the write pass's records, bucket by
// bucket; start, counts, ext_slot (n_bins,) int32; cand_ids (n_bins,
// k_max) and ext_ids (n_over, k_ext) int32, every entry written here.
// max_count: the largest count.  Above 32, work: 2 + 2 * cap int32, the
// first two zeroed by the caller, cap at least the bins holding more than
// 32 records.
extern "C" int iu_cand_order(const unsigned long long* rec, const int* start,
                             const int* counts, const int* ext_slot,
                             int n_bins, int n_cells, int k_max, int k_ext,
                             int max_count, int* cand_ids, int* ext_ids,
                             int* work, int cap, void* stream) {
  if (n_bins <= 0) return (int)cudaSuccess;
  if (k_max < 0 || k_ext < 0 || n_cells <= 0 ||
      (max_count > 32 && (work == nullptr || cap < 1)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long threads = (long long)(n_bins + 31) / 32 * 32;
  cand_order_warp_kernel<<<(unsigned)((threads + kThreads - 1) / kThreads),
                           kThreads, 0, s>>>(
      rec, start, counts, ext_slot, n_bins, n_cells, k_max, k_ext, cand_ids,
      ext_ids, work, cap);
  if (max_count > 32) {
    int p = 64;
    while (p < max_count && p < kSortRecords) p <<= 1;
    const int bytes = p * (int)sizeof(unsigned long long);
    cudaError_t err = cudaFuncSetAttribute(
        cand_order_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return (int)err;
    cand_order_block_kernel<<<kSortBlocks, kSortThreads, bytes, s>>>(
        rec, start, counts, ext_slot, n_cells, k_max, k_ext, cand_ids,
        ext_ids, work);
  }
  if (max_count > kSortRecords) {
    int blocks = (max_count + kRankThreads - 1) / kRankThreads;
    if (blocks > kRankBlocks) blocks = kRankBlocks;
    cand_order_rank_kernel<<<blocks, kRankThreads, 0, s>>>(
        rec, start, counts, ext_slot, n_cells, k_max, k_ext, cand_ids,
        ext_ids, work, cap);
  }
  return (int)cudaGetLastError();
}

// Designs of kernels D1 and D2 (the device candidate builder) that
// tools/cand_build_sweep.py times against the ones the port keeps.
// Built by the sweep alone into its own library; the port never loads
// it.  The port's kernels and entry points (csrc/cand_build.cu, included
// below) are in the same library.
//
//   alt_cand_bin: D1's per-slot arithmetic unchanged, launched with a
//     chosen number of offset groups, along y as the port launches them
//     (every cell's first group, then every cell's second, ...) or along
//     x (a cell's groups in neighbouring blocks, so that the cells are
//     swept once, in order), and optionally with warp-aggregated atomics:
//     the lanes of a warp whose pairs fall in one bin (__match_any_sync)
//     take one atomicAdd of their number, made by the lowest of them, and
//     their positions from its result.
//   alt_half_write: the write pass's atomics alone, or its stores alone.
//   alt_cand_order: D2's warp route one warp a bin, by (a) a bitonic
//     sort of the bucket in registers by shuffles (the first design) or
//     (b) each record's rank counted over the bucket's records; larger
//     buckets are listed as the port's warp kernel lists them, and the
//     port's block and rank kernels take them.
//
// Every design gives the port's records (up to order inside a bucket)
// and tables, which the sweep checks first.

#include "../interpolate_unstructured_tpu_torch/csrc/cand_build.cu"

namespace {

template <int NF, bool kWrite, bool kAggregate, bool kSwap, typename T>
__global__ void __launch_bounds__(kThreads) alt_bin_kernel(
    const T* __restrict__ normals, const T* __restrict__ offs,
    const int* __restrict__ b0, const int* __restrict__ span, int n_cells,
    int s1, int s2, int n_offsets, int nby, int nbz, BinFrame<T> fr,
    int use_zc, int* __restrict__ counter,
    unsigned long long* __restrict__ rec) {
  const int c = (kSwap ? blockIdx.y : blockIdx.x) * kThreads + threadIdx.x;
  const int group = kSwap ? blockIdx.x : blockIdx.y;
  const int n_groups = kSwap ? gridDim.x : gridDim.y;
  if (c >= n_cells) return;
  const int lane = threadIdx.x & 31;
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
  for (int o = group; o < n_offsets; o += n_groups) {
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
    int pos = 0;
    if constexpr (kAggregate) {
      const unsigned peers = __match_any_sync(__activemask(), pbin);
      const int rank = __popc(peers & ((1u << lane) - 1u));
      int base = 0;
      if (rank == 0) base = atomicAdd(&counter[pbin], __popc(peers));
      pos = __shfl_sync(peers, base, __ffs(peers) - 1) + rank;
    } else if constexpr (kWrite) {
      pos = atomicAdd(&counter[pbin], 1);
    } else {
      atomicAdd(&counter[pbin], 1);
    }
    if constexpr (kWrite) {
      rec[pos] = ((unsigned long long)score_order((float)m) << 32) |
                 (unsigned int)(o * n_cells + c);
    }
  }
}

// D2's warp route one warp a bin: lane r holds record r; its rank is the
// number of the bucket's records below it (kBitonic false), or the
// bucket is sorted across the lanes (kBitonic true) and lane = rank
template <bool kBitonic>
__global__ void __launch_bounds__(kThreads) alt_order_kernel(
    const unsigned long long* __restrict__ rec, const int* __restrict__ start,
    const int* __restrict__ counts, const int* __restrict__ ext_slot,
    int n_bins, int n_cells, int k_max, int k_ext,
    int* __restrict__ cand_ids, int* __restrict__ ext_ids,
    int* __restrict__ work, int cap) {
  const int bin = (int)(((long long)blockIdx.x * kThreads + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (bin >= n_bins) return;
  const int n = counts[bin];
  if (n > 32) {
    if (lane == 0) {
      const int route = n > kSortRecords;
      const int w = atomicAdd(&work[route], 1);
      work[2 + route * cap + w] = bin;
    }
    return;
  }
  unsigned long long v = lane < n ? rec[start[bin] + lane] : kPad;
  int rank = 0;
  if constexpr (kBitonic) {
#pragma unroll
    for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
      for (int j = k >> 1; j > 0; j >>= 1) {
        const unsigned long long o = __shfl_xor_sync(0xffffffffu, v, j);
        v = (((lane & j) == 0) == ((lane & k) == 0)) ? (o < v ? o : v)
                                                     : (o < v ? v : o);
      }
    }
    rank = lane;
  } else {
    for (int q = 0; q < n; ++q)
      rank += __shfl_sync(0xffffffffu, v, q) < v;
  }
  const int e = n > k_max ? ext_slot[bin] : -1;
  if (lane < n) put_rank(cand_ids, ext_ids, bin, e, k_max, k_ext, rank,
                         rec_cell(v, n_cells));
  int* row = cand_ids + (size_t)bin * k_max;
  for (int r = n + lane; r < k_max; r += 32) row[r] = -1;
  if (e >= 0)
    for (int r = max(n - k_max, 0) + lane; r < k_ext; r += 32)
      ext_ids[(size_t)e * k_ext + r] = -1;
}

// The write pass's two halves alone, one offset a thread (groups along
// x): mode 1 takes each kept pair's atomicAdd and stores nothing (unless
// the position is negative, which it never is); mode 2 stores each
// record, without an atomic, at a position inside its bin's bucket
// picked from the slot.  Neither writes the port's records.
template <int kMode>
__global__ void __launch_bounds__(kThreads) half_write_kernel(
    const float* __restrict__ normals, const float* __restrict__ offs,
    const int* __restrict__ b0, const int* __restrict__ span, int n_cells,
    int s1, int s2, int nby, int nbz, BinFrame<float> fr,
    const int* __restrict__ counts, int* __restrict__ counter,
    unsigned long long* __restrict__ rec) {
  const int c = blockIdx.y * kThreads + threadIdx.x;
  const int o = blockIdx.x;
  if (c >= n_cells) return;
  const int k = o % s2;
  const int t = o / s2;
  const int j = t % s1;
  const int i = t / s1;
  if (i >= span[c * 3] || j >= span[c * 3 + 1] || k >= span[c * 3 + 2])
    return;
  const int bx = b0[c * 3] + i, by = b0[c * 3 + 1] + j, bz = b0[c * 3 + 2] + k;
  const float cb[3] = {fr.rmin[0] + ((float)bx + 0.5f) * fr.h[0],
                       fr.rmin[1] + ((float)by + 0.5f) * fr.h[1],
                       fr.rmin[2] + ((float)bz + 0.5f) * fr.h[2]};
  bool separated = false;
  float m = 0;
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    const float* n = normals + (c * 4 + f) * 3;
    const float reach = (fabsf(n[0]) * fr.half[0] + fabsf(n[1]) * fr.half[1]) +
                        fabsf(n[2]) * fr.half[2];
    const float off = offs[c * 4 + f];
    const float proj = (n[0] * cb[0] + n[1] * cb[1]) + n[2] * cb[2];
    separated |= (proj - reach) > off + fr.eps;
    m = f == 0 ? off - proj : min_nan(m, off - proj);
  }
  if (separated) return;
  const int pbin = (bx * nby + by) * nbz + bz;
  const unsigned long long r =
      ((unsigned long long)score_order(m) << 32) | (unsigned)(o * n_cells + c);
  if constexpr (kMode == 1) {
    const int pos = atomicAdd(&counter[pbin], 1);
    if (pos < 0) rec[0] = r;
  } else {
    rec[counter[pbin] + (o * n_cells + c) % counts[pbin]] = r;
  }
}

template <bool kWrite, bool kAggregate, bool kSwap>
void launch_alt(const float* normals, const float* offs, const int* b0,
                const int* span, int n_cells, const int* smax, int nby,
                int nbz, const double* frame, int use_zc, int groups,
                int* counter, unsigned long long* rec, cudaStream_t s) {
  BinFrame<float> fr;
  for (int d = 0; d < 3; ++d) {
    fr.half[d] = (float)frame[d];
    fr.rmin[d] = (float)frame[3 + d];
    fr.h[d] = (float)frame[6 + d];
  }
  fr.eps = (float)frame[9];
  fr.zc = (float)frame[10];
  const int n_offsets = smax[0] * smax[1] * smax[2];
  const unsigned blocks = (n_cells + kThreads - 1) / kThreads;
  const dim3 grid = kSwap ? dim3((unsigned)groups, blocks)
                          : dim3(blocks, (unsigned)groups);
  alt_bin_kernel<4, kWrite, kAggregate, kSwap, float>
      <<<grid, kThreads, 0, s>>>(
      normals, offs, b0, span, n_cells, smax[1], smax[2], n_offsets, nby,
      nbz, fr, use_zc, counter, rec);
}

}  // namespace

// D1 on float32 tets: write 0 / 1 as iu_cand_bin, aggregate 0 / 1,
// groups offset groups, along y (swap 0) or along x (swap 1)
extern "C" int alt_cand_bin(const float* normals, const float* offs,
                            const int* b0, const int* span, int n_cells,
                            const int* smax, int nby, int nbz,
                            const double* frame, int use_zc, int write,
                            int aggregate, int swap, int groups,
                            int* counter, unsigned long long* rec,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_offsets = smax[0] * smax[1] * smax[2];
  if (groups < 1 || groups > n_offsets) return (int)cudaErrorInvalidValue;
#define ALT(W_, A_, S_)                                                      \
  launch_alt<W_, A_, S_>(normals, offs, b0, span, n_cells, smax, nby, nbz,  \
                         frame, use_zc, groups, counter, rec, s)
  if (swap) {
    if (write && aggregate) ALT(true, true, true);
    else if (write) ALT(true, false, true);
    else if (aggregate) ALT(false, true, true);
    else ALT(false, false, true);
  } else {
    if (write && aggregate) ALT(true, true, false);
    else if (write) ALT(true, false, false);
    else if (aggregate) ALT(false, true, false);
    else ALT(false, false, false);
  }
#undef ALT
  return (int)cudaGetLastError();
}

// D2's warp route one warp a bin, bitonic (1) or counting (0), on bins
// of at most 32 records; the other arguments of iu_cand_order
extern "C" int alt_cand_order(const unsigned long long* rec,
                              const int* start, const int* counts,
                              const int* ext_slot, int n_bins, int n_cells,
                              int k_max, int k_ext, int max_count,
                              int* cand_ids, int* ext_ids, int bitonic,
                              void* stream) {
  if (n_bins <= 0) return (int)cudaSuccess;
  if (max_count > 32) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long threads = (long long)n_bins * 32;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  if (bitonic)
    alt_order_kernel<true><<<blocks, kThreads, 0, s>>>(
        rec, start, counts, ext_slot, n_bins, n_cells, k_max, k_ext,
        cand_ids, ext_ids, nullptr, 0);
  else
    alt_order_kernel<false><<<blocks, kThreads, 0, s>>>(
        rec, start, counts, ext_slot, n_bins, n_cells, k_max, k_ext,
        cand_ids, ext_ids, nullptr, 0);
  return (int)cudaGetLastError();
}

// The write pass's halves (half_write_kernel), mode 1 or 2; counter as
// the write pass's, counts the count pass's
extern "C" int alt_half_write(const float* normals, const float* offs,
                              const int* b0, const int* span, int n_cells,
                              const int* smax, int nby, int nbz,
                              const double* frame, int mode,
                              const int* counts, int* counter,
                              unsigned long long* rec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BinFrame<float> fr;
  for (int d = 0; d < 3; ++d) {
    fr.half[d] = (float)frame[d];
    fr.rmin[d] = (float)frame[3 + d];
    fr.h[d] = (float)frame[6 + d];
  }
  fr.eps = (float)frame[9];
  const dim3 grid((unsigned)(smax[0] * smax[1] * smax[2]),
                  (unsigned)((n_cells + kThreads - 1) / kThreads));
  if (mode == 1)
    half_write_kernel<1><<<grid, kThreads, 0, s>>>(
        normals, offs, b0, span, n_cells, smax[1], smax[2], nby, nbz, fr,
        counts, counter, rec);
  else
    half_write_kernel<2><<<grid, kThreads, 0, s>>>(
        normals, offs, b0, span, n_cells, smax[1], smax[2], nby, nbz, fr,
        counts, counter, rec);
  return (int)cudaGetLastError();
}

// Device candidate-bin construction: kernel D1 (pair words) and kernel D2
// (the id tables), the two stages of build_candidate_bins_device
// (ops/cand_build.py) around a stable torch.sort of the pair words.
//
// No Pallas kernel is replaced: the JAX package builds the lists in XLA,
// interpolate_unstructured_tpu/ops/cand_build.py:_gen_pairs (stage 1, an
// unrolled Python loop over the bin offsets, ~15 ops over (C, nf)
// temporaries each), lax.sort (stage 2) and _fill_tables (stage 3,
// scatters).  These kernels do that work in two launches.
//
// D1, cand_pairs_kernel: pair slot s = o * C + c, offset-major as the JAX
// package stacks its per-offset arrays; offset o decodes to (i, j, k)
// within smax at run time.  One thread takes one cell and a strided set
// of offsets (blockIdx.y, + gridDim.y, ...), so the cell's face planes,
// reach and AABB are read once for all its offsets, and for each offset
// a warp writes 32 neighbouring slots.  Per slot, in the grid's dtype T
// and in _gen_pairs' operation order (built with --fmad=false): the bin
// center rmin + ((T)b + 0.5) * h (zc for z in a planar mesh), each
// face's projection (n0*cbx + n1*cby) + n2*cbz, separated = any(proj -
// reach > off + eps), and score = (float)min(off - proj) with NaN
// propagating.  It writes one 64-bit word, the key (the bin, or n_bins
// for a dropped slot) in the high half and the order-preserving bits of
// -score in the low half (-0 and subnormals as +0, every NaN as one
// value above +inf, as lax.sort compares float32 in the JAX package),
// and the slot's cell id; each kept pair adds one to its bin's count.
// Plain version: ops/cand_build.py:gen_pairs_plain.
//
// What bounds D1 on an H100: bytes.  It reads 88 B a cell (float32 tets:
// normals, offsets, first bin, span) and writes 12 B a slot and the
// counts: for the 998,250-tet box, 64 offsets, ~0.86 GB.  The arithmetic,
// ~50 float32 operations a slot, takes a tenth of that time.
//
// D2, cand_fill_kernel: one thread per sorted slot.  A kept pair's rank
// is pos - start[bin], start the exclusive scan of the counts; rank <
// k_max goes to cand_ids[bin, rank], rank < k_max + k_ext of an
// overflowing bin to ext_ids[ext_slot[bin], rank - k_max].  Dropped
// slots (key n_bins) sort last and write nothing.  Plain version:
// ops/cand_build.py:fill_tables_plain after sort_rank_count.
//
// What bounds D2 on an H100: bytes, 12 B a kept sorted slot in and the
// id tables out.  Sorted order makes a bin's writes contiguous.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// Threads D1 aims for: with fewer cells, more blocks along the offsets
constexpr long long kPairThreads = 1 << 21;
constexpr unsigned int kNanOrder = 0xFFC00000u;

// Low half of a sort word: unsigned order of the result is float order
// of -score, -0 and subnormals as +0, every NaN above +inf
// (ops/cand_build.py:sort_word)
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

template <typename T, int NF>
__global__ void __launch_bounds__(kThreads) cand_pairs_kernel(
    const T* __restrict__ normals, const T* __restrict__ offs,
    const int* __restrict__ b0, const int* __restrict__ span, int n_cells,
    int s1, int s2, int n_offsets, int nby, int nbz, int n_bins,
    BinFrame<T> fr, int use_zc, unsigned long long* __restrict__ word,
    int* __restrict__ cell, int* __restrict__ counts) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
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
  for (int o = blockIdx.y; o < n_offsets; o += gridDim.y) {
    const int k = o % s2;
    const int t = o / s2;
    const int j = t % s1;
    const int i = t / s1;
    const bool valid = i < sx && j < sy && k < sz;
    const int bx = bx0 + i, by = by0 + j, bz = bz0 + k;
    const int pbin = (bx * nby + by) * nbz + bz;
    const T cbx = fr.rmin[0] + ((T)bx + (T)0.5) * fr.h[0];
    const T cby = fr.rmin[1] + ((T)by + (T)0.5) * fr.h[1];
    const T cbz = use_zc ? fr.zc : fr.rmin[2] + ((T)bz + (T)0.5) * fr.h[2];
    bool separated = false;
    T m = 0;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const T proj = (n[f][0] * cbx + n[f][1] * cby) + n[f][2] * cbz;
      separated |= (proj - reach[f]) > off_eps[f];
      const T d = off[f] - proj;
      m = f == 0 ? d : min_nan(m, d);
    }
    const int key = (valid && !separated) ? pbin : n_bins;
    const size_t s = (size_t)o * n_cells + c;
    word[s] = ((unsigned long long)(unsigned int)key << 32) |
              score_order((float)m);
    cell[s] = c;
    if (key < n_bins) atomicAdd(&counts[key], 1);
  }
}

__global__ void __launch_bounds__(kThreads) cand_fill_kernel(
    const unsigned long long* __restrict__ sw, const int* __restrict__ scell,
    int n_slots, const int* __restrict__ start,
    const int* __restrict__ ext_slot, int n_bins, int k_max, int k_ext,
    int* __restrict__ cand_ids, int* __restrict__ ext_ids) {
  const int pos = blockIdx.x * kThreads + threadIdx.x;
  if (pos >= n_slots) return;
  const int key = (int)(sw[pos] >> 32);
  if (key >= n_bins) return;
  const int rank = pos - start[key];
  if (rank < k_max) {
    cand_ids[(size_t)key * k_max + rank] = scell[pos];
  } else if (rank < k_max + k_ext) {
    const int e = ext_slot[key];
    if (e >= 0) ext_ids[(size_t)e * k_ext + (rank - k_max)] = scell[pos];
  }
}

template <typename T, int NF>
void launch_pairs(const void* normals, const void* offs, const int* b0,
                  const int* span, int n_cells, const int* smax, int nby,
                  int nbz, int n_bins, const double* frame, int use_zc,
                  unsigned long long* word, int* cell, int* counts,
                  cudaStream_t s) {
  BinFrame<T> fr;
  for (int d = 0; d < 3; ++d) {
    fr.half[d] = (T)frame[d];
    fr.rmin[d] = (T)frame[3 + d];
    fr.h[d] = (T)frame[6 + d];
  }
  fr.eps = (T)frame[9];
  fr.zc = (T)frame[10];
  const int n_offsets = smax[0] * smax[1] * smax[2];
  long long groups = (kPairThreads + n_cells - 1) / n_cells;
  if (groups > n_offsets) groups = n_offsets;
  if (groups < 1) groups = 1;
  const dim3 grid((n_cells + kThreads - 1) / kThreads, (unsigned)groups);
  cand_pairs_kernel<T, NF><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(normals), static_cast<const T*>(offs), b0, span,
      n_cells, smax[1], smax[2], n_offsets, nby, nbz, n_bins, fr, use_zc,
      word, cell, counts);
}

}  // namespace

// Plain C entry point of D1 (bound with ctypes).  normals (C, nf, 3) and
// offs (C, nf) float32 (f64 = 0) or float64 (f64 = 1); b0, span (C, 3)
// int32; smax: host int[3], the offset grid; frame: host double[11], the
// bin half-size, origin and size (3 each), the separation eps and zc,
// rounded to the dtype here; word (n_offsets * C,) uint64, cell
// (n_offsets * C,) int32; counts (n_bins,) int32, zeroed by the caller.
extern "C" int iu_cand_pairs(const void* normals, const void* offs,
                             const int* b0, const int* span, int n_cells,
                             int nf, int f64, const int* smax, int nby,
                             int nbz, int n_bins, const double* frame,
                             int use_zc, unsigned long long* word, int* cell,
                             int* counts, void* stream) {
  if (n_cells <= 0) return (int)cudaSuccess;
  if (smax[0] < 1 || smax[1] < 1 || smax[2] < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define IU_PAIRS(T_, NF_)                                                    \
  launch_pairs<T_, NF_>(normals, offs, b0, span, n_cells, smax, nby, nbz,   \
                        n_bins, frame, use_zc, word, cell, counts, s)
  if (nf == 3 && f64) {
    IU_PAIRS(double, 3);
  } else if (nf == 3) {
    IU_PAIRS(float, 3);
  } else if (nf == 4 && f64) {
    IU_PAIRS(double, 4);
  } else if (nf == 4) {
    IU_PAIRS(float, 4);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef IU_PAIRS
  return (int)cudaGetLastError();
}

// Plain C entry point of D2.  sw (n_slots,) uint64 sorted words, scell
// (n_slots,) int32 the cells in the same order; start (n_bins,) int32,
// the exclusive scan of the counts; ext_slot (n_bins,) int32; cand_ids
// (n_bins, k_max) and ext_ids (n_over, k_ext) int32, filled with -1 by
// the caller.
extern "C" int iu_cand_fill(const unsigned long long* sw, const int* scell,
                            int n_slots, const int* start,
                            const int* ext_slot, int n_bins, int k_max,
                            int k_ext, int* cand_ids, int* ext_ids,
                            void* stream) {
  if (n_slots <= 0) return (int)cudaSuccess;
  if (k_max < 0 || k_ext < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (n_slots + kThreads - 1) / kThreads;
  cand_fill_kernel<<<blocks, kThreads, 0, s>>>(sw, scell, n_slots, start,
                                               ext_slot, n_bins, k_max, k_ext,
                                               cand_ids, ext_ids);
  return (int)cudaGetLastError();
}

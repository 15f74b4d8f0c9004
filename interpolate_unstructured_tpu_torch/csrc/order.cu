// Bin order of a walk grid's large query batches: the key pass, the
// scatter and the unsort around get_cell's walk (B3) and the known-cell
// interpolation (E1), which run unchanged on the ordered batch.
//
// No Pallas counterpart: the JAX package takes every batch in the order
// it is given.  On the card, a batch of warm queries in random order
// (particles drawn at random, a tracker's step) sends consecutive
// threads through unrelated cells, so B3 reads each visited cell's
// 512-byte walk row and E1 its connectivity and vertices as random
// 32-byte sectors from device memory, where the rows of a 998,250-tet
// box (511 MB) are ten times the 50 MB L2.  In bin order the queries in
// flight cover a few regions of the mesh, whose rows stay in L2, and
// each row comes from device memory about once a call.
//
// The order is a counting sort by a coarse bin of the query's position
// (not of its guess cell, so the locality does not depend on how the
// mesh numbers its cells): the key bin is the query's seed bin on the
// grid's own seed grid (bins.cuh, the arithmetic of get_cell's cold
// start) with each coordinate shifted right by `shift`.
//
// What bounds it on an H100: scattered accesses.  Moving a query to a
// random place costs an L2 transaction a scattered load or store, more
// than its bytes: the first designs (PERF.md §6) took 0.7 ms to gather
// 10M float64 queries by a permutation (three 8-byte loads and a 4-byte
// one a query, at random), about 1 ms to scatter them one query a
// thread, and 0.5-1 ms to unsort the outputs, as much as the order
// saved in B3 and E1.  So every pass here moves runs, not queries.  The
// batch is cut into tiles of kTile queries, the same tiles in every
// pass:
//   1. order_key_kernel: each query's key bin; the tile counts its
//      queries a key bin in shared memory, then takes one range of
//      ranks a key bin from the global count with one atomic, so a
//      tile's queries of one key bin get consecutive ranks (a run), and
//      a scan of the tile's counts gives each query its position among
//      the tile's slots;
//   2. the scan of the counts (torch.cumsum): a query's slot in bin
//      order is its key bin's start plus its rank;
//   3. order_scatter_kernel: the tile reads its queries and start cells
//      coalesced, stages them in shared memory at their positions and
//      writes each run to its slots with consecutive threads, so the
//      stores coalesce; slot[q] keeps the way back;
// and after B3 and E1 on the ordered batch:
//   4. order_unsort_kernel: the mirror of the scatter: the tile loads
//      the runs of its queries' i_cell, found and values (8-byte words
//      where the rows hold doubles, else 4-byte; kChunkBytes a query at a
//      time) with consecutive threads, stages them and writes them in
//      query order.
// The key grid has at most kMaxKeys bins (the shared-memory counts);
// fewer key bins make longer runs, more make the ordered batch finer:
// ops/order_kernel.py:key_shift picks the halvings from a sweep.  Each
// query's walk and interpolation read nothing of the other queries, so
// the outputs are the unordered route's bit for bit, whatever order the
// atomics give the tiles of a key bin.
//
// Plain PyTorch versions: ops/order_kernel.py:order_plain (a stable sort
// by key bin) and unsort_plain.

#include <cuda_runtime.h>

#include <cstdint>

#include "bins.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;  // queries a thread of a tile
constexpr int kTile = kThreads * kItems;
constexpr int kMaxKeys = 4 * kThreads;  // key bins: 4 a thread in the scan
constexpr int kChunkBytes = 32;  // value bytes a query the unsort stages

int tiles_of(int n) { return (n + kTile - 1) / kTile; }

// Lets `kernel` take `smem` bytes of dynamic shared memory on the current
// device, once a device (bit d of *allowed: device d; devices past 31
// set it every launch).
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem, unsigned* allowed) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (*allowed & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess) *allowed |= bit;
  return err;
}

// Query q's key bin: its seed bin with each coordinate shifted right.
template <typename T>
__device__ __forceinline__ int key_of(const T* __restrict__ r, int q,
                                      const iu::BinGrid<T>& bins, int shift,
                                      int kny, int knz) {
  int i, j, k;
  iu::bin_ijk(bins, r[3 * q + 0], r[3 * q + 1], r[3 * q + 2], i, j, k);
  return ((i >> shift) * kny + (j >> shift)) * knz + (k >> shift);
}

// Exclusive scan of hist[0, n_keys) in place, n_keys <= kMaxKeys, by
// every thread of the block; the caller has synchronized after its
// writes to hist.
__device__ void block_exclusive_scan(int* hist, int n_keys) {
  __shared__ int warp_sums[kThreads / 32];
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  int v[4], sum = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = 4 * t + i;
    v[i] = k < n_keys ? hist[k] : 0;
    sum += v[i];
  }
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sums[w] = incl;
  __syncthreads();
  if (w == 0) {
    const int ws = lane < kThreads / 32 ? warp_sums[lane] : 0;
    int wi = ws;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, wi, o);
      if (lane >= o) wi += y;
    }
    if (lane < kThreads / 32) warp_sums[lane] = wi - ws;
  }
  __syncthreads();
  int run = warp_sums[w] + incl - sum;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = 4 * t + i;
    if (k < n_keys) hist[k] = run;
    run += v[i];
  }
  __syncthreads();
}

// Key pass: each query's key bin, its rank there (consecutive for a
// tile's queries of one key bin: a run) and its position in the tile's
// slot order (the runs of the tile in ascending key order).
template <typename T>
__global__ void __launch_bounds__(kThreads)
order_key_kernel(const T* __restrict__ r, int n, iu::BinGrid<T> bins,
                 int shift, int kny, int knz, int n_keys,
                 int* __restrict__ counts, int* __restrict__ key_out,
                 int* __restrict__ rank_out, int* __restrict__ pos_out) {
  __shared__ int hist[kMaxKeys], first[kMaxKeys];
  for (int k = threadIdx.x; k < n_keys; k += kThreads) hist[k] = 0;
  __syncthreads();
  const int q0 = blockIdx.x * kTile + threadIdx.x;
  int key[kItems], local[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int q = q0 + i * kThreads;
    if (q < n) {
      key[i] = key_of(r, q, bins, shift, kny, knz);
      local[i] = atomicAdd(hist + key[i], 1);
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n_keys; k += kThreads) {
    const int c = hist[k];
    first[k] = c != 0 ? atomicAdd(counts + k, c) : 0;
  }
  block_exclusive_scan(hist, n_keys);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int q = q0 + i * kThreads;
    if (q < n) {
      key_out[q] = key[i];
      rank_out[q] = first[key[i]] + local[i];
      pos_out[q] = hist[key[i]] + local[i];
    }
  }
}

// Scatter: a tile's queries and start cells (none where start is null)
// to their slots, ends[k] - counts[k] + rank in key bin k, staged in
// slot order and written run by run; slot[q] keeps the way back.  Each
// thread loads all of its kItems queries before it stores any, so that
// their loads are in flight together.
template <typename T>
__global__ void __launch_bounds__(kThreads)
order_scatter_kernel(const T* __restrict__ r, const int* __restrict__ start,
                     int n, const int* __restrict__ key,
                     const int* __restrict__ rank,
                     const int* __restrict__ pos,
                     const int* __restrict__ counts,
                     const int* __restrict__ ends, T* __restrict__ r_out,
                     int* __restrict__ start_out, int* __restrict__ slot) {
  extern __shared__ unsigned char staged[];
  T* sr = reinterpret_cast<T*>(staged);  // kTile (x, y, z)
  int* sdst = reinterpret_cast<int*>(sr + 3 * kTile);  // kTile slots
  int* sstart = sdst + kTile;  // kTile start cells
  const int base = blockIdx.x * kTile;
  const int tile_n = min(kTile, n - base);
  int p[kItems], d[kItems], c[kItems];
  T x[kItems][3];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    if (idx < tile_n) {
      const int q = base + idx, k = key[q];
      p[i] = pos[q];
      d[i] = ends[k] - counts[k] + rank[q];
      x[i][0] = r[3 * q + 0];
      x[i][1] = r[3 * q + 1];
      x[i][2] = r[3 * q + 2];
      if (start != nullptr) c[i] = start[q];
    }
  }
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    if (idx < tile_n) {
      slot[base + idx] = d[i];
      sr[3 * p[i] + 0] = x[i][0];
      sr[3 * p[i] + 1] = x[i][1];
      sr[3 * p[i] + 2] = x[i][2];
      sdst[p[i]] = d[i];
      if (start != nullptr) sstart[p[i]] = c[i];
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int j = threadIdx.x + i * kThreads;
    if (j < tile_n) {
      const int dst = sdst[j];
      r_out[3 * dst + 0] = sr[3 * j + 0];
      r_out[3 * dst + 1] = sr[3 * j + 1];
      r_out[3 * dst + 2] = sr[3 * j + 2];
      if (start != nullptr) start_out[dst] = sstart[j];
    }
  }
}

// Unsort: a tile's i_cell, found and values back from their slots,
// loaded run by run in slot order and written in query order.  W: the
// word the values move in, 8 bytes where a row is a whole number of
// them (doubles), else 4; kChunkBytes of a query's row at a time, its
// row in shared memory padded by a word against bank conflicts.
template <typename W>
__global__ void __launch_bounds__(kThreads)
order_unsort_kernel(const int* __restrict__ slot,
                    const int* __restrict__ pos, int n,
                    const int* __restrict__ ic,
                    const unsigned char* __restrict__ found,
                    const W* __restrict__ vals, int n_words,
                    int* __restrict__ ic_out,
                    unsigned char* __restrict__ found_out,
                    W* __restrict__ vals_out) {
  constexpr int kChunk = kChunkBytes / sizeof(W), kRow = kChunk + 1;
  extern __shared__ unsigned char staged_words[];
  W* swords = reinterpret_cast<W*>(staged_words);  // kTile rows of kRow
  __shared__ int src[kTile], at[kTile], sic[kTile];
  __shared__ unsigned char sfound[kTile];
  const int base = blockIdx.x * kTile;
  const int tile_n = min(kTile, n - base);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    if (idx < tile_n) {
      const int p = pos[base + idx];
      src[p] = slot[base + idx];
      at[idx] = p;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int p = threadIdx.x + i * kThreads;
    if (p < tile_n) {
      sic[p] = ic[src[p]];
      sfound[p] = found[src[p]];
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    if (idx < tile_n) {
      ic_out[base + idx] = sic[at[idx]];
      found_out[base + idx] = sfound[at[idx]];
    }
  }
  for (int w0 = 0; w0 < n_words; w0 += kChunk) {
    const int nw = min(kChunk, n_words - w0);
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int p = threadIdx.x + i * kThreads;
      if (p < tile_n) {
        const W* row = vals + (size_t)src[p] * n_words + w0;
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          if (j < nw) swords[p * kRow + j] = row[j];
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      if (idx < tile_n) {
        W* out = vals_out + (size_t)(base + idx) * n_words + w0;
        const W* row = swords + at[idx] * kRow;
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          if (j < nw) out[j] = row[j];
        }
      }
    }
    __syncthreads();
  }
}

template <typename W>
int order_unsort(const int* slot, const int* pos, int n, const int* ic,
                 const unsigned char* found, const void* vals, int n_words,
                 int* ic_out, unsigned char* found_out, void* vals_out,
                 void* stream) {
  const size_t smem =
      (size_t)kTile * (kChunkBytes / sizeof(W) + 1) * sizeof(W);
  static unsigned allowed = 0;
  const cudaError_t err = allow_smem(order_unsort_kernel<W>, smem, &allowed);
  if (err != cudaSuccess) return (int)err;
  order_unsort_kernel<W><<<tiles_of(n), kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      slot, pos, n, ic, found, static_cast<const W*>(vals), n_words, ic_out,
      found_out, static_cast<W*>(vals_out));
  return (int)cudaGetLastError();
}

int key_extent(int n, int shift) { return ((n - 1) >> shift) + 1; }

template <typename T>
int order_key(const T* r, int n, const T* rmin, const T* inv_h, int nbx,
              int nby, int nbz, int shift, int* counts, int* key_out,
              int* rank_out, int* pos_out, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (shift < 0 || shift > 30) return (int)cudaErrorInvalidValue;
  const int knx = key_extent(nbx, shift), kny = key_extent(nby, shift),
            knz = key_extent(nbz, shift);
  if ((long long)knx * kny * knz > kMaxKeys) {
    return (int)cudaErrorInvalidValue;
  }
  const iu::BinGrid<T> bins{rmin, inv_h, nbx, nby, nbz};
  order_key_kernel<T><<<tiles_of(n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      r, n, bins, shift, kny, knz, knx * kny * knz, counts, key_out,
      rank_out, pos_out);
  return (int)cudaGetLastError();
}

template <typename T>
int order_scatter(const T* r, const int* start, int n, const int* key,
                  const int* rank, const int* pos, const int* counts,
                  const int* ends, T* r_out, int* start_out, int* slot,
                  void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if ((start == nullptr) != (start_out == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)kTile * (3 * sizeof(T) + 2 * sizeof(int));
  static unsigned allowed = 0;
  const cudaError_t err = allow_smem(order_scatter_kernel<T>, smem, &allowed);
  if (err != cudaSuccess) return (int)err;
  order_scatter_kernel<T><<<tiles_of(n), kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      r, start, n, key, rank, pos, counts, ends, r_out, start_out, slot);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes).  r: (B, 3) queries of the
// grid's type (float, or double in the *_f64 entry points); key, rank
// and pos: (B,) int32, each query's key bin, its rank there and its
// position among its tile's slots (tiles of kTile = 2048 queries).
//
// iu_order_key: rmin, inv_h: (3,) seed-grid origin and inverse sizes on
// the device; nbx, nby, nbz: the seed bins per axis; shift: 2^shift seed
// bins a key bin along each axis, so an axis of n seed bins has
// ((n - 1) >> shift) + 1 key bins, at most kMaxKeys (1024) in all.
// counts ((n_keys,) int32, zeroed by the caller) gets the queries a key
// bin, key_out, rank_out and pos_out each query's key, rank and
// position.
extern "C" int iu_order_key(const float* r, int n_queries,
                            const float* rmin, const float* inv_h, int nbx,
                            int nby, int nbz, int shift, int* counts,
                            int* key_out, int* rank_out, int* pos_out,
                            void* stream) {
  return order_key<float>(r, n_queries, rmin, inv_h, nbx, nby, nbz, shift,
                          counts, key_out, rank_out, pos_out, stream);
}

extern "C" int iu_order_key_f64(const double* r, int n_queries,
                                const double* rmin, const double* inv_h,
                                int nbx, int nby, int nbz, int shift,
                                int* counts, int* key_out, int* rank_out,
                                int* pos_out, void* stream) {
  return order_key<double>(r, n_queries, rmin, inv_h, nbx, nby, nbz, shift,
                           counts, key_out, rank_out, pos_out, stream);
}

// iu_order_scatter: from the key pass's outputs and ends, the inclusive
// scan of its counts, r_out ((B, 3), the queries in bin order),
// start_out ((B,) int32, start ((B,) int32 start cells) in the same
// order; both null for none) and slot ((B,) int32, each query's position
// in r_out).
extern "C" int iu_order_scatter(const float* r, const int* start,
                                int n_queries, const int* key,
                                const int* rank, const int* pos,
                                const int* counts, const int* ends,
                                float* r_out, int* start_out, int* slot,
                                void* stream) {
  return order_scatter<float>(r, start, n_queries, key, rank, pos, counts,
                              ends, r_out, start_out, slot, stream);
}

extern "C" int iu_order_scatter_f64(const double* r, const int* start,
                                    int n_queries, const int* key,
                                    const int* rank, const int* pos,
                                    const int* counts, const int* ends,
                                    double* r_out, int* start_out, int* slot,
                                    void* stream) {
  return order_scatter<double>(r, start, n_queries, key, rank, pos, counts,
                               ends, r_out, start_out, slot, stream);
}

// iu_order_unsort: slot and pos ((B,) int32) of the order; ic (B,)
// int32, found (B,) bool and vals (B, n_words) 4-byte words of the
// ordered batch into ic_out, found_out and vals_out in query order.
extern "C" int iu_order_unsort(const int* slot, const int* pos,
                               int n_queries, const int* ic,
                               const unsigned char* found, const int* vals,
                               int n_words, int* ic_out,
                               unsigned char* found_out, int* vals_out,
                               void* stream) {
  if (n_queries <= 0) return (int)cudaSuccess;
  if (n_words < 0) return (int)cudaErrorInvalidValue;
  if (n_words % 2 == 0 && reinterpret_cast<uintptr_t>(vals) % 8 == 0 &&
      reinterpret_cast<uintptr_t>(vals_out) % 8 == 0) {
    return order_unsort<long long>(slot, pos, n_queries, ic, found, vals,
                                   n_words / 2, ic_out, found_out, vals_out,
                                   stream);
  }
  return order_unsort<int>(slot, pos, n_queries, ic, found, vals, n_words,
                           ic_out, found_out, vals_out, stream);
}

// Candidate-row probe for the cold locate of large meshes (kernel B2).
//
// Replaces the JAX package's Pallas TPU kernel
// interpolate_unstructured_tpu/ops/pallas_cand.py:_kernel (wrapper
// cand_rows_query).  Each query reads the packed row of its bin: K
// candidate cells, role-major (column j*K + k is role j of candidate
// k).  The kernel computes each candidate's face margins, the
// first-occurrence argmax winner, the verdict `aux` (-2 found, >= 0
// overflow-bin miss carrying the extension slot, -1 exact miss) and the
// winner's fused values.  Four row layouts (models/grid.py packers):
//   0 quantized simplex: int16 normal/offset pairs in the bin's local
//     frame + f32 value planes (the f32 tri/tet default; rq = r_local)
//   1 f32 simplex: unit face planes + premultiplied vertex data
//   2 quad: unit face planes + vertices + raw vertex data
//   3 accurate-mode df planes (the JAX kernel's df_planes branch,
//     pallas_cand.py:73-77, :178-200): the probe of layout 0, then the
//     winner's df32 value plane v = g . r_local + c_loc evaluated in
//     compensated float32 (df32.cuh) from a hi/lo r_local; values out as
//     hi and lo pairs.  Probed in bin order only (below).
//
// What bounds it on an H100: memory.  One random row of about 1.5 KB
// (K = 24 quantized tets) per query and a few flops per byte, so the
// kernel is built to read each row once and coalesced: a group of lanes
// per query, over the K candidates, so each role of a row is one
// contiguous read.  The kernel reads the row itself through the query's
// bin index; the TPU wrapper gathered table[idx] into a separate buffer
// first because Pallas cannot gather rows, and at 10M queries that
// buffer alone would be 15 GB.  The argmax is a butterfly of shuffles on
// (margin, k) pairs with the lower k winning ties (jnp.argmax's first
// occurrence); only the winner's lane evaluates the values, from its own
// margins and its row columns.
//
// On the main table, 10M uniform queries touch 1.9M distinct rows of
// 1.5 KB, and in query order each row comes from DRAM about five times
// (the L2 holds 50 MB of the 2.9 GB table).  So the queries are probed in
// bin order, a group of lanes per query, so the queries of one bin probe
// its row one after the other and it comes from DRAM about once.  One
// thread per query took 3x as long as a group of 4 lanes at 1M queries
// (half a query a bin), 4 lanes 1.2x as long as 2 at 10M (5 a bin), so
// the wrapper picks the group size by queries per bin
// (ops/cand_kernel.py:binned_lanes; PERF.md §6).
//
// Moving a query to a random place costs an L2 transaction, more than
// its bytes.  The first bin order (tools/cand_order_alternatives.cu)
// counted the queries into the 1.9M bins with an atomic a query,
// scattered a permutation a query at a time, read each query through it
// in the probe and put each record back a query at a time: four random
// accesses a query, three times the probe's bound between them.  Here
// every pass moves runs or streams, and only the probe's row reads go
// to random places.  The bins are grouped into coarse keys, 2^span_shift
// consecutive flat bins each (a few hundred at 5 queries a bin), and the
// batch is cut into tiles, the same tiles in the key pass, scatter and
// unsort:
//   1. cand_key_kernel: each query's key; the tile counts its queries a
//      key in shared memory and takes each key's ranks with one global
//      atomic, so a tile's queries of a key get consecutive ranks (a
//      run), and each query's position among the tile's slots;
//   2. cand_key_scan_kernel: where each key's bucket starts in coarse
//      order, and its chunks of at most `chunk` queries;
//   3. cand_key_scatter_kernel: the tile stages its queries in shared
//      memory in slot order and stores each run with consecutive threads,
//      a record a query (the query as the probe reads it);
//   4. cand_rows_chunk_kernel: a block a chunk: it loads the chunk's
//      records coalesced, counting-sorts them by flat bin in shared
//      memory, probes them in that order and stores the chunk's records
//      (id, aux, values) back at their coarse-order positions, coalesced;
//   5. cand_key_unsort_kernel: the scatter's mirror, the records read run
//      by run and written in query order.
// A bucket larger than a chunk is cut into consecutive chunks, which can
// split a bin's queries between two blocks: each query's result reads
// nothing of the others, so the order changes speed only, never bits.
// Its bound: the distinct rows once, the queries and outputs once (keys,
// ranks, records and slots are its own scratch).  ops/cand_kernel.py:
// order_sizing picks the span, the tile and the chunk.  The probe takes
// at most 64 registers (2 blocks of 512 threads an SM), with extension
// rows at most 128.

// Extension rows (a grid whose overflow bins keep candidates K..K+k_ext
// in a second table, layouts 0-2): a query whose main verdict is an
// overflow miss (aux >= 0, the bin's extension slot) probes that row in
// the same launch (the EXT instantiation), with the same group of lanes,
// in the bin's frame, the row read one element at a time; a second
// butterfly picks its winner and one lane writes the merged record.  The
// queries of a bin are adjacent in bin order, so the bin's extension row
// comes from DRAM about once, where the first design (one warp a query,
// in query order, after a host read of the misses and a torch gather of
// their inputs; tools/cand_ext_alternatives.cu) read it once a query.
// The merge is the JAX package's (ops/locate.py:892-975): found in the
// extension row, that winner; not found, the main winner's id and values
// with the extension row's verdict, -1 for an exact miss and >= 0 where
// even K + k_ext candidates did not hold the bin, so that "aux >= 0:
// walk from id" is the one rule for the residual walks.  Plain PyTorch
// version: ops/cand_kernel.py:probe_rows_ext_plain.
//
// The df-plane rows (layout 3) take the same bin order, and their front
// end also does what torch did before the direct layout-3 kernel: the
// key pass and the scatter read the queries as given, float64 (B, 3) or
// a float32 hi/lo pair, and the scatter splits them, hi = f32(r) rounded
// to nearest and lo = f32(r - f64(hi)) (ops/df32.py:split_queries), into
// a record of hi and lo; the probe forms the hi/lo local frame
// two_sum(hi - center) + lo of ops/cand_kernel.py:local_frame_df.  A
// query's result is then id, aux, V hi and V lo values, and the unsort
// moves 2 + 2V words.  The 24 bytes of float64 input a query replace the
// 24 of the hi/lo frame the direct layout-3 kernel read, so the bound
// counts the same bytes.
//
// Packed int16 words are often NaN bit patterns as floats, so the
// qn/qd roles are read through an int pointer and unpacked with integer
// shifts only.  Plain PyTorch version: ops/cand_kernel.py:probe_rows_plain,
// whose rounding order this kernel follows (built with --fmad=false).
//
// A float64 grid's rows are never quantized: they take layouts 1 and 2 in
// double (the JAX package's float64 route, its XLA _probe_rows_xla,
// ops/locate.py:562).  The key pass and the probe are templates on the
// rows' type T, instantiated for float and for double (the *_f64 entry
// points, scalars in double); the key pass of a float64 grid bins each
// query in double against the grid's float64 origin and inverse sizes,
// where accurate mode's key pass on a float32 grid bins float64 queries
// by their float32 rounding.  The scatter, the probe's chunk copies and
// the unsort move 4-byte words, whatever they hold: a double is two
// words of a record.  The double probe reads each candidate's roles one
// element at a time (no 16-byte path); with the default row budget a
// float64 tet grid has K = 7 and no fused variable, so its records are id
// and aux alone.

#include <cuda_runtime.h>

#include <cstdint>

#include "bins.cuh"
#include "df32.cuh"
#include "wkern.cuh"

namespace {

__device__ __forceinline__ float lo16(int w) {
  return (float)((int)((unsigned)w << 16) >> 16);
}
__device__ __forceinline__ float hi16(int w) { return (float)(w >> 16); }

// int16-pair words of a quantized candidate: SN of normal components,
// DN of offsets.
template <int NF>
struct QuantWords {
  static constexpr int SN = (3 * NF + 1) / 2;
  static constexpr int DN = (NF + 1) / 2;
  int w[SN + DN];
};

// Margin of a quantized candidate (layouts 0 and 3) from its words: the
// int16 planes unpacked by integer shifts, the projection scaled by
// qinv, the offset by the row's dscale; a padding slot (negative id)
// gets -1e30.  mf: the per-face margins.
template <int NF>
__device__ __forceinline__ float quant_margin(const QuantWords<NF>& q,
                                              bool padding, float rx,
                                              float ry, float rz, float qinv,
                                              float ds, float (&mf)[NF]) {
  constexpr int SN = QuantWords<NF>::SN;
  float c[2 * SN];
#pragma unroll
  for (int s = 0; s < SN; ++s) {
    c[2 * s] = lo16(q.w[s]);
    c[2 * s + 1] = hi16(q.w[s]);
  }
  float m = 0.0f;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const int w = q.w[SN + f / 2];
    const float dq = (f & 1) ? hi16(w) : lo16(w);
    const float proj =
        ((c[3 * f] * rx + c[3 * f + 1] * ry) + c[3 * f + 2] * rz) * qinv;
    mf[f] = dq * ds - proj;
    m = f == 0 ? mf[f] : (mf[f] < m ? mf[f] : m);
  }
  return padding ? -1e30f : m;
}

// Margin of a float or double candidate (layouts 1 and 2) from its unit
// planes g: normals x (g[f]), y (g[NF + f]), z (g[2 NF + f]), offsets
// g[3 NF + f].
template <int NF, typename T>
__device__ __forceinline__ T plane_margin(const T (&g)[4 * NF], T rx, T ry,
                                          T rz, T (&mf)[NF]) {
  T m = T(0);
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    mf[f] = g[3 * NF + f] - ((g[f] * rx + g[NF + f] * ry) + g[2 * NF + f] * rz);
    m = f == 0 ? mf[f] : (mf[f] < m ? mf[f] : m);
  }
  return m;
}

// Margin of candidate k of a row, read in place.
template <int NF, int LAYOUT, typename T>
__device__ __forceinline__ T row_margin(const T* __restrict__ row, int K,
                                        int k, int id_role, T rx, T ry, T rz,
                                        float qinv, T ds, T (&mf)[NF]) {
  if constexpr (LAYOUT == 0 || LAYOUT == 3) {
    const int* rowi = reinterpret_cast<const int*>(row);
    QuantWords<NF> q;
#pragma unroll
    for (int s = 0; s < QuantWords<NF>::SN + QuantWords<NF>::DN; ++s) {
      q.w[s] = rowi[s * K + k];
    }
    return quant_margin<NF>(q, row[id_role * K + k] < 0.0f, rx, ry, rz, qinv,
                            ds, mf);
  } else {
    T g[4 * NF];
#pragma unroll
    for (int j = 0; j < 4 * NF; ++j) g[j] = row[j * K + k];
    return plane_margin<NF>(g, rx, ry, rz, mf);
  }
}

// The winner k of a query's row (margin wm, per-face margins mf) gives
// id, the verdict aux (-2 found, >= 0 overflow-bin miss carrying the
// extension slot, -1 exact miss) and the fused values, written at
// position q: out_id[q * stride], out_aux[q * stride] and the values
// from out_vals + q * vstride (separate arrays:
// stride 1, vstride n_vars; the bin-ordered probe's records: stride
// 2 + n_vars words, layout 3 2 + 2 n_vars, double values 2 + 2 n_vars,
// and vstride the same in values).  rq_lo: the lo parts of r_local and
// out_vals_lo the lo values (layout 3), else null.
template <int NF, int LAYOUT, typename T>
__device__ __forceinline__ void write_winner(
    const T* __restrict__ row, int K, int k, T wm, const T (&mf)[NF], T rx,
    T ry, T rz, const float* __restrict__ rq_lo, int q, int id_role,
    int count_col, T eps, int ovf_base, int n_vars,
    const int* __restrict__ vroles, int* __restrict__ out_id,
    int* __restrict__ out_aux, T* __restrict__ out_vals,
    float* __restrict__ out_vals_lo, int stride, int vstride) {
  constexpr int NPC = NF;
  const int id_best = (int)row[id_role * K + k];
  const int cnt = (int)row[count_col];
  const bool found = (wm >= -eps) && (id_best >= 0);
  const bool ovf_miss = !found && (cnt > ovf_base) && (id_best >= 0);
  out_id[(size_t)q * stride] = id_best;
  out_aux[(size_t)q * stride] =
      found ? -2 : (ovf_miss ? cnt - (ovf_base + 1) : -1);

  T* vals = out_vals + (size_t)q * vstride;
  if constexpr (LAYOUT == 3) {
    // df32 value planes: the winner's (g hi, g lo, c_loc hi, c_loc lo)
    // roles, acc = c_loc + sum_d g_d * r_local_d in df32
    const iu::df rl[3] = {iu::df_make(rx, rq_lo[0]), iu::df_make(ry, rq_lo[1]),
                          iu::df_make(rz, rq_lo[2])};
    float* vals_lo = out_vals_lo + (size_t)q * vstride;
    for (int iv = 0; iv < n_vars; ++iv) {
      const int pr = vroles[iv];
      iu::df acc = iu::df_make(row[(pr + 6) * K + k], row[(pr + 7) * K + k]);
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const iu::df g =
            iu::df_make(row[(pr + d) * K + k], row[(pr + 3 + d) * K + k]);
        acc = iu::df_add(acc, iu::df_mul(g, rl[d]));
      }
      vals[iv] = acc.hi;
      vals_lo[iv] = acc.lo;
    }
  } else if constexpr (LAYOUT == 0) {
    for (int iv = 0; iv < n_vars; ++iv) {
      const int pr = vroles[iv];
      vals[iv] = ((row[pr * K + k] * rx + row[(pr + 1) * K + k] * ry) +
                  row[(pr + 2) * K + k] * rz) +
                 row[(pr + 3) * K + k];
    }
  } else if constexpr (LAYOUT == 1) {
    for (int iv = 0; iv < n_vars; ++iv) {
      const int dr = vroles[iv];
      T acc = mf[1 % NPC] * row[dr * K + k];
#pragma unroll
      for (int v = 1; v < NPC; ++v) {
        acc = acc + mf[(v + 1) % NPC] * row[(dr + v) * K + k];
      }
      vals[iv] = acc;
    }
  } else {
    T p[4][3];
#pragma unroll
    for (int v = 0; v < 4; ++v) {
#pragma unroll
      for (int d = 0; d < 3; ++d) p[v][d] = row[(4 * NF + v * 3 + d) * K + k];
    }
    const T qr[3] = {rx, ry, rz};
    T w[4];
    iu::quad_weights(p, qr, iu::quad_rel_eps<T>(), w);
    for (int iv = 0; iv < n_vars; ++iv) {
      const int dr = vroles[iv];
      T acc = w[0] * row[dr * K + k];
#pragma unroll
      for (int v = 1; v < 4; ++v) acc = acc + w[v] * row[(dr + v) * K + k];
      vals[iv] = acc;
    }
  }
}

// A grid's extension rows: row s holds candidates K..K+k of the bin
// whose overflow miss carries slot s, in the main rows' layout with k
// candidates (count column count_col, width W), probed in the bin's
// frame; table null on a grid without them.
template <typename T>
struct ExtRows {
  const T* table;
  int W, k, count_col;
};

// A query coordinate of type R in the bin grid's type T: as it is, or a
// float64 coordinate rounded to float32 for a float32 grid's bins.
template <typename T, typename R>
__device__ __forceinline__ T bin_arg(R x) {
  if constexpr (sizeof(T) < sizeof(R)) {
    return __double2float_rn(x);
  } else {
    return x;
  }
}

// The bin order of the batch, moved as runs (see the header): the key
// pass, the scan and the scatter over tiles of the batch; the probe a
// chunk of a coarse bucket at a time; the unsort over the same tiles.
constexpr int kKeyThreads = 512;     // key pass, scatter, unsort
constexpr int kMaxKeys = 8192;       // coarse keys: the key pass's counts
constexpr int kScanThreads = 1024;   // the scan, one block
constexpr int kProbeThreads = 512;   // the chunk probe
constexpr int kProbeThreadsExt = 256;  // the double probe with extension rows
constexpr int kMaxChunk = 4096;      // queries of a chunk
constexpr int kMaxSpan = 4096;       // flat bins of a coarse key
constexpr int kSmemCap = 200 * 1024;  // dynamic shared memory of a block

// Lets `kernel` take up to kSmemCap bytes of dynamic shared memory on the
// current device, once a device (bit d of *allowed: device d; devices
// past 31 set it every launch).
template <typename Kern>
cudaError_t allow_smem(Kern kernel, unsigned* allowed) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (*allowed & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemCap);
  if (err == cudaSuccess) *allowed |= bit;
  return err;
}

// Exclusive scan across a block of THREADS threads of the PER values
// each thread holds (thread t the values PER t .. PER t + PER - 1), in
// place; returns the total.  Every thread of the block calls it.
template <int THREADS, int PER>
__device__ int block_scan(int (&v)[PER]) {
  __shared__ int wsum[THREADS / 32 + 1];
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  int sum = 0;
#pragma unroll
  for (int i = 0; i < PER; ++i) sum += v[i];
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) wsum[w] = incl;
  __syncthreads();
  if (w == 0) {
    const int ws = lane < THREADS / 32 ? wsum[lane] : 0;
    int wi = ws;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, wi, o);
      if (lane >= o) wi += y;
    }
    if (lane < THREADS / 32) wsum[lane] = wi - ws;
    if (lane == 31) wsum[THREADS / 32] = wi;
  }
  __syncthreads();
  int run = wsum[w] + incl - sum;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int x = v[i];
    v[i] = run;
    run += x;
  }
  const int total = wsum[THREADS / 32];
  __syncthreads();
  return total;
}

// Exclusive scan of a[0, n) in shared memory, n <= THREADS * PER, by
// every thread of the block; the caller has synchronized after its
// writes to a, and the scan synchronizes before it returns.
template <int THREADS, int PER>
__device__ void block_scan_smem(int* a, int n) {
  int v[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int k = PER * threadIdx.x + i;
    v[i] = k < n ? a[k] : 0;
  }
  block_scan<THREADS, PER>(v);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int k = PER * threadIdx.x + i;
    if (k < n) a[k] = v[i];
  }
  __syncthreads();
}

// A query's flat candidate bin (ops/geometry.py:bin_ijk and bin_flat): R
// the query's type, T the bins'; a float32 grid bins float64 queries by
// their float32 rounding (the hi of their hi/lo split).
template <typename T, typename R>
__device__ __forceinline__ int flat_bin(const iu::BinGrid<T>& bins, R x, R y,
                                        R z) {
  int i, j, k;
  iu::bin_ijk(bins, bin_arg<T>(x), bin_arg<T>(y), bin_arg<T>(z), i, j, k);
  return iu::bin_flat(bins, i, j, k);
}

// 1. Key pass: each query's coarse key, its flat bin >> span_shift (so a
// key is a range of 2^span_shift flat bins, and bin order inside a key is
// ascending flat order), counted a tile of kKeyThreads x ITEMS queries at
// a time in shared memory; a tile takes each key's ranks with one global
// atomic, so its queries of a key get consecutive ranks (a run), and the
// scan of its counts gives each query its position among the tile's
// slots (the runs of the tile in ascending key order).
template <typename R, typename T, int ITEMS>
__global__ void __launch_bounds__(kKeyThreads)
cand_key_kernel(const R* __restrict__ r, int n, iu::BinGrid<T> bins,
                int span_shift, int n_keys, int* __restrict__ counts,
                int* __restrict__ key_out, int* __restrict__ rank_out,
                int* __restrict__ pos_out) {
  constexpr int kTile = kKeyThreads * ITEMS;
  extern __shared__ int key_hist[];  // n_keys counts, then n_keys ranks
  int* first = key_hist + n_keys;
  for (int k = threadIdx.x; k < n_keys; k += kKeyThreads) key_hist[k] = 0;
  __syncthreads();
  const int base = blockIdx.x * kTile + threadIdx.x;
  int key[ITEMS], local[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int q = base + i * kKeyThreads;
    if (q < n) {
      key[i] = flat_bin(bins, r[3 * q + 0], r[3 * q + 1], r[3 * q + 2]) >>
               span_shift;
      local[i] = atomicAdd(key_hist + key[i], 1);
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n_keys; k += kKeyThreads) {
    const int c = key_hist[k];
    first[k] = c != 0 ? atomicAdd(counts + k, c) : 0;
  }
  block_scan_smem<kKeyThreads, kMaxKeys / kKeyThreads>(key_hist, n_keys);
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int q = base + i * kKeyThreads;
    if (q < n) {
      key_out[q] = key[i];
      rank_out[q] = first[key[i]] + local[i];
      pos_out[q] = key_hist[key[i]] + local[i];
    }
  }
}

// 2. Scan, one block: starts (exclusive scan of the counts: where each
// key's bucket begins in coarse order) and chunk_end (inclusive scan of
// each bucket's chunks of `chunk` queries: block c of the probe takes the
// chunk c); split, where not null, adds the buckets of more than one
// chunk.
__global__ void __launch_bounds__(kScanThreads)
cand_key_scan_kernel(const int* __restrict__ counts, int n_keys, int chunk,
                     int* __restrict__ starts, int* __restrict__ chunk_end,
                     int* __restrict__ split) {
  constexpr int PER = kMaxKeys / kScanThreads;
  int c[PER], ch[PER], n_split = 0;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int k = PER * threadIdx.x + i;
    c[i] = k < n_keys ? counts[k] : 0;
    ch[i] = (c[i] + chunk - 1) / chunk;
    n_split += ch[i] > 1;
  }
  block_scan<kScanThreads, PER>(c);
  int ch_incl[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) ch_incl[i] = ch[i];
  block_scan<kScanThreads, PER>(ch);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int k = PER * threadIdx.x + i;
    if (k < n_keys) {
      starts[k] = c[i];
      chunk_end[k] = ch[i] + ch_incl[i];
    }
  }
  if (split != nullptr && n_split != 0) atomicAdd(split, n_split);
}

// 3. Scatter: a tile's queries to their slots in coarse order, starts[key]
// + rank, staged in shared memory in slot order and stored run by run
// with consecutive threads; slot[q] keeps the way back.  A record holds
// the query as the probe reads it (MODE 0: float32 x, y, z, 3 words; 1:
// float64 queries split into float32 hi and lo, 6 words; 2: float32 hi
// and its lo from r_lo, zeros where r_lo is null, 6 words; 3: float64 x,
// y, z, 6 words).
template <int MODE>
__device__ __forceinline__ void query_words(const void* __restrict__ r,
                                            const float* __restrict__ r_lo,
                                            int q, int (&w)[MODE == 0 ? 3 : 6]) {
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    if constexpr (MODE == 0) {
      w[d] = static_cast<const int*>(r)[3 * q + d];
    } else if constexpr (MODE == 1) {
      const double x = static_cast<const double*>(r)[3 * q + d];
      const float hi = __double2float_rn(x);
      w[d] = __float_as_int(hi);
      w[3 + d] = __float_as_int(__double2float_rn(x - (double)hi));
    } else if constexpr (MODE == 2) {
      w[d] = static_cast<const int*>(r)[3 * q + d];
      w[3 + d] = r_lo != nullptr ? __float_as_int(r_lo[3 * q + d]) : 0;
    } else {
      const long long b =
          __double_as_longlong(static_cast<const double*>(r)[3 * q + d]);
      w[2 * d] = (int)b;
      w[2 * d + 1] = (int)(b >> 32);
    }
  }
}

template <int MODE, int ITEMS>
__global__ void __launch_bounds__(kKeyThreads)
cand_key_scatter_kernel(const void* __restrict__ r,
                        const float* __restrict__ r_lo, int n,
                        const int* __restrict__ key,
                        const int* __restrict__ rank,
                        const int* __restrict__ pos,
                        const int* __restrict__ starts, int* __restrict__ rec,
                        int* __restrict__ slot) {
  constexpr int RW = MODE == 0 ? 3 : 6;
  constexpr int kTile = kKeyThreads * ITEMS;
  extern __shared__ int staged[];  // kTile records, then kTile slots
  int* sdst = staged + kTile * RW;
  const int base = blockIdx.x * kTile;
  const int tile_n = min(kTile, n - base);
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int idx = threadIdx.x + i * kKeyThreads;
    if (idx < tile_n) {
      const int q = base + idx, p = pos[q];
      const int d = starts[key[q]] + rank[q];
      int w[RW];
      query_words<MODE>(r, r_lo, q, w);
      slot[q] = d;
      sdst[p] = d;
#pragma unroll
      for (int e = 0; e < RW; ++e) staged[p * RW + e] = w[e];
    }
  }
  __syncthreads();
  for (int x = threadIdx.x; x < tile_n * RW; x += kKeyThreads) {
    const int j = x / RW;
    rec[(size_t)sdst[j] * RW + (x - j * RW)] = staged[x];
  }
}

// The probe of one query by a group of G = 1 << log2_g lanes (G a power of
// two, at most 32; `lane` this thread's lane in it): lane l takes the
// candidates l, l + G, ... (VEC: the 4-candidate chunks l, l + G, ..., each
// role read with one 16-byte load), keeping the first of equal margins;
// the group's butterfly argmax keeps the lower k on ties, the warp
// probe's rule.  For the quantized rows the group probes in the local
// frame r - center of its bin (ops/geometry.py:cand_bin_center_cols); for
// the df-plane rows (LAYOUT 3) in the hi/lo local frame of the query's hi
// and lo.  The winner's lane writes the query's record (id, aux, values:
// 2 + n_vars words; layout 3: 2 + 2 n_vars, hi values then lo; double
// values: 2 + 2 n_vars) at rec + slot * stride (stride in 4-byte words,
// even for doubles).  Every lane of the warp calls it (the butterflies);
// a group that is not `live` writes nothing.  T: the rows' type, float
// or double (a float64 grid's rows, layouts 1 and 2, VEC false).
template <int NF, int LAYOUT, bool VEC, bool EXT, typename T>
__device__ __forceinline__ void probe_group(
    const T* __restrict__ table, int W, bool live, const T (&qhi)[3],
    const float (&qlo)[3], const iu::BinGrid<T>& bins, int K, int id_role,
    int count_col, T eps, int ovf_base, float qinv, int n_vars,
    const int* __restrict__ vroles, const ExtRows<T>& ext, int log2_g,
    int lane, int* rec, int slot, int stride) {
  constexpr bool kQuant = LAYOUT == 0 || LAYOUT == 3;
  constexpr int NW = kQuant ? QuantWords<NF>::SN + QuantWords<NF>::DN : 4 * NF;
  const int G = 1 << log2_g;
  int i, j, k;
  iu::bin_ijk(bins, qhi[0], qhi[1], qhi[2], i, j, k);
  const T* row = table + (size_t)iu::bin_flat(bins, i, j, k) * W;
  T rx = qhi[0], ry = qhi[1], rz = qhi[2];
  float rq_lo[3] = {0.0f, 0.0f, 0.0f};
  if constexpr (LAYOUT == 0) {
    rx = rx - iu::bin_center(bins, 0, i);
    ry = ry - iu::bin_center(bins, 1, j);
    rz = rz - iu::bin_center(bins, 2, k);
  } else if constexpr (LAYOUT == 3) {
    // hi/lo local frame: two_sum(hi, -center), its error plus the lo
    const int ijk[3] = {i, j, k};
    float rl[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const iu::df s = iu::two_sum(qhi[d], -iu::bin_center(bins, d, ijk[d]));
      rl[d] = s.hi;
      rq_lo[d] = s.lo + qlo[d];
    }
    rx = rl[0];
    ry = rl[1];
    rz = rl[2];
  }
  const T ds = kQuant ? row[count_col + 1] : T(0);

  T best_m = T(0);
  int best_k = -1;
  T best_mf[NF];
  auto take = [&](T m, int kc, const T (&mf)[NF]) {
    if (best_k < 0 || m > best_m) {
      best_m = m;
      best_k = kc;
#pragma unroll
      for (int f = 0; f < NF; ++f) best_mf[f] = mf[f];
    }
  };
  if constexpr (VEC) {
    const int4* row4 = reinterpret_cast<const int4*>(row);
    const int k4 = K / 4;
    for (int c = lane; c < k4; c += G) {
      int4 w[NW];
#pragma unroll
      for (int s = 0; s < NW; ++s) w[s] = __ldg(row4 + s * k4 + c);
      int4 ids = make_int4(0, 0, 0, 0);
      if constexpr (kQuant) ids = __ldg(row4 + id_role * k4 + c);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        T mf[NF];
        T m;
        if constexpr (kQuant) {
          QuantWords<NF> qw;
#pragma unroll
          for (int s = 0; s < NW; ++s) {
            qw.w[s] = u == 0 ? w[s].x : u == 1 ? w[s].y : u == 2 ? w[s].z
                                                                   : w[s].w;
          }
          const int id = u == 0 ? ids.x : u == 1 ? ids.y : u == 2 ? ids.z
                                                                  : ids.w;
          m = quant_margin<NF>(qw, __int_as_float(id) < 0.0f, rx, ry, rz,
                               qinv, ds, mf);
        } else {
          T g[4 * NF];
#pragma unroll
          for (int s = 0; s < NW; ++s) {
            g[s] = __int_as_float(u == 0 ? w[s].x : u == 1 ? w[s].y
                                  : u == 2 ? w[s].z : w[s].w);
          }
          m = plane_margin<NF>(g, rx, ry, rz, mf);
        }
        take(m, 4 * c + u, mf);
      }
    }
  } else {
    for (int kc = lane; kc < K; kc += G) {
      T mf[NF];
      const T m = row_margin<NF, LAYOUT>(row, K, kc, id_role, rx, ry, rz,
                                         qinv, ds, mf);
      take(m, kc, mf);
    }
  }

  // Butterfly argmax over the group (lanes without a candidate carry
  // k = -1 and never win)
  T wm = best_m;
  int wk = best_k;
  for (int off = G >> 1; off > 0; off >>= 1) {
    const T om = __shfl_xor_sync(0xffffffffu, wm, off);
    const int ok = __shfl_xor_sync(0xffffffffu, wk, off);
    if (ok >= 0 && (wk < 0 || om > wm || (om == wm && ok < wk))) {
      wm = om;
      wk = ok;
    }
  }
  constexpr int kWords = (int)sizeof(T) / 4;  // record words a value
  T* vals = reinterpret_cast<T*>(rec + 2);
  const int vstride = stride / kWords;
  // an overflow miss that the extension row did not resolve, and that
  // row's verdict
  bool ext_miss = false;
  int ext_aux = -1;
  if constexpr (EXT) {
    // An overflow miss of the main row probes its bin's extension row
    // (slot aux) with the same group, in the same frame: every lane knows
    // the main winner, so every lane knows the slot.  Every lane of the
    // warp reaches the second butterfly; groups with nothing to probe
    // carry k = -1.
    int eslot = -1;
    if (live && wk >= 0) {
      const int id_main = (int)row[id_role * K + wk];
      const int cnt = (int)row[count_col];
      const bool found = (wm >= -eps) && (id_main >= 0);
      if (!found && cnt > ovf_base && id_main >= 0) {
        eslot = cnt - (ovf_base + 1);
      }
    }
    const T* erow = ext.table + (size_t)(eslot < 0 ? 0 : eslot) * ext.W;
    const int ext_base = ovf_base + ext.k;
    T e_m = T(0);
    int e_k = -1;
    T e_mf[NF];
    if (eslot >= 0) {
      const T eds = (LAYOUT == 0) ? erow[ext.count_col + 1] : T(0);
      for (int kc = lane; kc < ext.k; kc += G) {
        T mf[NF];
        const T m = row_margin<NF, LAYOUT>(erow, ext.k, kc, id_role, rx, ry,
                                           rz, qinv, eds, mf);
        if (e_k < 0 || m > e_m) {
          e_m = m;
          e_k = kc;
#pragma unroll
          for (int f = 0; f < NF; ++f) e_mf[f] = mf[f];
        }
      }
    }
    T em = e_m;
    int ek = e_k;
    for (int off = G >> 1; off > 0; off >>= 1) {
      const T om = __shfl_xor_sync(0xffffffffu, em, off);
      const int ok = __shfl_xor_sync(0xffffffffu, ek, off);
      if (ok >= 0 && (ek < 0 || om > em || (om == em && ok < ek))) {
        em = om;
        ek = ok;
      }
    }
    if (eslot >= 0 && ek >= 0) {
      const int id_ext = (int)erow[id_role * ext.k + ek];
      const int cnt = (int)erow[ext.count_col];
      if ((em >= -eps) && (id_ext >= 0)) {
        // found in the extension row: its winner's lane writes the record
        if (e_k == ek) {
          write_winner<NF, LAYOUT>(erow, ext.k, ek, em, e_mf, rx, ry, rz,
                                   rq_lo, slot, id_role, ext.count_col, eps,
                                   ext_base, n_vars, vroles, rec, rec + 1,
                                   vals, nullptr, stride, vstride);
        }
        return;
      }
      // not there either: the main winner's record, with the extension
      // row's verdict (-1 exact miss, >= 0 a bin beyond even K + k)
      ext_miss = true;
      ext_aux = (cnt > ext_base && id_ext >= 0) ? cnt - (ext_base + 1) : -1;
    }
  }
  if (!live || wk < 0 || best_k != wk) return;  // the winner's lane finishes
  write_winner<NF, LAYOUT>(
      row, K, wk, wm, best_mf, rx, ry, rz, rq_lo, slot, id_role, count_col,
      eps, ovf_base, n_vars, vroles, rec, rec + 1, vals,
      LAYOUT == 3 ? reinterpret_cast<float*>(vals) + n_vars : nullptr, stride,
      vstride);
  if constexpr (EXT) {
    if (ext_miss) rec[(size_t)slot * stride + 1] = ext_aux;
  }
}

// A record's query, from shared memory: hi (the query as the rows' type)
// and, for the df-plane rows, its lo.
template <int LAYOUT, typename T>
__device__ __forceinline__ void record_query(const int* w, T (&hi)[3],
                                             float (&lo)[3]) {
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    if constexpr (sizeof(T) == 8) {
      hi[d] = reinterpret_cast<const double*>(w)[d];
      lo[d] = 0.0f;
    } else {
      hi[d] = __int_as_float(w[d]);
      lo[d] = LAYOUT == 3 ? __int_as_float(w[3 + d]) : 0.0f;
    }
  }
}

// 4. The probe, a chunk of a coarse bucket a block: block c finds its
// bucket (the first key whose chunk_end passes c) and its chunk there,
// loads the chunk's records coalesced into shared memory, counting-sorts
// them by flat bin there (at most 2^span_shift bins), and its groups
// probe the queries in that order, so the queries of a bin probe its row
// one after the other and the row comes from device memory about once.
// Each query's record replaces its query in shared memory (sw words a
// query, the larger of the two), and the block stores the chunk's
// records at their coarse-order positions with consecutive threads.
// Blocks past the last chunk return at once.  THREADS threads a block,
// chunks of at most MAX_CHUNK queries (the port's: kProbeThreads,
// kMaxChunk; tools/cand_order_alternatives.cu times others).  Without
// extension rows, two blocks of 512 threads an SM: at most 64 registers.
// The extension probe keeps a second winner: at 64 registers it spilled
// (the float64 box's probe 1.5x as long), so it may take 128: one block
// of 512 threads an SM, and the double one two blocks of
// kProbeThreadsExt, which took 0.85x the time of one block of 512 (the
// float32 one 1.26x; tools/cand_ext_sweep.py, PERF.md §6).
template <int NF, int LAYOUT, bool VEC, bool EXT, typename T,
          int THREADS = kProbeThreads, int MAX_CHUNK = kMaxChunk>
__global__ void __launch_bounds__(THREADS, (EXT ? 512 : 1024) / THREADS)
cand_rows_chunk_kernel(
    const T* __restrict__ table, int W, const int* __restrict__ rec_in,
    const int* __restrict__ starts, const int* __restrict__ counts,
    const int* __restrict__ chunk_end, int n_keys, int span_shift, int chunk,
    int log2_g, iu::BinGrid<T> bins, int K, int id_role, int count_col, T eps,
    int ovf_base, float qinv, int n_vars, const int* __restrict__ vroles,
    int* __restrict__ rec_out, ExtRows<T> ext) {
  // record words: float32 x, y, z, or six: a float64 grid's doubles, or
  // the df-plane rows' hi and lo
  constexpr int RW = (sizeof(T) == 8 || LAYOUT == 3) ? 6 : 3;
  constexpr int kItems = MAX_CHUNK / THREADS;
  const int os = 2 + (LAYOUT == 3 ? 2 : (int)sizeof(T) / 4) * n_vars;
  const int sw = os > RW ? os : RW;
  const int span = 1 << span_shift;
  extern __shared__ __align__(16) int probe_smem[];
  int* srec = probe_smem;             // chunk x sw words
  int* shist = srec + chunk * sw;     // span counts
  unsigned short* sorder = reinterpret_cast<unsigned short*>(shist + span);

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

  for (int b = threadIdx.x; b < span; b += THREADS) shist[b] = 0;
  for (int x = threadIdx.x; x < n * RW; x += THREADS) {
    const int jq = x / RW;
    srec[jq * sw + (x - jq * RW)] = rec_in[(size_t)base * RW + x];
  }
  __syncthreads();
  const int key_bin = key << span_shift;
  int fine[kItems], local[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int iq = threadIdx.x + it * THREADS;
    if (iq < n) {
      T qh[3];
      float ql[3];
      record_query<LAYOUT>(srec + iq * sw, qh, ql);
      fine[it] = flat_bin(bins, qh[0], qh[1], qh[2]) - key_bin;
      local[it] = atomicAdd(shist + fine[it], 1);
    }
  }
  __syncthreads();
  block_scan_smem<THREADS, kMaxSpan / THREADS>(shist, span);
  __shared__ int next_f;  // the next position in bin order a warp takes
  if (threadIdx.x == 0) next_f = 0;
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int iq = threadIdx.x + it * THREADS;
    if (iq < n) sorder[shist[fine[it]] + local[it]] = (unsigned short)iq;
  }
  __syncthreads();

  // Each warp takes the next 32 / G positions in bin order until none are
  // left, so that warps slowed by their queries (an extension row, a
  // longer row) take fewer and the block's last warp finishes soon after
  // the others; the groups of a warp probe consecutive positions.
  const int per_warp = 32 >> log2_g;
  const int g = (threadIdx.x & 31) >> log2_g;
  const int lane = threadIdx.x & ((1 << log2_g) - 1);
  for (;;) {
    int f0 = 0;
    if ((threadIdx.x & 31) == 0) f0 = atomicAdd(&next_f, per_warp);
    f0 = __shfl_sync(0xffffffffu, f0, 0);
    if (f0 >= n) break;
    const int f = f0 + g;
    const bool live = f < n;
    const int iq = sorder[live ? f : 0];
    T qh[3];
    float ql[3];
    record_query<LAYOUT>(srec + iq * sw, qh, ql);
    probe_group<NF, LAYOUT, VEC, EXT, T>(
        table, W, live, qh, ql, bins, K, id_role, count_col, eps, ovf_base,
        qinv, n_vars, vroles, ext, log2_g, lane, srec, iq, sw);
  }
  __syncthreads();
  for (int x = threadIdx.x; x < n * os; x += THREADS) {
    const int jq = x / os;
    rec_out[(size_t)base * os + x] = srec[jq * sw + (x - jq * os)];
  }
}

// 5. Unsort, the scatter's mirror: a thread a slot of the tile, in slot
// order, loads kUnsortWords words of its record at a time (the tile's
// runs, with consecutive threads), stages them in shared memory, and a
// thread a query writes them in query order: word 0 to out_id, 1 to
// out_aux (where not null), the rest to out_vals (os - 2 words a query).
// FINISH: the call's finished outputs instead: out_id the cell (-1 where
// aux is not -2), found_out the found mask, and the values of a query
// not found the fill value's words (fill_words.x, and .y for the second
// word of a double: wpv words a value).
constexpr int kUnsortWords = 4;

template <int ITEMS, bool FINISH>
__global__ void __launch_bounds__(kKeyThreads)
cand_key_unsort_kernel(const int* __restrict__ rec,
                       const int* __restrict__ slot,
                       const int* __restrict__ pos, int n, int os,
                       int* __restrict__ out_id, int* __restrict__ out_aux,
                       int* __restrict__ out_vals,
                       unsigned char* __restrict__ found_out, int2 fill_words,
                       int wpv) {
  constexpr int kTile = kKeyThreads * ITEMS;
  constexpr int kRow = kUnsortWords + 1;  // padded against bank conflicts
  extern __shared__ int unsort_smem[];
  int* swords = unsort_smem;              // kTile rows of kRow words
  int* src = unsort_smem + kTile * kRow;  // kTile slots
  const int base = blockIdx.x * kTile;
  const int tile_n = min(kTile, n - base);
  const int n_words = os - 2;
  int at[ITEMS];
  bool found[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int idx = threadIdx.x + i * kKeyThreads;
    found[i] = false;
    if (idx < tile_n) {
      at[i] = pos[base + idx];
      src[at[i]] = slot[base + idx];
    }
  }
  __syncthreads();
  for (int w0 = 0; w0 < os; w0 += kUnsortWords) {
    const int nw = min(kUnsortWords, os - w0);
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int p = threadIdx.x + i * kKeyThreads;
      if (p < tile_n) {
        const int* row = rec + (size_t)src[p] * os + w0;
#pragma unroll
        for (int j = 0; j < kUnsortWords; ++j) {
          if (j < nw) swords[p * kRow + j] = row[j];
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int idx = threadIdx.x + i * kKeyThreads;
      if (idx < tile_n) {
        const int q = base + idx;
        const int* st = swords + at[i] * kRow;
#pragma unroll
        for (int j = 0; j < kUnsortWords; ++j) {
          if (j >= nw) continue;
          const int word = w0 + j, v = st[j];
          if (word == 0) {
            if (!FINISH) out_id[q] = v;
          } else if (word == 1) {
            if (out_aux != nullptr) out_aux[q] = v;
            if (FINISH) {
              found[i] = v == -2;
              out_id[q] = found[i] ? st[j - 1] : -1;
              found_out[q] = found[i];
            }
          } else {
            const int e = word - 2;
            out_vals[(size_t)q * n_words + e] =
                !FINISH || found[i] ? v
                                    : (e % wpv ? fill_words.y : fill_words.x);
          }
        }
      }
    }
    __syncthreads();
  }
}

// Launch helpers: kKeyThreads x ITEMS queries a tile, ITEMS 1 to 16.
#define IU_TILE_ITEMS(TILE_, CALL_)   \
  switch ((TILE_) / kKeyThreads) {    \
    case 1: CALL_(1); break;          \
    case 2: CALL_(2); break;          \
    case 4: CALL_(4); break;          \
    case 8: CALL_(8); break;          \
    case 16: CALL_(16); break;        \
    default: return (int)cudaErrorInvalidValue; \
  }

bool bad_tile(int tile) {
  return tile < kKeyThreads || tile > 16 * kKeyThreads ||
         tile % kKeyThreads != 0;
}

template <typename R, typename T>
int cand_key(const R* r, int n, const T* rmin, const T* inv_h, int nbx,
             int nby, int nbz, int span_shift, int n_keys, int tile,
             int* counts, int* key, int* rank, int* pos, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (bad_tile(tile) || n_keys < 1 || n_keys > kMaxKeys || span_shift < 0 ||
      span_shift > 30 ||
      (((long long)nbx * nby * nbz - 1) >> span_shift) + 1 != n_keys) {
    return (int)cudaErrorInvalidValue;
  }
  const iu::BinGrid<T> bins{rmin, inv_h, nbx, nby, nbz};
  const size_t smem = 2 * sizeof(int) * (size_t)n_keys;
  const int blocks = (int)(((long long)n + tile - 1) / tile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
#define IU_KEY_CALL(I_)                                                    \
  do {                                                                     \
    static unsigned allowed = 0;                                           \
    err = allow_smem(cand_key_kernel<R, T, I_>, &allowed);                 \
    if (err != cudaSuccess) return (int)err;                               \
    cand_key_kernel<R, T, I_><<<blocks, kKeyThreads, smem, s>>>(           \
        r, n, bins, span_shift, n_keys, counts, key, rank, pos);           \
  } while (0)
  IU_TILE_ITEMS(tile, IU_KEY_CALL)
#undef IU_KEY_CALL
  return (int)cudaGetLastError();
}

template <int MODE>
int cand_key_scatter(const void* r, const float* r_lo, int n, int tile,
                     const int* key, const int* rank, const int* pos,
                     const int* starts, int* rec, int* slot, void* stream) {
  constexpr int RW = MODE == 0 ? 3 : 6;
  const size_t smem = sizeof(int) * (size_t)tile * (RW + 1);
  if (smem > (size_t)kSmemCap) return (int)cudaErrorInvalidValue;
  const int blocks = (int)(((long long)n + tile - 1) / tile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
#define IU_SCATTER_CALL(I_)                                                \
  do {                                                                     \
    static unsigned allowed = 0;                                           \
    err = allow_smem(cand_key_scatter_kernel<MODE, I_>, &allowed);         \
    if (err != cudaSuccess) return (int)err;                               \
    cand_key_scatter_kernel<MODE, I_><<<blocks, kKeyThreads, smem, s>>>(   \
        r, r_lo, n, key, rank, pos, starts, rec, slot);                    \
  } while (0)
  IU_TILE_ITEMS(tile, IU_SCATTER_CALL)
#undef IU_SCATTER_CALL
  return (int)cudaGetLastError();
}

template <typename T>
int cand_rows_chunked(const T* table, int W, const int* rec_in,
                      const int* starts, const int* counts,
                      const int* chunk_end, int n_keys, int span_shift,
                      int chunk, int max_chunks, int lanes, const T* bin_rmin,
                      const T* bin_inv_h, int nbx, int nby, int nbz, int K,
                      int nf, int layout, int id_role, int count_col, T eps,
                      int ovf_base, float qinv, int n_vars, const int* vroles,
                      ExtRows<T> ext, int* rec_out, void* stream) {
  if (max_chunks <= 0) return (int)cudaSuccess;
  if (K <= 0 || n_vars < 0 || lanes < 1 || lanes > 32 ||
      (lanes & (lanes - 1)) != 0 || n_keys < 1 || n_keys > kMaxKeys ||
      chunk < 1 || chunk > kMaxChunk || span_shift < 0 ||
      (1 << span_shift) > kMaxSpan) {
    return (int)cudaErrorInvalidValue;
  }
  const bool has_ext = ext.table != nullptr;
  if (has_ext && (layout == 3 || ext.k <= 0 || ext.count_col + 1 > ext.W)) {
    return (int)cudaErrorInvalidValue;
  }
  const int rw = (sizeof(T) == 8 || layout == 3) ? 6 : 3;
  const int os = 2 + (layout == 3 ? 2 : (int)sizeof(T) / 4) * n_vars;
  const size_t smem = sizeof(int) * ((size_t)chunk * (os > rw ? os : rw) +
                                     (1 << span_shift)) +
                      sizeof(unsigned short) * (size_t)chunk;
  if (smem > (size_t)kSmemCap) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const iu::BinGrid<T> bins{bin_rmin, bin_inv_h, nbx, nby, nbz};
  const int log2_g = __builtin_ctz(lanes);
  cudaError_t err = cudaSuccess;
#define IU_CHUNK_ONE(NF_, L_, V_, E_)                                        \
  do {                                                                       \
    constexpr int kThreads =                                                 \
        E_ && sizeof(T) == 8 ? kProbeThreadsExt : kProbeThreads;             \
    static unsigned allowed = 0;                                             \
    err = allow_smem(cand_rows_chunk_kernel<NF_, L_, V_, E_, T, kThreads>,   \
                     &allowed);                                              \
    if (err != cudaSuccess) return (int)err;                                 \
    cand_rows_chunk_kernel<NF_, L_, V_, E_, T, kThreads>                     \
        <<<max_chunks, kThreads, smem, s>>>(                                 \
            table, W, rec_in, starts, counts, chunk_end, n_keys, span_shift, \
            chunk, log2_g, bins, K, id_role, count_col, eps, ovf_base, qinv, \
            n_vars, vroles, rec_out, ext);                                   \
  } while (0)
  // with the extension probe on a grid that has extension rows
#define IU_CHUNK_KERNEL(NF_, L_, V_)     \
  do {                                   \
    if (has_ext) {                       \
      IU_CHUNK_ONE(NF_, L_, V_, true);   \
    } else {                             \
      IU_CHUNK_ONE(NF_, L_, V_, false);  \
    }                                    \
  } while (0)
  if constexpr (sizeof(T) == 8) {
    // a float64 grid's rows: layouts 1 and 2, one element at a time
    if (layout == 1 && nf == 3) {
      IU_CHUNK_KERNEL(3, 1, false);
    } else if (layout == 1 && nf == 4) {
      IU_CHUNK_KERNEL(4, 1, false);
    } else if (layout == 2 && nf == 4) {
      IU_CHUNK_KERNEL(4, 2, false);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  } else {
    // 16-byte loads along the candidates when every role starts aligned
    const bool vec = K % 4 == 0 && W % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(table) % 16 == 0;
#define IU_CHUNK_LAUNCH(NF_, L_)        \
  do {                                  \
    if (vec) {                          \
      IU_CHUNK_KERNEL(NF_, L_, true);   \
    } else {                            \
      IU_CHUNK_KERNEL(NF_, L_, false);  \
    }                                   \
  } while (0)
    // the df-plane rows (layout 3) have no extension rows
#define IU_DF_LAUNCH(NF_)                  \
  do {                                     \
    if (vec) {                             \
      IU_CHUNK_ONE(NF_, 3, true, false);   \
    } else {                               \
      IU_CHUNK_ONE(NF_, 3, false, false);  \
    }                                      \
  } while (0)
    if (layout == 0 && nf == 3) {
      IU_CHUNK_LAUNCH(3, 0);
    } else if (layout == 0 && nf == 4) {
      IU_CHUNK_LAUNCH(4, 0);
    } else if (layout == 1 && nf == 3) {
      IU_CHUNK_LAUNCH(3, 1);
    } else if (layout == 1 && nf == 4) {
      IU_CHUNK_LAUNCH(4, 1);
    } else if (layout == 2 && nf == 4) {
      IU_CHUNK_LAUNCH(4, 2);
    } else if (layout == 3 && nf == 3) {
      IU_DF_LAUNCH(3);
    } else if (layout == 3 && nf == 4) {
      IU_DF_LAUNCH(4);
    } else {
      return (int)cudaErrorInvalidValue;
    }
#undef IU_DF_LAUNCH
#undef IU_CHUNK_LAUNCH
  }
#undef IU_CHUNK_KERNEL
#undef IU_CHUNK_ONE
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points of the bin-ordered probe (bound with ctypes).  r:
// (B, 3) queries, float32, or float64 where f64 is nonzero (binned by
// their float32 rounding); bin_rmin, bin_inv_h: (3,) float32 on the
// device; nbx, nby, nbz: the candidate bins per axis.  The *_f64 entry
// points take a float64 grid's queries, bin grid ((3,) float64) and rows.
// tile: queries a tile of the key pass, scatter and unsort (512 x 1, 2,
// 4, 8 or 16), the same in the three; span_shift: 2^span_shift flat bins
// a coarse key, n_keys = ((n_bins - 1) >> span_shift) + 1 keys, at most
// 8192.  ops/cand_kernel.py:order_sizing picks them.
//
// iu_cand_key: counts ((n_keys,) int32, zeroed by the caller) gets the
// queries a key; key_out, rank_out and pos_out ((B,) int32) each query's
// key, rank there and position among its tile's slots.
extern "C" int iu_cand_key(const void* r, int f64, int n_queries,
                           const float* bin_rmin, const float* bin_inv_h,
                           int nbx, int nby, int nbz, int span_shift,
                           int n_keys, int tile, int* counts, int* key_out,
                           int* rank_out, int* pos_out, void* stream) {
  if (f64) {
    return cand_key<double, float>(
        static_cast<const double*>(r), n_queries, bin_rmin, bin_inv_h, nbx,
        nby, nbz, span_shift, n_keys, tile, counts, key_out, rank_out,
        pos_out, stream);
  }
  return cand_key<float, float>(static_cast<const float*>(r), n_queries,
                                bin_rmin, bin_inv_h, nbx, nby, nbz,
                                span_shift, n_keys, tile, counts, key_out,
                                rank_out, pos_out, stream);
}

extern "C" int iu_cand_key_f64(const double* r, int n_queries,
                               const double* bin_rmin,
                               const double* bin_inv_h, int nbx, int nby,
                               int nbz, int span_shift, int n_keys, int tile,
                               int* counts, int* key_out, int* rank_out,
                               int* pos_out, void* stream) {
  return cand_key<double, double>(r, n_queries, bin_rmin, bin_inv_h, nbx,
                                  nby, nbz, span_shift, n_keys, tile, counts,
                                  key_out, rank_out, pos_out, stream);
}

// iu_cand_key_scan: from the key pass's counts, starts ((n_keys,) int32,
// where each key's queries begin in coarse order) and chunk_end
// ((n_keys,) int32, the inclusive scan of each key's chunks of `chunk`
// queries); split (a device int32, or null) adds the keys of more than
// one chunk.
extern "C" int iu_cand_key_scan(const int* counts, int n_keys, int chunk,
                                int* starts, int* chunk_end, int* split,
                                void* stream) {
  if (n_keys < 1 || n_keys > kMaxKeys || chunk < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cand_key_scan_kernel<<<1, kScanThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      counts, n_keys, chunk, starts, chunk_end, split);
  return (int)cudaGetLastError();
}

// iu_cand_key_scatter: each query's record to its slot in coarse order,
// rec ((B, 3) int32 words for mode 0, (B, 6) else; see the scatter's
// modes: 0 float32 queries, 1 float64 queries split into hi and lo for
// the df-plane rows, 2 float32 queries and their lo parts r_lo (null:
// zeros), 3 a float64 grid's queries), and slot ((B,) int32, each
// query's position in coarse order), from the key pass's key, rank and
// pos and the scan's starts.
extern "C" int iu_cand_key_scatter(const void* r, const float* r_lo, int mode,
                                   int n_queries, int tile, const int* key,
                                   const int* rank, const int* pos,
                                   const int* starts, int* rec, int* slot,
                                   void* stream) {
  if (n_queries <= 0) return (int)cudaSuccess;
  if (bad_tile(tile)) return (int)cudaErrorInvalidValue;
  switch (mode) {
    case 0:
      return cand_key_scatter<0>(r, r_lo, n_queries, tile, key, rank, pos,
                                 starts, rec, slot, stream);
    case 1:
      return cand_key_scatter<1>(r, r_lo, n_queries, tile, key, rank, pos,
                                 starts, rec, slot, stream);
    case 2:
      return cand_key_scatter<2>(r, r_lo, n_queries, tile, key, rank, pos,
                                 starts, rec, slot, stream);
    case 3:
      return cand_key_scatter<3>(r, r_lo, n_queries, tile, key, rank, pos,
                                 starts, rec, slot, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// iu_cand_rows_chunked: the probe of a table ((n_bins, W), one row per
// bin), a chunk of at most `chunk` queries of a coarse key a block
// (max_chunks blocks, at least the chunks chunk_end counts), `lanes` lanes
// a query (1, 2, 4, 8, 16 or 32); layout 0 quantized simplex (the kernel
// computes r_local), 1 f32 simplex, 2 quad, 3 df planes (the hi/lo
// r_local from the records' hi and lo).  rec_in: the scatter's records;
// ext_table: the extension rows ((n_ext, ext_W), ext_k candidates, count
// at column ext_count_col), layouts 0-2, or null: an overflow miss of the
// main row then probes the extension row of its slot in the same launch,
// and its record holds the extension winner where that row contains the
// query, else the main winner's id and values with the extension row's
// verdict (-1, or >= 0 where even K + ext_k candidates do not hold the
// bin).  rec_out: (B, 2 + n_vars) int32 (layout 3: 2 + 2 n_vars), one
// record a query in coarse order: id, aux, then the values' float bits
// (layout 3: hi, then lo).  iu_cand_rows_chunked_f64: a float64 grid's
// rows (layouts 1 and 2), records, bin grid and extension rows; rec_out
// (B, 2 + 2 n_vars), the values as doubles.
extern "C" int iu_cand_rows_chunked(
    const float* table, int W, const int* rec_in, const int* starts,
    const int* counts, const int* chunk_end, int n_keys, int span_shift,
    int chunk, int max_chunks, int lanes, const float* bin_rmin,
    const float* bin_inv_h, int nbx, int nby, int nbz, int K, int nf,
    int layout, int id_role, int count_col, float eps, int ovf_base,
    float qinv, int n_vars, const int* vroles, const float* ext_table,
    int ext_W, int ext_k, int ext_count_col, int* rec_out, void* stream) {
  return cand_rows_chunked<float>(
      table, W, rec_in, starts, counts, chunk_end, n_keys, span_shift, chunk,
      max_chunks, lanes, bin_rmin, bin_inv_h, nbx, nby, nbz, K, nf, layout,
      id_role, count_col, eps, ovf_base, qinv, n_vars, vroles,
      {ext_table, ext_W, ext_k, ext_count_col}, rec_out, stream);
}

extern "C" int iu_cand_rows_chunked_f64(
    const double* table, int W, const int* rec_in, const int* starts,
    const int* counts, const int* chunk_end, int n_keys, int span_shift,
    int chunk, int max_chunks, int lanes, const double* bin_rmin,
    const double* bin_inv_h, int nbx, int nby, int nbz, int K, int nf,
    int layout, int id_role, int count_col, double eps, int ovf_base,
    int n_vars, const int* vroles, const double* ext_table, int ext_W,
    int ext_k, int ext_count_col, int* rec_out, void* stream) {
  if (layout == 3) return (int)cudaErrorInvalidValue;
  return cand_rows_chunked<double>(
      table, W, rec_in, starts, counts, chunk_end, n_keys, span_shift, chunk,
      max_chunks, lanes, bin_rmin, bin_inv_h, nbx, nby, nbz, K, nf, layout,
      id_role, count_col, eps, ovf_base, 0.0f, n_vars, vroles,
      {ext_table, ext_W, ext_k, ext_count_col}, rec_out, stream);
}

// iu_cand_key_unsort: the probe's records ((B, os) int32 words in coarse
// order) back in query order through slot and pos: out_id, out_aux (B,)
// int32 (out_aux may be null), out_vals (B, os - 2) 4-byte words (the
// df-plane records: hi columns then lo; a float64 grid's: the words of
// the doubles).  finish: out_id the cell where found (aux -2), else -1,
// found_out ((B,) bool) the found mask, and the values of the queries
// not found the fill value (fill_lo, and fill_hi for the high word of a
// double; wpv words a value).
extern "C" int iu_cand_key_unsort(const int* rec, const int* slot,
                                  const int* pos, int n_queries, int tile,
                                  int os, int* out_id, int* out_aux,
                                  int* out_vals, unsigned char* found_out,
                                  int finish, int fill_lo, int fill_hi,
                                  int wpv, void* stream) {
  if (n_queries <= 0) return (int)cudaSuccess;
  if (bad_tile(tile) || os < 2 || wpv < 1 ||
      (finish && found_out == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(int) * (size_t)tile * (kUnsortWords + 2);
  if (smem > (size_t)kSmemCap) return (int)cudaErrorInvalidValue;
  const int blocks = (int)(((long long)n_queries + tile - 1) / tile);
  const int2 fill = make_int2(fill_lo, fill_hi);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
#define IU_UNSORT_ONE(I_, F_)                                              \
  do {                                                                     \
    static unsigned allowed = 0;                                           \
    err = allow_smem(cand_key_unsort_kernel<I_, F_>, &allowed);            \
    if (err != cudaSuccess) return (int)err;                               \
    cand_key_unsort_kernel<I_, F_><<<blocks, kKeyThreads, smem, s>>>(      \
        rec, slot, pos, n_queries, os, out_id, out_aux, out_vals,          \
        found_out, fill, wpv);                                             \
  } while (0)
#define IU_UNSORT_CALL(I_)        \
  do {                            \
    if (finish) {                 \
      IU_UNSORT_ONE(I_, true);    \
    } else {                      \
      IU_UNSORT_ONE(I_, false);   \
    }                             \
  } while (0)
  IU_TILE_ITEMS(tile, IU_UNSORT_CALL)
#undef IU_UNSORT_CALL
#undef IU_UNSORT_ONE
  return (int)cudaGetLastError();
}
#undef IU_TILE_ITEMS

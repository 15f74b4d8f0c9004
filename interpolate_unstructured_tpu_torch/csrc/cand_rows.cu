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
// (the L2 holds 50 MB of the 2.9 GB table).  So the queries are
// counting-sorted by bin (cand_bin_pass_kernel, a scan,
// cand_bin_scatter_kernel), then probed in that order, a group of lanes
// per query (cand_rows_binned_kernel), so the queries of one bin probe
// its row one after the other and it comes from DRAM about once; the
// probe writes each query's record at its sorted slot, and
// cand_bin_unsort_kernel puts the records back in query order.  On the
// H100, writing the outputs straight to each query's own position cost
// more than the probe (random 4-byte writes).  One thread per query
// took 3x as long as a group of 4 lanes at 1M queries (half a query a
// bin), 4 lanes 1.2x as long as 2 at 10M (5 a bin), so the wrapper picks
// the group size by queries per bin (ops/cand_kernel.py:binned_lanes;
// PERF.md §6).  The front end also computes the bin index and local
// frame.  Its bound: the distinct rows once, the queries and outputs
// once (permutation and records are its own scratch).  The probe with
// 16-byte loads takes 54-64 registers (64 for quantized tets: 4 blocks
// of 256 threads an SM), no spills.
//
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
// bin pass and the probe read the queries as given, float64 (B, 3) or a
// float32 hi/lo pair, and split them themselves, hi = f32(r) rounded to
// nearest and lo = f32(r - f64(hi)) (ops/df32.py:split_queries); the
// probe forms the hi/lo local frame two_sum(hi - center) + lo of
// ops/cand_kernel.py:local_frame_df.  A query's record is then id, aux,
// V hi and V lo values, and the unsort moves 2 + 2V words.  The 24 bytes
// of float64 input a query replace the 24 of the hi/lo frame the direct
// layout-3 kernel read, so the bound counts the same bytes.
//
// Packed int16 words are often NaN bit patterns as floats, so the
// qn/qd roles are read through an int pointer and unpacked with integer
// shifts only.  Plain PyTorch version: ops/cand_kernel.py:probe_rows_plain,
// whose rounding order this kernel follows (built with --fmad=false).
//
// A float64 grid's rows are never quantized: they take layouts 1 and 2 in
// double (the JAX package's float64 route, its XLA _probe_rows_xla,
// ops/locate.py:562).  The bin pass and the probe in bin order are
// templates on the rows' type T, instantiated for float and
// for double (the *_f64 entry points, scalars in double); the bin pass of
// a float64 grid bins each query in double against the grid's float64
// origin and inverse sizes, where accurate mode's bin pass on a float32
// grid bins float64 queries by their float32 rounding.  The scatter and
// the unsort move 4-byte words, whatever they hold: a double value is two
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

// Bin-ordered front end (the main table's layouts 0-2 and the df-plane
// rows), four launches: the bin pass, the scatter, the probe in bin
// order, the unsort.
constexpr int kOrderThreads = 256;

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

// Bin pass: each query's flat candidate bin (ops/geometry.py:bin_ijk and
// bin_flat) and its rank among its bin's queries, from an
// atomic count per bin.  The 1.9M+ bin counts of the main path do not
// fit in shared memory (8 MB), so they are counted in device memory,
// where they stay L2-resident.  R: the queries' type; T: the bins',
// float for a float32 grid, which bins float64 queries by their float32
// rounding hi = f32(r) (a hi/lo pair is binned by its hi, as float
// queries), or double for a float64 grid, which bins them in double.
template <typename R, typename T>
__global__ void cand_bin_pass_kernel(const R* __restrict__ r, int n,
                                     iu::BinGrid<T> bins,
                                     int* __restrict__ counts,
                                     int* __restrict__ bin_out,
                                     int* __restrict__ rank_out) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n) return;
  int i, j, k;
  iu::bin_ijk(bins, bin_arg<T>(r[3 * q + 0]), bin_arg<T>(r[3 * q + 1]),
              bin_arg<T>(r[3 * q + 2]), i, j, k);
  const int b = iu::bin_flat(bins, i, j, k);
  bin_out[q] = b;
  rank_out[q] = atomicAdd(counts + b, 1);
}

// Scatter: query q goes to slot ends[b] - 1 - rank of its bin b, where
// ends is the inclusive scan of the counts, so perm groups the queries
// by bin in ascending bin order (in each bin, in the order of the
// atomics: each query's result is independent of the others); slot[q]
// keeps the way back.
__global__ void cand_bin_scatter_kernel(const int* __restrict__ bin,
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

// Probe in bin order: a group of G lanes per query (G a power of two, at
// most 32), the queries taken in the order of perm, so the groups of a
// warp and of its neighbours probe the few rows of adjacent bins and
// their loads hit L1.  Lane l of a group takes the candidates l, l + G,
// ... (VEC: the 4-candidate chunks l, l + G, ..., each role read with
// one 16-byte load), keeping the first of equal margins; the group's
// butterfly argmax keeps the lower k on ties, the warp probe's rule.
// For the quantized rows the group probes in the local frame r - center
// of its bin (ops/geometry.py:cand_bin_center_cols); for the df-plane
// rows (LAYOUT 3) it splits the query as given and forms the hi/lo local
// frame (F64: r is float64 (B, 3); else r is the float32 hi and r_lo the
// lo, or null for zeros).  The winner's lane writes the query's record
// (id, aux, values: 2 + n_vars words; layout 3: 2 + 2 n_vars, hi values
// then lo; double values: 2 + 2 n_vars) at its slot, next to its
// neighbours' records; cand_bin_unsort_kernel puts the records back in
// query order.  T: the rows' type, float or double (a float64 grid's
// rows, layouts 1 and 2, queries in double, VEC and F64 false).
template <int NF, int LAYOUT, bool VEC, bool F64, bool EXT, typename T>
__global__ void __launch_bounds__(kOrderThreads)
cand_rows_binned_kernel(
    const T* __restrict__ table, int W, const void* __restrict__ r,
    const float* __restrict__ r_lo, const int* __restrict__ perm,
    int n_queries, int log2_g, iu::BinGrid<T> bins, int K, int id_role,
    int count_col, T eps, int ovf_base, float qinv, int n_vars,
    const int* __restrict__ vroles, int* __restrict__ rec, ExtRows<T> ext) {
  constexpr bool kQuant = LAYOUT == 0 || LAYOUT == 3;
  constexpr int NW = kQuant ? QuantWords<NF>::SN + QuantWords<NF>::DN : 4 * NF;
  const int G = 1 << log2_g;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int slot = (int)(t >> log2_g);
  const int lane = threadIdx.x & (G - 1);
  // every lane of the warp reaches the butterfly: the lanes past the
  // last query probe query perm[0] and write nothing
  const bool live = slot < n_queries;
  const int q = perm[live ? slot : 0];
  T hi[3], lo[3] = {T(0), T(0), T(0)};
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    if constexpr (F64) {
      const double x = static_cast<const double*>(r)[3 * q + d];
      hi[d] = __double2float_rn(x);
      lo[d] = __double2float_rn(x - (double)hi[d]);
    } else {
      hi[d] = static_cast<const T*>(r)[3 * q + d];
      if (LAYOUT == 3 && r_lo != nullptr) lo[d] = r_lo[3 * q + d];
    }
  }
  int i, j, k;
  iu::bin_ijk(bins, hi[0], hi[1], hi[2], i, j, k);
  const T* row = table + (size_t)iu::bin_flat(bins, i, j, k) * W;
  T rx = hi[0], ry = hi[1], rz = hi[2];
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
      const iu::df s = iu::two_sum(hi[d], -iu::bin_center(bins, d, ijk[d]));
      rl[d] = s.hi;
      rq_lo[d] = s.lo + lo[d];
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
  const int stride = 2 + (LAYOUT == 3 ? 2 : kWords) * n_vars;
  T* vals = reinterpret_cast<T*>(rec + 2);
  const int vstride = kWords == 1 ? stride : stride / kWords;
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

// Unsort: query q's record, read back from its slot, into the outputs
// at q.  The record reads are random and the writes coalesced: on the
// H100, the probe's three random 4-byte writes per query, at the
// query's own position, took longer than the probe itself (PERF.md §6).
__global__ void cand_bin_unsort_kernel(const int* __restrict__ rec,
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

template <typename T>
int cand_rows_binned(const T* table, int W, const void* r, const float* r_lo,
                     int f64, const int* perm, int n_queries, int lanes,
                     const T* bin_rmin, const T* bin_inv_h, int nbx, int nby,
                     int nbz, int K, int nf, int layout, int id_role,
                     int count_col, T eps, int ovf_base, float qinv,
                     int n_vars, const int* vroles, ExtRows<T> ext, int* rec,
                     void* stream) {
  if (n_queries <= 0) return (int)cudaSuccess;
  if (K <= 0 || n_vars < 0 || lanes < 1 || lanes > 32 ||
      (lanes & (lanes - 1)) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (layout != 3 && (f64 || r_lo != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool has_ext = ext.table != nullptr;
  if (has_ext && (layout == 3 || ext.k <= 0 || ext.count_col + 1 > ext.W)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const iu::BinGrid<T> bins{bin_rmin, bin_inv_h, nbx, nby, nbz};
  const int log2_g = __builtin_ctz(lanes);
  const long long threads = (long long)n_queries * lanes;
  const int blocks = (int)((threads + kOrderThreads - 1) / kOrderThreads);
#define IU_BINNED_ONE(NF_, L_, V_, D_, E_)                                   \
  cand_rows_binned_kernel<NF_, L_, V_, D_, E_, T>                            \
      <<<blocks, kOrderThreads, 0, s>>>(table, W, r, r_lo, perm, n_queries,  \
                                        log2_g, bins, K, id_role, count_col, \
                                        eps, ovf_base, qinv, n_vars, vroles, \
                                        rec, ext)
  // with the extension probe on a grid that has extension rows
#define IU_BINNED_KERNEL(NF_, L_, V_, D_)     \
  do {                                        \
    if (has_ext) {                            \
      IU_BINNED_ONE(NF_, L_, V_, D_, true);   \
    } else {                                  \
      IU_BINNED_ONE(NF_, L_, V_, D_, false);  \
    }                                         \
  } while (0)
  if constexpr (sizeof(T) == 8) {
    // a float64 grid's rows: layouts 1 and 2, one element at a time
    if (layout == 1 && nf == 3) {
      IU_BINNED_KERNEL(3, 1, false, false);
    } else if (layout == 1 && nf == 4) {
      IU_BINNED_KERNEL(4, 1, false, false);
    } else if (layout == 2 && nf == 4) {
      IU_BINNED_KERNEL(4, 2, false, false);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  } else {
    // 16-byte loads along the candidates when every role starts aligned
    const bool vec = K % 4 == 0 && W % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(table) % 16 == 0;
#define IU_BINNED_LAUNCH(NF_, L_, D_)        \
  do {                                       \
    if (vec) {                               \
      IU_BINNED_KERNEL(NF_, L_, true, D_);   \
    } else {                                 \
      IU_BINNED_KERNEL(NF_, L_, false, D_);  \
    }                                        \
  } while (0)
    // the df-plane rows (layout 3) have no extension rows
#define IU_DF_LAUNCH(NF_, D_)                       \
  do {                                              \
    if (vec) {                                      \
      IU_BINNED_ONE(NF_, 3, true, D_, false);       \
    } else {                                        \
      IU_BINNED_ONE(NF_, 3, false, D_, false);      \
    }                                               \
  } while (0)
    if (layout == 0 && nf == 3) {
      IU_BINNED_LAUNCH(3, 0, false);
    } else if (layout == 0 && nf == 4) {
      IU_BINNED_LAUNCH(4, 0, false);
    } else if (layout == 1 && nf == 3) {
      IU_BINNED_LAUNCH(3, 1, false);
    } else if (layout == 1 && nf == 4) {
      IU_BINNED_LAUNCH(4, 1, false);
    } else if (layout == 2 && nf == 4) {
      IU_BINNED_LAUNCH(4, 2, false);
    } else if (layout == 3 && nf == 3 && f64) {
      IU_DF_LAUNCH(3, true);
    } else if (layout == 3 && nf == 3) {
      IU_DF_LAUNCH(3, false);
    } else if (layout == 3 && nf == 4 && f64) {
      IU_DF_LAUNCH(4, true);
    } else if (layout == 3 && nf == 4) {
      IU_DF_LAUNCH(4, false);
    } else {
      return (int)cudaErrorInvalidValue;
    }
#undef IU_DF_LAUNCH
#undef IU_BINNED_LAUNCH
  }
#undef IU_BINNED_KERNEL
#undef IU_BINNED_ONE
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points of the bin-ordered probe (bound with ctypes).  r:
// (B, 3) queries, float32, or float64 where f64 is nonzero (the df-plane
// rows only); bin_rmin, bin_inv_h: (3,) float32 on the device; nbx, nby,
// nbz: the candidate bins per axis.  The *_f64 entry points take a
// float64 grid's queries, bin grid ((3,) float64) and rows.
//
// iu_cand_bin_pass: counts ((n_bins,) int32, zeroed by the caller) gets
// the queries per bin, bin_out and rank_out ((B,) int32) each query's
// flat bin and its rank in the bin.
extern "C" int iu_cand_bin_pass(const void* r, int f64, int n_queries,
                                const float* bin_rmin, const float* bin_inv_h,
                                int nbx, int nby, int nbz, int* counts,
                                int* bin_out, int* rank_out, void* stream) {
  if (n_queries <= 0) return (int)cudaSuccess;
  const iu::BinGrid<float> bins{bin_rmin, bin_inv_h, nbx, nby, nbz};
  const int blocks = (n_queries + kOrderThreads - 1) / kOrderThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64) {
    cand_bin_pass_kernel<double, float><<<blocks, kOrderThreads, 0, s>>>(
        static_cast<const double*>(r), n_queries, bins, counts, bin_out,
        rank_out);
  } else {
    cand_bin_pass_kernel<float, float><<<blocks, kOrderThreads, 0, s>>>(
        static_cast<const float*>(r), n_queries, bins, counts, bin_out,
        rank_out);
  }
  return (int)cudaGetLastError();
}

extern "C" int iu_cand_bin_pass_f64(const double* r, int n_queries,
                                    const double* bin_rmin,
                                    const double* bin_inv_h, int nbx,
                                    int nby, int nbz, int* counts,
                                    int* bin_out, int* rank_out,
                                    void* stream) {
  if (n_queries <= 0) return (int)cudaSuccess;
  const iu::BinGrid<double> bins{bin_rmin, bin_inv_h, nbx, nby, nbz};
  const int blocks = (n_queries + kOrderThreads - 1) / kOrderThreads;
  cand_bin_pass_kernel<double, double>
      <<<blocks, kOrderThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          r, n_queries, bins, counts, bin_out, rank_out);
  return (int)cudaGetLastError();
}

// iu_cand_bin_scatter: perm ((B,) int32, the queries grouped by bin) and
// slot ((B,) int32, its inverse) from the bin pass's bin and rank and
// ends, the inclusive scan of its counts.
extern "C" int iu_cand_bin_scatter(const int* bin, const int* rank,
                                   const int* ends, int n_queries, int* perm,
                                   int* slot, void* stream) {
  if (n_queries <= 0) return (int)cudaSuccess;
  const int blocks = (n_queries + kOrderThreads - 1) / kOrderThreads;
  cand_bin_scatter_kernel<<<blocks, kOrderThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      bin, rank, ends, n_queries, perm, slot);
  return (int)cudaGetLastError();
}

// iu_cand_rows_binned: the probe of a table ((n_bins, W), one row per
// bin) in the order of perm (the B queries grouped by bin), `lanes`
// lanes per query (1, 2, 4, 8, 16 or 32); layout 0 quantized simplex
// (the kernel computes r_local), 1 f32 simplex, 2 quad, 3 df planes
// (the kernel splits the queries and computes the hi/lo r_local).  r:
// float32 (B, 3), or float64 where f64 is nonzero (layout 3 only); r_lo:
// the float32 lo parts of float32 queries, layout 3 only (null: zeros).
// ext_table: the extension rows ((n_ext, ext_W), ext_k candidates, count
// at column ext_count_col), layouts 0-2, or null: an overflow miss of
// the main row then probes the extension row of its slot in the same
// launch, and its record holds the extension winner where that row
// contains the query, else the main winner's id and values with the
// extension row's verdict (-1, or >= 0 where even K + ext_k candidates
// do not hold the bin).  rec: (B, 2 + n_vars) int32 (layout 3: 2 + 2
// n_vars), one record per slot: id, aux, then the values' float bits
// (layout 3: hi, then lo).  iu_cand_rows_binned_f64: a float64 grid's
// rows (layouts 1 and 2), queries, bin grid and extension rows; rec (B,
// 2 + 2 n_vars), the values as doubles.
extern "C" int iu_cand_rows_binned(
    const float* table, int W, const void* r, const float* r_lo, int f64,
    const int* perm, int n_queries, int lanes, const float* bin_rmin,
    const float* bin_inv_h, int nbx, int nby, int nbz, int K, int nf,
    int layout, int id_role, int count_col, float eps, int ovf_base,
    float qinv, int n_vars, const int* vroles, const float* ext_table,
    int ext_W, int ext_k, int ext_count_col, int* rec, void* stream) {
  return cand_rows_binned<float>(
      table, W, r, r_lo, f64, perm, n_queries, lanes, bin_rmin, bin_inv_h,
      nbx, nby, nbz, K, nf, layout, id_role, count_col, eps, ovf_base, qinv,
      n_vars, vroles, {ext_table, ext_W, ext_k, ext_count_col}, rec, stream);
}

extern "C" int iu_cand_rows_binned_f64(
    const double* table, int W, const double* r, const int* perm,
    int n_queries, int lanes, const double* bin_rmin,
    const double* bin_inv_h, int nbx, int nby, int nbz, int K, int nf,
    int layout, int id_role, int count_col, double eps, int ovf_base,
    int n_vars, const int* vroles, const double* ext_table, int ext_W,
    int ext_k, int ext_count_col, int* rec, void* stream) {
  return cand_rows_binned<double>(
      table, W, r, nullptr, 0, perm, n_queries, lanes, bin_rmin, bin_inv_h,
      nbx, nby, nbz, K, nf, layout, id_role, count_col, eps, ovf_base, 0.0f,
      n_vars, vroles, {ext_table, ext_W, ext_k, ext_count_col}, rec, stream);
}

// iu_cand_bin_unsort: the probe's records ((B, 2 + n_vars) int32 by
// slot) back in query order through slot: out_id, out_aux (B,) int32,
// out_vals (B, n_vars) 4-byte words (the df-plane records: n_vars = 2V,
// hi columns then lo; a float64 grid's: n_vars = 2V, the words of V
// doubles).
extern "C" int iu_cand_bin_unsort(const int* rec, const int* slot,
                                  int n_queries, int n_vars, int* out_id,
                                  int* out_aux, float* out_vals,
                                  void* stream) {
  if (n_queries <= 0) return (int)cudaSuccess;
  if (n_vars < 0) return (int)cudaErrorInvalidValue;
  const int blocks = (n_queries + kOrderThreads - 1) / kOrderThreads;
  cand_bin_unsort_kernel<<<blocks, kOrderThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      rec, slot, n_queries, n_vars, out_id, out_aux, out_vals);
  return (int)cudaGetLastError();
}

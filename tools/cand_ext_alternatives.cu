// Designs of kernel B2's extension-row probe that tools/cand_ext_sweep.py
// times against the one the port keeps (the probe in bin order of
// csrc/cand_rows.cu, which probes an overflow miss's extension row in
// the same launch).  Built by the sweep alone into its own library; the
// port never loads it.
//
//   the direct kernel: one warp a query (lanes over the k_ext
//     candidates, a butterfly argmax), reading the extension row of each
//     query's slot, in query order (order null: the port's design
//     before the fused probe; the caller picked the misses with a host
//     read and gathered their frame in torch), or in the order given
//     (order: the misses' positions grouped by slot, so that the queries
//     of a bin probe its row one after the other).  Outputs at the
//     query's position either way.
//
// The probe arithmetic (row_margin, write_winner) is the port's, so every
// design is torch.equal to ops/cand_kernel.py:probe_rows_plain.

#include "../interpolate_unstructured_tpu_torch/csrc/cand_rows.cu"

namespace {

constexpr int kThreads = 256;  // 8 queries a block

// The probe of one query by one warp: lanes over the K candidates of its
// row, a butterfly argmax, and the winner's lane writes the results.
// rx, ry, rz: the query (r_local when quantized).
template <int NF, int LAYOUT, typename T>
__device__ __forceinline__ void probe_row(
    const T* __restrict__ row, int lane, int q, T rx, T ry, T rz, int K,
    int id_role, int count_col, T eps, int ovf_base, float qinv, int n_vars,
    const int* __restrict__ vroles, int* __restrict__ out_id,
    int* __restrict__ out_aux, T* __restrict__ out_vals) {
  constexpr bool kQuant = LAYOUT == 0;
  const T ds = kQuant ? row[count_col + 1] : T(0);

  T best_m = T(0);
  int best_k = -1;
  T best_mf[NF];
  for (int k = lane; k < K; k += 32) {
    T mf[NF];
    const T m = row_margin<NF, LAYOUT>(row, K, k, id_role, rx, ry, rz, qinv,
                                       ds, mf);
    if (best_k < 0 || m > best_m) {
      best_m = m;
      best_k = k;
#pragma unroll
      for (int f = 0; f < NF; ++f) best_mf[f] = mf[f];
    }
  }

  // Butterfly argmax over the warp: larger margin wins, lower k on ties
  // (lanes without a candidate carry k = -1 and never win).
  T wm = best_m;
  int wk = best_k;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T om = __shfl_xor_sync(0xffffffffu, wm, off);
    const int ok = __shfl_xor_sync(0xffffffffu, wk, off);
    if (ok >= 0 && (wk < 0 || om > wm || (om == wm && ok < wk))) {
      wm = om;
      wk = ok;
    }
  }
  if (wk < 0 || best_k != wk) return;  // the winner's lane finishes
  write_winner<NF, LAYOUT>(row, K, wk, wm, best_mf, rx, ry, rz, nullptr, q,
                           id_role, count_col, eps, ovf_base, n_vars, vroles,
                           out_id, out_aux, out_vals, nullptr, 1, n_vars);
}

// Direct probe: one warp a query, each reading the row of its given
// index; warp i takes query order[i] (order null: query i).
template <int NF, int LAYOUT, typename T>
__global__ void cand_rows_kernel(
    const T* __restrict__ table, int W, const int* __restrict__ idx,
    const T* __restrict__ rq,  // (B, 3): r, or r_local when quantized
    const int* __restrict__ order, int n_queries, int K, int id_role,
    int count_col, T eps, int ovf_base, float qinv, int n_vars,
    const int* __restrict__ vroles, int* __restrict__ out_id,
    int* __restrict__ out_aux, T* __restrict__ out_vals)  // (B, V)
{
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= n_queries) return;  // warp-uniform
  const int q = order != nullptr ? order[w] : w;
  probe_row<NF, LAYOUT>(table + (size_t)idx[q] * W, lane, q, rq[3 * q + 0],
                        rq[3 * q + 1], rq[3 * q + 2], K, id_role, count_col,
                        eps, ovf_base, qinv, n_vars, vroles, out_id, out_aux,
                        out_vals);
}

template <typename T>
int cand_rows(const T* table, int W, const int* idx, const T* rq,
              const int* order, int n_queries, int K, int nf, int layout,
              int id_role, int count_col, T eps, int ovf_base, float qinv,
              int n_vars, const int* vroles, int* out_id, int* out_aux,
              T* out_vals, void* stream) {
  if (n_queries <= 0) return (int)cudaSuccess;
  if (K <= 0 || n_vars < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long threads = (long long)n_queries * 32;
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
#define IU_CAND_LAUNCH(NF_, L_)                                              \
  cand_rows_kernel<NF_, L_, T><<<blocks, kThreads, 0, s>>>(                  \
      table, W, idx, rq, order, n_queries, K, id_role, count_col, eps,       \
      ovf_base, qinv, n_vars, vroles, out_id, out_aux, out_vals)
  if constexpr (sizeof(T) == 4) {
    if (layout == 0 && nf == 3) {
      IU_CAND_LAUNCH(3, 0);
      return (int)cudaGetLastError();
    } else if (layout == 0 && nf == 4) {
      IU_CAND_LAUNCH(4, 0);
      return (int)cudaGetLastError();
    }
  }
  if (layout == 1 && nf == 3) {
    IU_CAND_LAUNCH(3, 1);
  } else if (layout == 1 && nf == 4) {
    IU_CAND_LAUNCH(4, 1);
  } else if (layout == 2 && nf == 4) {
    IU_CAND_LAUNCH(4, 2);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef IU_CAND_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// table: (n_rows, W) extension rows; idx: (B,) int32 row of each query;
// rq: (B, 3) queries (r_local when quantized); order: (B,) int32 the
// queries in the order the warps take them, or null; outputs (B,) int32
// id and aux and (B, n_vars) values at each query's position.
extern "C" int ext_direct(const float* table, int W, const int* idx,
                          const float* rq, const int* order, int n_queries,
                          int K, int nf, int layout, int id_role,
                          int count_col, float eps, int ovf_base, float qinv,
                          int n_vars, const int* vroles, int* out_id,
                          int* out_aux, float* out_vals, void* stream) {
  return cand_rows<float>(table, W, idx, rq, order, n_queries, K, nf, layout,
                          id_role, count_col, eps, ovf_base, qinv, n_vars,
                          vroles, out_id, out_aux, out_vals, stream);
}

extern "C" int ext_direct_f64(const double* table, int W, const int* idx,
                              const double* rq, const int* order,
                              int n_queries, int K, int nf, int layout,
                              int id_role, int count_col, double eps,
                              int ovf_base, float qinv, int n_vars,
                              const int* vroles, int* out_id, int* out_aux,
                              double* out_vals, void* stream) {
  return cand_rows<double>(table, W, idx, rq, order, n_queries, K, nf,
                           layout, id_role, count_col, eps, ovf_base, qinv,
                           n_vars, vroles, out_id, out_aux, out_vals, stream);
}

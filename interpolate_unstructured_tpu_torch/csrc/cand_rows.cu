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
//     compensated float32 (df32.cuh) from a hi/lo r_local (rq, rq_lo);
//     values out as hi (out_vals) and lo (out_vals_lo) pairs
//
// What bounds it on an H100: memory.  One random row of about 1.5 KB
// (K = 24 quantized tets) per query and a few flops per byte, so the
// kernel is built to read each row once and coalesced: one warp per
// query, lanes over the K candidates (looping when K > 32), so each
// role of a row is one contiguous K-float read.  The kernel reads the
// row itself through the query's bin index; the TPU wrapper gathered
// table[idx] into a separate buffer first because Pallas cannot gather
// rows, and at 10M queries that buffer alone would be 15 GB.  The
// argmax is a butterfly of shuffles on (margin, k) pairs with the lower
// k winning ties (jnp.argmax's first occurrence); only the winner's
// lane evaluates the values, from its own margins and its row columns.
//
// Packed int16 words are often NaN bit patterns as floats, so the
// qn/qd roles are read through an int pointer and unpacked with integer
// shifts only.  Plain PyTorch version: ops/cand_kernel.py:probe_rows_plain,
// whose rounding order this kernel follows (built with --fmad=false).

#include <cuda_runtime.h>

#include "df32.cuh"
#include "wkern.cuh"

namespace {

constexpr int kThreads = 256;  // 8 queries per block

__device__ __forceinline__ float lo16(int w) {
  return (float)((int)((unsigned)w << 16) >> 16);
}
__device__ __forceinline__ float hi16(int w) { return (float)(w >> 16); }

template <int NF, int LAYOUT>
__global__ void cand_rows_kernel(
    const float* __restrict__ table, int W, const int* __restrict__ idx,
    const float* __restrict__ rq,  // (B, 3): r, or r_local when quantized
    const float* __restrict__ rq_lo,  // (B, 3) lo of r_local (layout 3)
    int n_queries, int K, int id_role, int count_col, float eps,
    int ovf_base, float qinv, int n_vars, const int* __restrict__ vroles,
    int* __restrict__ out_id, int* __restrict__ out_aux,
    float* __restrict__ out_vals,     // (B, V)
    float* __restrict__ out_vals_lo)  // (B, V), layout 3
{
  constexpr int NPC = NF;
  constexpr int SN = (3 * NF + 1) / 2;  // int16-pair slots of normals
  constexpr bool kQuant = LAYOUT == 0 || LAYOUT == 3;
  const int q = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (q >= n_queries) return;  // warp-uniform

  const float* row = table + (size_t)idx[q] * W;
  const int* rowi = reinterpret_cast<const int*>(row);
  const float rx = rq[3 * q + 0];
  const float ry = rq[3 * q + 1];
  const float rz = rq[3 * q + 2];
  const float ds = kQuant ? row[count_col + 1] : 0.0f;

  float best_m = 0.0f;
  int best_k = -1;
  float best_mf[NF];
  for (int k = lane; k < K; k += 32) {
    float mf[NF];
    float m = 0.0f;
    if constexpr (kQuant) {
      float c[2 * SN];
#pragma unroll
      for (int s = 0; s < SN; ++s) {
        const int w = rowi[s * K + k];
        c[2 * s] = lo16(w);
        c[2 * s + 1] = hi16(w);
      }
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const int w = rowi[(SN + f / 2) * K + k];
        const float dq = (f & 1) ? hi16(w) : lo16(w);
        const float proj =
            ((c[3 * f] * rx + c[3 * f + 1] * ry) + c[3 * f + 2] * rz) * qinv;
        mf[f] = dq * ds - proj;
        m = f == 0 ? mf[f] : (mf[f] < m ? mf[f] : m);
      }
      if (row[id_role * K + k] < 0.0f) m = -1e30f;
    } else {
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const float nx = row[f * K + k];
        const float ny = row[(NF + f) * K + k];
        const float nz = row[(2 * NF + f) * K + k];
        const float d = row[(3 * NF + f) * K + k];
        mf[f] = d - ((nx * rx + ny * ry) + nz * rz);
        m = f == 0 ? mf[f] : (mf[f] < m ? mf[f] : m);
      }
    }
    if (best_k < 0 || m > best_m) {
      best_m = m;
      best_k = k;
#pragma unroll
      for (int f = 0; f < NF; ++f) best_mf[f] = mf[f];
    }
  }

  // Butterfly argmax over the warp: larger margin wins, lower k on ties
  // (lanes without a candidate carry k = -1 and never win).
  float wm = best_m;
  int wk = best_k;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, wm, off);
    const int ok = __shfl_xor_sync(0xffffffffu, wk, off);
    if (ok >= 0 && (wk < 0 || om > wm || (om == wm && ok < wk))) {
      wm = om;
      wk = ok;
    }
  }
  if (wk < 0 || best_k != wk) return;  // the winner's lane finishes

  const int k = wk;
  const int id_best = (int)row[id_role * K + k];
  const int cnt = (int)row[count_col];
  const bool found = (wm >= -eps) && (id_best >= 0);
  const bool ovf_miss = !found && (cnt > ovf_base) && (id_best >= 0);
  out_id[q] = id_best;
  out_aux[q] = found ? -2 : (ovf_miss ? cnt - (ovf_base + 1) : -1);

  float* vals = out_vals + (size_t)q * n_vars;
  if constexpr (LAYOUT == 3) {
    // df32 value planes: the winner's (g hi, g lo, c_loc hi, c_loc lo)
    // roles, acc = c_loc + sum_d g_d * r_local_d in df32
    const iu::df rl[3] = {iu::df_make(rx, rq_lo[3 * q + 0]),
                          iu::df_make(ry, rq_lo[3 * q + 1]),
                          iu::df_make(rz, rq_lo[3 * q + 2])};
    float* vals_lo = out_vals_lo + (size_t)q * n_vars;
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
      float acc = best_mf[1 % NPC] * row[dr * K + k];
#pragma unroll
      for (int v = 1; v < NPC; ++v) {
        acc = acc + best_mf[(v + 1) % NPC] * row[(dr + v) * K + k];
      }
      vals[iv] = acc;
    }
  } else {
    float p[4][3];
#pragma unroll
    for (int v = 0; v < 4; ++v) {
#pragma unroll
      for (int d = 0; d < 3; ++d) p[v][d] = row[(4 * NF + v * 3 + d) * K + k];
    }
    const float qr[3] = {rx, ry, rz};
    float w[4];
    iu::quad_weights(p, qr, 8.0f * 1.1920928955078125e-07f, w);
    for (int iv = 0; iv < n_vars; ++iv) {
      const int dr = vroles[iv];
      float acc = w[0] * row[dr * K + k];
#pragma unroll
      for (int v = 1; v < 4; ++v) acc = acc + w[v] * row[(dr + v) * K + k];
      vals[iv] = acc;
    }
  }
}

template <int NF, int LAYOUT>
void launch(const float* table, int W, const int* idx, const float* rq,
            const float* rq_lo, int n_queries, int K, int id_role,
            int count_col, float eps, int ovf_base, float qinv, int n_vars,
            const int* vroles, int* out_id, int* out_aux, float* out_vals,
            float* out_vals_lo, cudaStream_t s) {
  const long long threads = (long long)n_queries * 32;
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
  cand_rows_kernel<NF, LAYOUT><<<blocks, kThreads, 0, s>>>(
      table, W, idx, rq, rq_lo, n_queries, K, id_role, count_col, eps,
      ovf_base, qinv, n_vars, vroles, out_id, out_aux, out_vals, out_vals_lo);
}

}  // namespace

// Plain C entry point (bound with ctypes).  layout: 0 quantized simplex,
// 1 f32 simplex, 2 quad, 3 accurate-mode df planes; nf 3 or 4.  vroles:
// (n_vars,) device int32, the first role column of each fused variable.
// rq_lo and out_vals_lo are used by layout 3 only (null otherwise).
// Returns the cudaError_t of the launch.
extern "C" int iu_cand_rows(const float* table, int W, const int* idx,
                            const float* rq, const float* rq_lo,
                            int n_queries, int K, int nf, int layout,
                            int id_role, int count_col, float eps,
                            int ovf_base, float qinv, int n_vars,
                            const int* vroles, int* out_id, int* out_aux,
                            float* out_vals, float* out_vals_lo,
                            void* stream) {
  if (n_queries <= 0) return (int)cudaSuccess;
  if (K <= 0 || n_vars < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (layout == 3 && (rq_lo == nullptr || out_vals_lo == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define IU_CAND_LAUNCH(NF_, L_)                                             \
  launch<NF_, L_>(table, W, idx, rq, rq_lo, n_queries, K, id_role, count_col, \
                  eps, ovf_base, qinv, n_vars, vroles, out_id, out_aux,     \
                  out_vals, out_vals_lo, s)
  if (layout == 0 && nf == 3) {
    IU_CAND_LAUNCH(3, 0);
  } else if (layout == 0 && nf == 4) {
    IU_CAND_LAUNCH(4, 0);
  } else if (layout == 1 && nf == 3) {
    IU_CAND_LAUNCH(3, 1);
  } else if (layout == 1 && nf == 4) {
    IU_CAND_LAUNCH(4, 1);
  } else if (layout == 2 && nf == 4) {
    IU_CAND_LAUNCH(4, 2);
  } else if (layout == 3 && nf == 3) {
    IU_CAND_LAUNCH(3, 3);
  } else if (layout == 3 && nf == 4) {
    IU_CAND_LAUNCH(4, 3);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef IU_CAND_LAUNCH
  return (int)cudaGetLastError();
}

// df32 interpolation at known cells: accurate mode's kernel B5.
//
// Replaces the JAX package's Pallas TPU kernel
// interpolate_unstructured_tpu/ops/pallas_acc.py:_kernel (wrapper
// interp_acc_rows).  For each query: its cell's acc-table row (vertex
// coordinates and vertex data of the float64 mesh as hi/lo float32
// pairs), the tri / tet / quad weights in df32 arithmetic
// (m_interp_unstructured.f90:529-551, :553-586, :588-641; the DF trait
// of ops/wkern.py), simplex weights normalized by their df32 sum, and
// the df32 contraction with the requested variables' vertex data.
// Writes (B, V) hi and (B, V) lo values.
//
// What bounds it on an H100: operations.  A query reads 28 bytes (cell
// id, hi/lo position) and the used columns of one 512-byte row (128
// bytes for a tet and one variable), and writes 8 bytes per variable;
// rows of neighbouring queries repeat, so the bytes, each counted once,
// take less time than the arithmetic: ~1,500 float32 instructions for a
// tet query's df32 weights and contraction.  So the design keeps the
// arithmetic to the least that gives the same bits: each df32 product
// takes its exact error from one FMA (df32.cuh two_prod), and the whole
// df32 DAG stays in registers.  One thread per query reads its own row
// through its cell id (the TPU wrapper gathered the rows into a separate
// buffer first, and worked on (3, B) transposes reshaped into (8, T/8)
// sublane tiles; none of that is carried over): the vertex block with
// 16-byte loads, then only the requested slots of the data block, 16
// bytes a slot's hi or lo words for 4-vertex cells.  The slots come by
// value with the launch.  Plain PyTorch version:
// ops/acc_kernel.py:interp_acc_plain, whose rounding order this kernel
// follows (built with --fmad=false; the plain two_prod is Dekker's split
// form, which gives the same bits).

#include <cuda_runtime.h>

#include "df32.cuh"
#include "var_slots.cuh"

namespace {

using iu::df;

__device__ __forceinline__ void cross_df(const df a[3], const df b[3],
                                         df c[3]) {
  c[0] = iu::df_sub(iu::df_mul(a[1], b[2]), iu::df_mul(a[2], b[1]));
  c[1] = iu::df_sub(iu::df_mul(a[2], b[0]), iu::df_mul(a[0], b[2]));
  c[2] = iu::df_sub(iu::df_mul(a[0], b[1]), iu::df_mul(a[1], b[0]));
}

__device__ __forceinline__ df dot3_df(const df a[3], const df b[3]) {
  return iu::df_add(iu::df_add(iu::df_mul(a[0], b[0]), iu::df_mul(a[1], b[1])),
                    iu::df_mul(a[2], b[2]));
}

// Twice the opposite sub-triangle areas (wkern.triangle_areas2).
__device__ __forceinline__ void triangle_areas2_df(const df v[][3],
                                                   const df q[3], df w[3]) {
  const int jj[3] = {1, 2, 0};
  const int kk[3] = {2, 0, 1};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    df e[3], f[3], c[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      e[d] = iu::df_sub(q[d], v[jj[i]][d]);
      f[d] = iu::df_sub(q[d], v[kk[i]][d]);
    }
    cross_df(e, f, c);
    w[i] = iu::df_sqrt(dot3_df(c, c));
  }
}

// Signed scalar triple products (wkern.tetra_triples).
__device__ __forceinline__ void tetra_triples_df(const df v[][3],
                                                 const df q[3], df w[4]) {
  df v1r[3], v2r[3], e13[3], e12[3], e02[3], e03[3], e01[3], c[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    v1r[d] = iu::df_sub(q[d], v[0][d]);
    v2r[d] = iu::df_sub(q[d], v[1][d]);
    e13[d] = iu::df_sub(v[3][d], v[1][d]);
    e12[d] = iu::df_sub(v[2][d], v[1][d]);
    e02[d] = iu::df_sub(v[2][d], v[0][d]);
    e03[d] = iu::df_sub(v[3][d], v[0][d]);
    e01[d] = iu::df_sub(v[1][d], v[0][d]);
  }
  cross_df(e13, e12, c);
  w[0] = dot3_df(v2r, c);
  cross_df(e02, e03, c);
  w[1] = dot3_df(v1r, c);
  cross_df(e03, e01, c);
  w[2] = dot3_df(v1r, c);
  cross_df(e01, e02, c);
  w[3] = dot3_df(v1r, c);
}

__device__ __forceinline__ df cpz_df(const df a[3], const df b[3]) {
  return iu::df_sub(iu::df_mul(a[0], b[1]), iu::df_mul(a[1], b[0]));
}

// Inverse-bilinear quad weights (wkern.quad_weights_generic, DF trait):
// the same root choice, linear fallback, first-occurrence maxloc and
// degenerate guards as the float32 kernels (wkern.cuh).
__device__ __forceinline__ void quad_weights_df(const df v[][3],
                                                const df q[3], df w[4]) {
  const float rel_eps = 8.0f * 3.552713678800501e-15f;  // 8 * 2^-48
  df qv[3], b1[3], b2[3], b3[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    qv[d] = iu::df_sub(q[d], v[0][d]);
    b1[d] = iu::df_sub(v[1][d], v[0][d]);
    b2[d] = iu::df_sub(v[3][d], v[0][d]);
    b3[d] = iu::df_add(iu::df_sub(iu::df_sub(v[0][d], v[1][d]), v[3][d]),
                       v[2][d]);
  }
  const df qa = cpz_df(b2, b3);
  const df qb = iu::df_sub(cpz_df(b3, qv), cpz_df(b1, b2));
  const df qc = cpz_df(b1, qv);
  const df disc =
      iu::df_sub(iu::df_mul(qb, qb), iu::df_scale(iu::df_mul(qa, qc), 4.0f));
  const df disc0 =
      iu::df_val(disc) < 0.0f ? iu::df_make(0.0f, 0.0f) : disc;
  const df root = iu::df_sqrt(disc0);

  const float qb_h = iu::df_val(qb);
  const bool pos = qb_h >= 0.0f;
  const df qq = iu::df_scale(
      iu::df_add(qb, pos ? root : iu::df_neg(root)), -0.5f);
  const bool tiny_qa = fabsf(iu::df_val(qa)) <= rel_eps * fabsf(qb_h);
  const bool linear = pos && tiny_qa;
  const df qa_safe = iu::df_safe_one(tiny_qa, qa);
  const df qb_safe = iu::df_safe_one(!(fabsf(qb_h) > 0.0f), qb);
  const df qq_safe = iu::df_safe_one(iu::df_val(qq) == 0.0f, qq);
  const df mu = linear ? iu::df_div(iu::df_neg(qc), qb_safe)
                       : (pos ? iu::df_div(qq, qa_safe)
                              : iu::df_div(qc, qq_safe));

  df d3[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) d3[d] = iu::df_add(b1[d], iu::df_mul(mu, b3[d]));
  const float a0 = fabsf(iu::df_val(d3[0]));
  const float a1 = fabsf(iu::df_val(d3[1]));
  const float a2 = fabsf(iu::df_val(d3[2]));
  // First-occurrence maxloc over the 3 components (:628-632)
  const bool use0 = a0 >= a1;
  const df d01 = use0 ? d3[0] : d3[1];
  const df q01 = use0 ? qv[0] : qv[1];
  const df b01 = use0 ? b2[0] : b2[1];
  const bool use01 = fmaxf(a0, a1) >= a2;
  df dd = use01 ? d01 : d3[2];
  const df qd = use01 ? q01 : qv[2];
  const df bd = use01 ? b01 : b2[2];
  dd = iu::df_safe_one(iu::df_val(dd) == 0.0f, dd);
  const df lam = iu::df_div(iu::df_sub(qd, iu::df_mul(bd, mu)), dd);

  const df one = iu::df_make(1.0f, 0.0f);
  const df il = iu::df_sub(one, lam);
  const df im = iu::df_sub(one, mu);
  w[0] = iu::df_mul(il, im);
  w[1] = iu::df_mul(lam, im);
  w[2] = iu::df_mul(lam, mu);
  w[3] = iu::df_mul(il, mu);
}

// One slot's npc hi and lo vertex data words of a row.  4-vertex cells
// read them as one float4 each (rows, the data block at 24 floats and
// each slot's words are 16-byte aligned).
template <int NPC>
__device__ __forceinline__ void slot_words(const float* row, int d0, int nv,
                                           int s, float dh[NPC],
                                           float dl[NPC]) {
  const float* h = row + d0 + s * NPC;
  const float* l = row + d0 + (nv + s) * NPC;
  if constexpr (NPC == 4) {
    const float4 h4 = __ldg(reinterpret_cast<const float4*>(h));
    const float4 l4 = __ldg(reinterpret_cast<const float4*>(l));
    dh[0] = h4.x;
    dh[1] = h4.y;
    dh[2] = h4.z;
    dh[3] = h4.w;
    dl[0] = l4.x;
    dl[1] = l4.y;
    dl[2] = l4.z;
    dl[3] = l4.w;
  } else {
#pragma unroll
    for (int k = 0; k < NPC; ++k) {
      dh[k] = __ldg(h + k);
      dl[k] = __ldg(l + k);
    }
  }
}

// CT: 0 triangle, 1 quad, 2 tetra.
template <int CT, int NPC>
__global__ void interp_acc_kernel(
    const float* __restrict__ table, int W,   // (n_cells, W) acc rows
    const int* __restrict__ ic,               // (B,)
    const float* __restrict__ r_hi,           // (B, 3)
    const float* __restrict__ r_lo,           // (B, 3)
    int n_queries, int nv, const __grid_constant__ iu::VarSlots slots,
    float* __restrict__ out_hi,               // (B, out_stride)
    float* __restrict__ out_lo, int out_stride)
{
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= n_queries) return;
  const int c = max(ic[qi], 0);
  const float* row = table + (size_t)c * W;

  // vertex block [vhi npc*3 | vlo npc*3], 16-byte loads (rows are
  // 16-byte aligned; the last load may read padding)
  constexpr int kV4 = (NPC * 6 + 3) / 4;
  float vb[kV4 * 4];
  const float4* row4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int i = 0; i < kV4; ++i) {
    const float4 t = __ldg(row4 + i);
    vb[4 * i + 0] = t.x;
    vb[4 * i + 1] = t.y;
    vb[4 * i + 2] = t.z;
    vb[4 * i + 3] = t.w;
  }
  df v[NPC][3];
#pragma unroll
  for (int k = 0; k < NPC; ++k) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      v[k][d] = iu::df_make(vb[k * 3 + d], vb[NPC * 3 + k * 3 + d]);
    }
  }
  df q[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    q[d] = iu::df_make(r_hi[3 * qi + d], r_lo[3 * qi + d]);
  }

  df w[NPC];
  if constexpr (CT == 0) {
    triangle_areas2_df(v, q, w);
  } else if constexpr (CT == 2) {
    tetra_triples_df(v, q, w);
  } else {
    quad_weights_df(v, q, w);
  }
  if constexpr (CT != 1) {
    df tot = w[0];
#pragma unroll
    for (int k = 1; k < NPC; ++k) tot = iu::df_add(tot, w[k]);
#pragma unroll
    for (int k = 0; k < NPC; ++k) w[k] = iu::df_div(w[k], tot);
  }

  const int d0 = NPC * 6;
  for (int iv = 0; iv < slots.n; ++iv) {
    float dh[NPC], dl[NPC];
    slot_words<NPC>(row, d0, nv, slots.s[iv], dh, dl);
    df acc = iu::df_mul(w[0], iu::df_make(dh[0], dl[0]));
#pragma unroll
    for (int k = 1; k < NPC; ++k) {
      acc = iu::df_add(acc, iu::df_mul(w[k], iu::df_make(dh[k], dl[k])));
    }
    out_hi[(size_t)qi * out_stride + iv] = acc.hi;
    out_lo[(size_t)qi * out_stride + iv] = acc.lo;
  }
}

template <int CT, int NPC>
void launch(const float* table, int W, const int* ic, const float* r_hi,
            const float* r_lo, int n_queries, int nv,
            const iu::VarSlots& slots, float* out_hi, float* out_lo,
            int out_stride, int threads, cudaStream_t s) {
  const int blocks = (n_queries + threads - 1) / threads;
  interp_acc_kernel<CT, NPC><<<blocks, threads, 0, s>>>(
      table, W, ic, r_hi, r_lo, n_queries, nv, slots, out_hi, out_lo,
      out_stride);
}

}  // namespace

// Plain C entry point (bound with ctypes).  cell_type: 0 triangle,
// 1 quad, 2 tetra.  table: (n_cells, W) float32 acc rows, W a multiple of
// 4 and the table 16-byte aligned; slots: host array of n_vars slots in
// [0, nv) (at most iu::kMaxVarSlots); out_hi / out_lo (B, out_stride)
// get columns [0, n_vars); threads: a block's threads.  Returns the
// cudaError_t of the launch.
extern "C" int iu_interp_acc(const float* table, int W, const int* ic,
                             const float* r_hi, const float* r_lo,
                             int n_queries, int cell_type, int nv,
                             const int* slots, int n_vars, float* out_hi,
                             float* out_lo, int out_stride, int threads,
                             void* stream) {
  if (n_queries <= 0) return (int)cudaSuccess;
  if (n_vars < 0 || n_vars > iu::kMaxVarSlots || nv < 0 || (W & 3) ||
      threads < 32 || threads > 1024 || threads % 32) {
    return (int)cudaErrorInvalidValue;
  }
  const iu::VarSlots sl = iu::make_var_slots(slots, n_vars);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cell_type == 0) {
    launch<0, 3>(table, W, ic, r_hi, r_lo, n_queries, nv, sl, out_hi, out_lo,
                 out_stride, threads, s);
  } else if (cell_type == 1) {
    launch<1, 4>(table, W, ic, r_hi, r_lo, n_queries, nv, sl, out_hi, out_lo,
                 out_stride, threads, s);
  } else if (cell_type == 2) {
    launch<2, 4>(table, W, ic, r_hi, r_lo, n_queries, nv, sl, out_hi, out_lo,
                 out_stride, threads, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Interpolation at known cells (kernel E1): interpolate_at_icell on the
// card, for every warm query, every query of a grid without candidate
// tables, every cold value that the candidate rows do not fuse (a float64
// grid's, whose rows hold no variable) and the tracer's start field.
//
// No Pallas counterpart: the JAX package runs this function in XLA,
// interpolate_unstructured_tpu/ops/interp.py:177 interpolate_at_icell
// (iu_interpolate_at_icell, m_interp_unstructured.f90:497-527).  For a
// large batch that function assembled a per-call (n_cells, npc*3 + 1 +
// npc*V) "fast-gather" table padded to 512 bytes and gathered one row a
// query, the TPU's way to read random rows; for a small one it read the
// walk rows and gathered the vertex data through the connectivity.  Both
// give the same values.  Here nothing is built per call: one thread a
// query clamps its cell id to [0, n_cells) (the plain version reads cell
// 0 for a negative id too; for one of n_cells or more it raises, where
// the kernel reads the last cell rather than memory past the tables),
// reads the cell's vertices and volume from the geometry segment of its
// walk row (column nf*5: npc*3 coordinates, then the volume; the same
// values as cell_points and cell_volume, one row instead of two
// tensors), computes the tri / tet / quad weights with the shared device
// functions of wkern.cuh, reads the vertex ids from the connectivity and
// the requested columns of the vertex data, and writes its (V,) values.
//
// What bounds it on an H100: bytes.  Counted once each, a 10M-query
// float32 tet call with one variable reads the queries (120 MB) and the
// cell ids (40 MB), each distinct cell's volume and connectivity (20 B)
// and each distinct vertex's coordinates and value (16 B; the walk rows'
// vertex coordinates are copies of these), and writes 40 MB: ~0.21 GB,
// ~0.063 ms at 3.35 TB/s, against ~90 operations a query.  This first
// design reads each query's cell where the query lies, so neighbouring
// threads read unrelated rows (random 32-byte sectors, the vertex data
// through one more dependent read); reading the cells in a better order
// is a later design's.
//
// Parity: the plain PyTorch version is ops/interp.py:
// interpolate_at_icell_plain, whose rounding order this kernel follows
// (built with --fmad=false, IEEE division and square root): triangle
// weights a2_k * (1 / area) * 0.5 (torch computes 0.5 / area as the
// reciprocal times 0.5), tetra weights t_k * (1 / (6 * volume)), the
// quad weights of wkern.cuh, and the sum w_0 v_0 + w_1 v_1 + ... taken
// left to right.  The float32 tetra formula keeps the reference's
// normalization by the volume, whose weights sum to 1 only within the
// vertex rounding over the cell size (ROADMAP C4): kept for parity.
//
// Templated on the grid's type T (type last), instantiated for float
// (iu_interp_icell) and double (iu_interp_icell_f64).  The requested
// columns come by value with the launch (var_slots.cuh), at most
// kMaxVarSlots a launch; the wrapper launches once a group.

#include <cuda_runtime.h>

#include "var_slots.cuh"
#include "wkern.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
struct IcellArgs {
  const T* geo;       // (C, W) walk rows from column nf*5: row c's (NPC, 3)
  int W;              // vertices at geo + c * W, then its area (2D) or
                      // signed volume (3D)
  const int* cells;   // (C, NPC) vertex ids
  int n_cells;
  const T* point_data;  // (P, pd_stride)
  int pd_stride;
  iu::VarSlots vars;  // point_data columns to interpolate
  const T* r;         // (B, 3)
  const int* ic;      // (B,) cells, clamped to [0, C)
  int n_queries;
  T* vals;            // (B, out_stride), columns [0, vars.n)
  int out_stride;
};

// cell_type CT: 0 triangle, 1 quad, 2 tetra.
template <int NPC, int CT, typename T>
__global__ void __launch_bounds__(kThreads)
    icell_kernel(const __grid_constant__ IcellArgs<T> a) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= a.n_queries) return;
  int c = __ldg(a.ic + q);
  c = c < 0 ? 0 : (c >= a.n_cells ? a.n_cells - 1 : c);
  const T* rq = a.r + 3 * (size_t)q;
  const T qr[3] = {__ldg(rq), __ldg(rq + 1), __ldg(rq + 2)};
  const T* g = a.geo + (size_t)c * a.W;
  T v[NPC][3];
#pragma unroll
  for (int k = 0; k < NPC; ++k) {
#pragma unroll
    for (int d = 0; d < 3; ++d) v[k][d] = __ldg(g + 3 * k + d);
  }
  T w[NPC];
  if constexpr (CT == 0) {
    T a2[3];
    iu::triangle_areas2(v, qr, a2);
    const T inv = (T(1) / __ldg(g + NPC * 3)) * T(0.5);
#pragma unroll
    for (int k = 0; k < 3; ++k) w[k] = a2[k] * inv;
  } else if constexpr (CT == 2) {
    T t[4];
    iu::tetra_triples(v, qr, t);
    const T inv = T(1) / (T(6) * __ldg(g + NPC * 3));
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = t[k] * inv;
  } else {
    iu::quad_weights(v, qr, iu::quad_rel_eps<T>(), w);
  }

  size_t row[NPC];
#pragma unroll
  for (int k = 0; k < NPC; ++k) {
    row[k] = (size_t)__ldg(a.cells + (size_t)c * NPC + k) * a.pd_stride;
  }
  T* out = a.vals + (size_t)q * a.out_stride;
  for (int iv = 0; iv < a.vars.n; ++iv) {
    const T* pd = a.point_data + a.vars.s[iv];
    T acc = w[0] * __ldg(pd + row[0]);
#pragma unroll
    for (int k = 1; k < NPC; ++k) acc = acc + w[k] * __ldg(pd + row[k]);
    out[iv] = acc;
  }
}

template <typename T>
int icell(const T* geo, int W, const int* cells, int n_cells, int cell_type,
          const T* point_data, int pd_stride, const int* slots, int n_vars,
          const T* r, const int* ic, int n_queries, T* vals, int out_stride,
          void* stream) {
  if (n_queries <= 0 || n_vars == 0) return (int)cudaSuccess;
  if (n_cells <= 0 || n_vars < 0 || n_vars > iu::kMaxVarSlots) {
    return (int)cudaErrorInvalidValue;
  }
  IcellArgs<T> a;
  a.geo = geo;
  a.W = W;
  a.cells = cells;
  a.n_cells = n_cells;
  a.point_data = point_data;
  a.pd_stride = pd_stride;
  a.vars = iu::make_var_slots(slots, n_vars);
  a.r = r;
  a.ic = ic;
  a.n_queries = n_queries;
  a.vals = vals;
  a.out_stride = out_stride;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (n_queries + kThreads - 1) / kThreads;
  switch (cell_type) {
    case 0:
      icell_kernel<3, 0, T><<<blocks, kThreads, 0, s>>>(a);
      break;
    case 1:
      icell_kernel<4, 1, T><<<blocks, kThreads, 0, s>>>(a);
      break;
    case 2:
      icell_kernel<4, 2, T><<<blocks, kThreads, 0, s>>>(a);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes): iu_interp_icell for a float32
// grid and queries, iu_interp_icell_f64 for float64 ones.  geo: the walk
// rows from column nf*5 (row 0's first vertex coordinate), W their row
// width in elements; cells: (n_cells, npc) int32; cell_type 0 triangle,
// 1 quad, 2 tetra; point_data (P, pd_stride); slots: host array of
// n_vars point_data columns (at most iu::kMaxVarSlots); r (B, 3); ic
// (B,) int32; vals (B, out_stride) gets columns [0, n_vars).  Returns the
// cudaError_t of the launch.
extern "C" int iu_interp_icell(const float* geo, int W, const int* cells,
                               int n_cells, int cell_type,
                               const float* point_data, int pd_stride,
                               const int* slots, int n_vars, const float* r,
                               const int* ic, int n_queries, float* vals,
                               int out_stride, void* stream) {
  return icell<float>(geo, W, cells, n_cells, cell_type, point_data,
                      pd_stride, slots, n_vars, r, ic, n_queries, vals,
                      out_stride, stream);
}

extern "C" int iu_interp_icell_f64(const double* geo, int W,
                                   const int* cells, int n_cells,
                                   int cell_type, const double* point_data,
                                   int pd_stride, const int* slots,
                                   int n_vars, const double* r,
                                   const int* ic, int n_queries,
                                   double* vals, int out_stride,
                                   void* stream) {
  return icell<double>(geo, W, cells, n_cells, cell_type, point_data,
                       pd_stride, slots, n_vars, r, ic, n_queries, vals,
                       out_stride, stream);
}

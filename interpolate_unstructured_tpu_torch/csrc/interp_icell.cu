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
// walk rows, or on a grid without them cell_points and cell_volume
// (cell_weights), and gathered the vertex data through the connectivity.
// All give the same values.  Here nothing is built per call: for each
// of its queries a thread clamps the cell id to [0, n_cells) (the plain
// version reads cell 0 for a negative id too; for one of n_cells or more
// it raises, where the kernel reads the last cell rather than memory
// past the tables), reads the cell's vertex ids (one 16-byte load for a
// tet or a quad) and its volume (none for a quad, whose weights do not
// use it), then each vertex's coordinates from grid.points and its
// requested columns from grid.point_data, computes the tri / tet / quad
// weights with the shared device functions of wkern.cuh and writes the
// query's (V,) values.
//
// What bounds it on an H100: bytes, read at random.  Counted once each,
// a 10M-query float32 tet call with one variable reads the queries (120
// MB) and the cell ids (40 MB), each distinct cell's volume and
// connectivity (20 B) and each distinct vertex's coordinates and value
// (16 B), and writes 40 MB: ~0.21 GB, ~0.063 ms at 3.35 TB/s, against
// ~90 operations a query.  The queries come in no cell order, so every
// table read is a random 32-byte sector, ~11 a tet query.  The design
// keeps those sectors in the 50 MB L2: the tables it reads (connectivity
// 16 B a tet, volume, points 12 B a vertex, point data) hold ~23 MB for
// the 998,250-tet box in float32 (~30 MB in float64).  The port's first
// E1 read the geometry from the cell's 512-byte walk row (3-4 sectors a
// query out of 511 MB, from device memory).  Measured
// (tools/e1_sweep.py, PERF.md §6): the sectors now come from L2 at about
// its rate, ~5 TB/s, so the kernel gained 6-9% in float32 and 26% in
// float64, not the 2x that the bytes alone promised; reading fewer
// sectors (the 48-byte cell_points rows) wins only where those rows fit
// in L2 beside the rest.  Each query is a chain of three dependent reads
// (cell id, connectivity, vertices); four queries a thread issue four
// chains' reads together, the best of 1, 2 and 4 queries a thread at 128
// and 256 threads a block.
//
// Parity: the plain PyTorch version is ops/interp.py:
// interpolate_at_icell_plain, whose rounding order this kernel follows
// (built with --fmad=false, IEEE division and square root): triangle
// weights a2_k * (1 / area) * 0.5 (torch computes 0.5 / area as the
// reciprocal times 0.5), tetra weights t_k * (1 / (6 * volume)), the
// quad weights of wkern.cuh, and the sum w_0 v_0 + w_1 v_1 + ... taken
// left to right.  Its values equal the plain version's bit for bit
// because grid.points[grid.cells] equals grid.cell_points (and the walk
// rows' copies of it) bit for bit: every route that makes a grid casts
// the float64 points before it gathers them or gathers them before a
// cast, which commutes with the gather (tests/test_torch_icell_geometry.py).
// The float32 tetra formula keeps the reference's normalization by the
// volume, whose weights sum to 1 only within the vertex rounding over the
// cell size (ROADMAP C4): kept for parity.
//
// Templated on the grid's type T (type last), instantiated for float
// (iu_interp_icell) and double (iu_interp_icell_f64).  The requested
// columns come by value with the launch (var_slots.cuh), at most
// kMaxVarSlots a launch; the wrapper launches once a group.

#include <cuda_runtime.h>

#include "var_slots.cuh"
#include "wkern.cuh"

namespace {

constexpr int kThreads = 128;  // threads a block
constexpr int kQueries = 4;    // queries a thread

template <typename T>
struct IcellArgs {
  const T* points;       // (P, 3) vertex coordinates
  const int* cells;      // (C, NPC) vertex ids; 16-byte aligned
  const T* cell_volume;  // (C,) area (2D) or signed volume (3D)
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

// Cell c's NPC vertex ids: one 16-byte load for a tet or a quad row.
template <int NPC>
__device__ __forceinline__ void cell_ids(const int* cells, int c,
                                         int (&id)[NPC]) {
  if constexpr (NPC == 4) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(cells) + c);
    id[0] = v.x;
    id[1] = v.y;
    id[2] = v.z;
    id[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < NPC; ++k) id[k] = __ldg(cells + (size_t)c * NPC + k);
  }
}

// cell_type CT: 0 triangle, 1 quad, 2 tetra.  Q queries a thread, THREADS
// threads a block: thread t of block b takes queries b * THREADS * Q +
// j * THREADS + t, j < Q, and issues each level of their reads together.
template <int NPC, int CT, int Q, int THREADS, typename T>
__global__ void __launch_bounds__(THREADS)
    icell_kernel(const __grid_constant__ IcellArgs<T> a) {
  const int first = blockIdx.x * (THREADS * Q) + threadIdx.x;
  int id[Q][NPC];
  T vol[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    // a thread past the end reads the last query and stores nothing
    const int q = min(first + j * THREADS, a.n_queries - 1);
    int c = __ldg(a.ic + q);
    c = c < 0 ? 0 : (c >= a.n_cells ? a.n_cells - 1 : c);
    cell_ids<NPC>(a.cells, c, id[j]);
    if constexpr (CT != 1) vol[j] = __ldg(a.cell_volume + c);
  }
  T w[Q][NPC];
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    const T* rq = a.r + 3 * (size_t)min(first + j * THREADS, a.n_queries - 1);
    const T qr[3] = {__ldg(rq), __ldg(rq + 1), __ldg(rq + 2)};
    T v[NPC][3];
#pragma unroll
    for (int k = 0; k < NPC; ++k) {
      const T* p = a.points + 3 * (size_t)id[j][k];
#pragma unroll
      for (int d = 0; d < 3; ++d) v[k][d] = __ldg(p + d);
    }
    if constexpr (CT == 0) {
      T a2[3];
      iu::triangle_areas2(v, qr, a2);
      const T inv = (T(1) / vol[j]) * T(0.5);
#pragma unroll
      for (int k = 0; k < 3; ++k) w[j][k] = a2[k] * inv;
    } else if constexpr (CT == 2) {
      T t[4];
      iu::tetra_triples(v, qr, t);
      const T inv = T(1) / (T(6) * vol[j]);
#pragma unroll
      for (int k = 0; k < 4; ++k) w[j][k] = t[k] * inv;
    } else {
      iu::quad_weights(v, qr, iu::quad_rel_eps<T>(), w[j]);
    }
  }
  for (int iv = 0; iv < a.vars.n; ++iv) {
    const T* pd = a.point_data + a.vars.s[iv];
    T x[Q][NPC];
#pragma unroll
    for (int j = 0; j < Q; ++j) {
#pragma unroll
      for (int k = 0; k < NPC; ++k) {
        x[j][k] = __ldg(pd + (size_t)id[j][k] * a.pd_stride);
      }
    }
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      const int q = first + j * THREADS;
      if (q >= a.n_queries) break;
      T acc = w[j][0] * x[j][0];
#pragma unroll
      for (int k = 1; k < NPC; ++k) acc = acc + w[j][k] * x[j][k];
      a.vals[(size_t)q * a.out_stride + iv] = acc;
    }
  }
}

// Launch kernel E1 at Q queries a thread and THREADS threads a block.
template <int Q, int THREADS, typename T>
int icell_launch(const IcellArgs<T>& a, int cell_type, cudaStream_t s) {
  const int blocks = (a.n_queries + THREADS * Q - 1) / (THREADS * Q);
  switch (cell_type) {
    case 0:
      icell_kernel<3, 0, Q, THREADS, T><<<blocks, THREADS, 0, s>>>(a);
      break;
    case 1:
      icell_kernel<4, 1, Q, THREADS, T><<<blocks, THREADS, 0, s>>>(a);
      break;
    case 2:
      icell_kernel<4, 2, Q, THREADS, T><<<blocks, THREADS, 0, s>>>(a);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int icell_args(const T* points, const int* cells, const T* cell_volume,
               int n_cells, const T* point_data, int pd_stride,
               const int* slots, int n_vars, const T* r, const int* ic,
               int n_queries, T* vals, int out_stride, IcellArgs<T>* a) {
  if (n_cells <= 0 || n_vars < 0 || n_vars > iu::kMaxVarSlots ||
      reinterpret_cast<size_t>(cells) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  a->points = points;
  a->cells = cells;
  a->cell_volume = cell_volume;
  a->n_cells = n_cells;
  a->point_data = point_data;
  a->pd_stride = pd_stride;
  a->vars = iu::make_var_slots(slots, n_vars);
  a->r = r;
  a->ic = ic;
  a->n_queries = n_queries;
  a->vals = vals;
  a->out_stride = out_stride;
  return (int)cudaSuccess;
}

template <typename T>
int icell(const T* points, const int* cells, const T* cell_volume,
          int n_cells, int cell_type, const T* point_data, int pd_stride,
          const int* slots, int n_vars, const T* r, const int* ic,
          int n_queries, T* vals, int out_stride, void* stream) {
  if (n_queries <= 0 || n_vars == 0) return (int)cudaSuccess;
  IcellArgs<T> a;
  const int code = icell_args(points, cells, cell_volume, n_cells,
                              point_data, pd_stride, slots, n_vars, r, ic,
                              n_queries, vals, out_stride, &a);
  if (code != (int)cudaSuccess) return code;
  return icell_launch<kQueries, kThreads, T>(
      a, cell_type, static_cast<cudaStream_t>(stream));
}

}  // namespace

// Plain C entry points (bound with ctypes): iu_interp_icell for a float32
// grid and queries, iu_interp_icell_f64 for float64 ones.  points: (P, 3)
// vertex coordinates; cells: (n_cells, npc) int32, its first byte on a
// 16-byte boundary; cell_volume: (n_cells,); cell_type 0 triangle, 1
// quad, 2 tetra; point_data (P, pd_stride); slots: host array of n_vars
// point_data columns (at most iu::kMaxVarSlots); r (B, 3); ic (B,) int32;
// vals (B, out_stride) gets columns [0, n_vars).  Returns the cudaError_t
// of the launch.
extern "C" int iu_interp_icell(const float* points, const int* cells,
                               const float* cell_volume, int n_cells,
                               int cell_type, const float* point_data,
                               int pd_stride, const int* slots, int n_vars,
                               const float* r, const int* ic, int n_queries,
                               float* vals, int out_stride, void* stream) {
  return icell<float>(points, cells, cell_volume, n_cells, cell_type,
                      point_data, pd_stride, slots, n_vars, r, ic, n_queries,
                      vals, out_stride, stream);
}

extern "C" int iu_interp_icell_f64(const double* points, const int* cells,
                                   const double* cell_volume, int n_cells,
                                   int cell_type, const double* point_data,
                                   int pd_stride, const int* slots,
                                   int n_vars, const double* r,
                                   const int* ic, int n_queries,
                                   double* vals, int out_stride,
                                   void* stream) {
  return icell<double>(points, cells, cell_volume, n_cells, cell_type,
                       point_data, pd_stride, slots, n_vars, r, ic,
                       n_queries, vals, out_stride, stream);
}

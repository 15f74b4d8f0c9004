// Brute-force fused locate + interpolate for small meshes (kernel B1).
//
// Replaces the JAX package's Pallas TPU kernel
// interpolate_unstructured_tpu/ops/pallas_interp.py:_kernel (wrapper
// interpolate_bruteforce_pallas).  For each query: the containment
// margin min_f (d_f - n_f . r) against every cell, the first-occurrence
// argmax over cells (the most interior cell), found = max >= -eps, then
// the winner's tri/tet/quad weights (csrc/wkern.cuh) contracted with
// its vertex values.
//
// What bounds it on an H100: operations.  B x C x nf plane evaluations
// (1M queries x 750 tets x 4 faces = 3e9), each 3 products, 2 sums and
// a difference, then the minimum over the faces and the running argmax:
// about 30 float32 instructions per query and cell against a few bytes
// of input and output per query.  Parity forbids fusing them: each
// margin must be the plain version's d - ((nx*rx + ny*ry) + nz*rz),
// rounded step by step, and the cell choice is a first-occurrence argmax
// over those margins, where one ulp moves a near-tie.  For the same
// reason the tensor cores are no use: TF32, even the 3xTF32 split,
// rounds differently from the unfused order, and the ids must be
// torch.equal to the plain version's.  So the design spends its
// instructions on the margins alone:
//
// * several queries a thread (Q, register blocking): each cell's planes
//   are read from shared memory once, as float4 (every thread of a warp
//   reads the same address, a broadcast), and applied to Q queries;
// * no per-cell test for an empty winner: the running best starts at
//   -inf with cell 0, and strict > in ascending cell order keeps the
//   first occurrence (jnp.argmax's and torch.argmax's tie rule);
// * NaN as torch orders it: the minimum over the faces propagates NaN
//   (min.NaN, as amin), the best margin is a NaN-propagating maximum,
//   and a query whose best margin is NaN looks up its first NaN cell
//   after the loop (torch.argmax takes the first NaN);
// * the plane table is staged once per block, from the grid's own
//   face_normals and face_offsets: the whole table (up to
//   bruteforce_max_cells = 1024 tets, 64 KB of dynamic shared memory)
//   when it fits, and the persistent blocks then walk the batch, each
//   thread its own queries (t, t + T, t + 2T, ...; fewer than Q left
//   over go in groups of Q/2, Q/4, ...).  A larger table goes in tiles
//   of 64 KB, the block taking Q queries a thread at a time;
// * only the winner's vertices, volume and vertex values are read from
//   global memory (cell_points, cell_volume, cells, point_data at the
//   requested columns), once per query.  Nothing is built per call.
//
// Plain PyTorch version: ops/interp_kernel.py:interpolate_bruteforce_plain,
// whose rounding order this kernel follows (built with --fmad=false).
//
// The kernels are templates on the grid's type T: float
// (iu_interp_bruteforce) and double (iu_interp_bruteforce_f64), a
// float64 grid, the JAX package's float64 route (its XLA
// _interpolate_bruteforce, ops/interp.py:281-292).  A double plane is
// 32 bytes, so the whole table of bruteforce_max_cells = 1024 tets takes
// 128 KB of the 227 KB a block may have, and the tiles of a larger one
// hold half as many cells.  PTX has no NaN-propagating min and max for
// double: min_nan and max_nan test for NaN themselves.  FP64 runs at
// half the FP32 rate on the H100 (34 TFLOP/s), so the double kernel is
// bound by operations as the float one is.

#include <cuda_runtime.h>

#include "var_slots.cuh"
#include "wkern.cuh"

namespace {

constexpr int kTableBytes = 64 * 1024;  // a block's shared plane tile
constexpr int kMaxThreads = 512;

// One face plane (nx, ny, nz, d) as kept in shared memory: a float4, or
// four doubles in two 16-byte halves.
struct alignas(16) double4a {
  double x, y, z, w;
};
template <typename T>
struct PlaneOf;
template <>
struct PlaneOf<float> {
  using type = float4;
};
template <>
struct PlaneOf<double> {
  using type = double4a;
};
template <typename T>
using Plane = typename PlaneOf<T>::type;

// The largest plane table staged whole: kTableBytes of float planes, and
// as many cells in double planes (bruteforce_max_cells = 1024 tets fit
// either way).
template <typename T>
constexpr int kWholeBytes = kTableBytes / 4 * (int)sizeof(T);

template <typename T>
struct Args {
  const T* normals;          // (C, NPC, 3) outward unit face normals
  const T* offsets;          // (C, NPC) face offsets d
  const T* cell_points;      // (C, NPC, 3)
  const T* volume;           // (C,) area (2D) / signed volume (3D)
  const int* cells;          // (C, NPC) vertex ids
  const T* point_data;       // (P, pd_stride)
  int pd_stride;
  iu::VarSlots vars;         // point_data columns to interpolate
  const T* r;                // (B, 3)
  int n_queries, n_cells;
  T eps;
  T* vals;                   // (B, out_stride), columns [0, vars.n)
  int out_stride;
  int* ic;                   // (B,)
  unsigned char* found;      // (B,)
};

__device__ __forceinline__ float min_nan(float a, float b) {
  float m;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(m) : "f"(a), "f"(b));
  return m;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float m;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(m) : "f"(a), "f"(b));
  return m;
}

// NaN if either is NaN, else the least (greatest) of the two.
__device__ __forceinline__ double min_nan(double a, double b) {
  return (a != a || b != b) ? a + b : fmin(a, b);
}

__device__ __forceinline__ double max_nan(double a, double b) {
  return (a != a || b != b) ? a + b : fmax(a, b);
}

__device__ __forceinline__ float neg_inf(float) {
  return __int_as_float(0xff800000);
}
__device__ __forceinline__ double neg_inf(double) {
  return __longlong_as_double(0xfff0000000000000ULL);
}

template <typename P, typename T>
__device__ __forceinline__ T face_margin(P p, T rx, T ry, T rz) {
  return p.w - ((p.x * rx + p.y * ry) + p.z * rz);
}

template <typename T>
__device__ __forceinline__ Plane<T> plane(const Args<T>& a, size_t face) {
  return Plane<T>{a.normals[3 * face], a.normals[3 * face + 1],
                  a.normals[3 * face + 2], a.offsets[face]};
}

// Planes of cells [c0, c0 + nc) into shared memory, (nx, ny, nz, d).
template <int NPC, typename T>
__device__ __forceinline__ void stage(const Args<T>& a, Plane<T>* sp, int c0,
                                      int nc) {
  for (int i = threadIdx.x; i < nc * NPC; i += blockDim.x) {
    sp[i] = plane(a, (size_t)c0 * NPC + i);
  }
}

// One cell's margin: the minimum over its faces, NaN first (as amin).
template <int NPC, typename P, typename T>
__device__ __forceinline__ T cell_margin(const P* p, T rx, T ry, T rz) {
  T m = face_margin(p[0], rx, ry, rz);
#pragma unroll
  for (int f = 1; f < NPC; ++f) m = min_nan(m, face_margin(p[f], rx, ry, rz));
  return m;
}

// The margins of cells [c0, c0 + nc), planes in sp, for Q queries,
// folded into each query's running best (bm, bi).
template <int NPC, int Q, typename T>
__device__ __forceinline__ void scan(const Plane<T>* __restrict__ sp, int c0,
                                     int nc, const T (&rx)[Q],
                                     const T (&ry)[Q], const T (&rz)[Q],
                                     T (&bm)[Q], int (&bi)[Q]) {
#pragma unroll 2
  for (int c = 0; c < nc; ++c) {
    Plane<T> p[NPC];
#pragma unroll
    for (int f = 0; f < NPC; ++f) p[f] = sp[c * NPC + f];
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      const T m = cell_margin<NPC>(p, rx[j], ry[j], rz[j]);
      // m > best, or a NaN: once the best is NaN the index runs on, and
      // finish() looks up the first NaN cell
      bi[j] = !(m <= bm[j]) ? c0 + c : bi[j];
      bm[j] = max_nan(bm[j], m);
    }
  }
}

template <int NPC, typename T>
__device__ int first_nan_cell(const Args<T>& a, T rx, T ry, T rz) {
  for (int c = 0; c < a.n_cells; ++c) {
    Plane<T> p[NPC];
#pragma unroll
    for (int f = 0; f < NPC; ++f) p[f] = plane(a, (size_t)c * NPC + f);
    const T m = cell_margin<NPC>(p, rx, ry, rz);
    if (m != m) return c;
  }
  return 0;
}

// The verdict and the winner's interpolated values of query q.
// cell_type: 0 triangle, 1 quad, 2 tetra.
template <int NPC, int CT, typename T>
__device__ __noinline__ void finish(const Args<T>& a, int q, T rx, T ry,
                                    T rz, T bm, int best) {
  if (bm != bm) best = first_nan_cell<NPC>(a, rx, ry, rz);
  const bool is_found = bm >= -a.eps;
  const T* g = a.cell_points + (size_t)best * NPC * 3;
  T v[NPC][3];
#pragma unroll
  for (int k = 0; k < NPC; ++k) {
#pragma unroll
    for (int d = 0; d < 3; ++d) v[k][d] = g[3 * k + d];
  }
  const T qr[3] = {rx, ry, rz};
  T w[NPC];
  if constexpr (CT == 0) {
    T a2[3];
    iu::triangle_areas2(v, qr, a2);
    const T inv = T(0.5) / a.volume[best];
#pragma unroll
    for (int k = 0; k < 3; ++k) w[k] = a2[k] * inv;
  } else if constexpr (CT == 2) {
    T t[4];
    iu::tetra_triples(v, qr, t);
    const T inv = T(1) / (T(6) * a.volume[best]);
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = t[k] * inv;
  } else {
    iu::quad_weights(v, qr, iu::quad_rel_eps<T>(), w);
  }

  size_t row[NPC];
#pragma unroll
  for (int k = 0; k < NPC; ++k) {
    row[k] = (size_t)a.cells[(size_t)best * NPC + k] * a.pd_stride;
  }
  T* out = a.vals + (size_t)q * a.out_stride;
  for (int iv = 0; iv < a.vars.n; ++iv) {
    const T* pd = a.point_data + a.vars.s[iv];
    T acc = w[0] * pd[row[0]];
#pragma unroll
    for (int k = 1; k < NPC; ++k) acc = acc + w[k] * pd[row[k]];
    out[iv] = acc;
  }
  a.ic[q] = is_found ? best : -1;
  a.found[q] = is_found ? 1 : 0;
}

// Queries q0, q0 + step, ..., q0 + (Q - 1) * step (all in range) against
// the whole table in sp.
template <int NPC, int CT, int Q, typename T>
__device__ __forceinline__ void run(const Args<T>& a, const Plane<T>* sp,
                                    long long q0, long long step) {
  T rx[Q], ry[Q], rz[Q], bm[Q];
  int bi[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    const T* rq = a.r + 3 * (q0 + j * step);
    rx[j] = rq[0];
    ry[j] = rq[1];
    rz[j] = rq[2];
    bm[j] = neg_inf(T(0));
    bi[j] = 0;
  }
  scan<NPC, Q>(sp, 0, a.n_cells, rx, ry, rz, bm, bi);
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    finish<NPC, CT>(a, (int)(q0 + j * step), rx[j], ry[j], rz[j], bm[j],
                    bi[j]);
  }
}

// The whole plane table in shared memory, staged once; persistent blocks,
// each thread its own queries.
template <int NPC, int CT, int Q, typename T>
__global__ void __launch_bounds__(kMaxThreads)
    whole_table_kernel(const __grid_constant__ Args<T> a) {
  extern __shared__ float4 smem[];
  Plane<T>* sp = reinterpret_cast<Plane<T>*>(smem);
  stage<NPC>(a, sp, 0, a.n_cells);
  __syncthreads();
  const long long n = a.n_queries;
  const long long step = (long long)gridDim.x * blockDim.x;
  long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (; q + (Q - 1) * step < n; q += Q * step) {
    run<NPC, CT, Q>(a, sp, q, step);
  }
  if constexpr (Q >= 8) {
    if (q + 3 * step < n) {
      run<NPC, CT, 4>(a, sp, q, step);
      q += 4 * step;
    }
  }
  if constexpr (Q >= 4) {
    if (q + step < n) {
      run<NPC, CT, 2>(a, sp, q, step);
      q += 2 * step;
    }
  }
  if constexpr (Q >= 2) {
    if (q < n) run<NPC, CT, 1>(a, sp, q, step);
  }
}

template <int NPC, typename T>
constexpr int kTileCells = kTableBytes / (NPC * (int)sizeof(Plane<T>));

// A table larger than kWholeBytes, in tiles of kTableBytes: the block
// takes Q queries a thread at a time and stages every tile for them.
template <int NPC, int CT, int Q, typename T>
__global__ void __launch_bounds__(kMaxThreads)
    tiled_kernel(const __grid_constant__ Args<T> a) {
  extern __shared__ float4 smem[];
  Plane<T>* sp = reinterpret_cast<Plane<T>*>(smem);
  const long long n = a.n_queries;
  const long long step = (long long)gridDim.x * blockDim.x * Q;
  for (long long base = (long long)blockIdx.x * blockDim.x * Q; base < n;
       base += step) {
    T rx[Q], ry[Q], rz[Q], bm[Q];
    int bi[Q];
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      const long long q = base + (long long)j * blockDim.x + threadIdx.x;
      const T* rq = a.r + 3 * (q < n ? q : 0);
      rx[j] = rq[0];
      ry[j] = rq[1];
      rz[j] = rq[2];
      bm[j] = neg_inf(T(0));
      bi[j] = 0;
    }
    for (int c0 = 0; c0 < a.n_cells; c0 += kTileCells<NPC, T>) {
      const int nc = min(kTileCells<NPC, T>, a.n_cells - c0);
      __syncthreads();
      stage<NPC>(a, sp, c0, nc);
      __syncthreads();
      scan<NPC, Q>(sp, c0, nc, rx, ry, rz, bm, bi);
    }
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      const long long q = base + (long long)j * blockDim.x + threadIdx.x;
      if (q < n) {
        finish<NPC, CT>(a, (int)q, rx[j], ry[j], rz[j], bm[j], bi[j]);
      }
    }
  }
}

template <int NPC, int CT, int Q, typename T>
int launch(const Args<T>& a, int threads, cudaStream_t stream) {
  constexpr int kPlaneBytes = NPC * (int)sizeof(Plane<T>);
  const bool whole = (long long)a.n_cells * kPlaneBytes <= kWholeBytes<T>;
  const int smem = (whole ? a.n_cells : kTileCells<NPC, T>) * kPlaneBytes;
  void (*kern)(Args<T>) = tiled_kernel<NPC, CT, Q, T>;
  if (whole) kern = whole_table_kernel<NPC, CT, Q, T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, n_sm = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                      smem);
  }
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long per_block = (long long)threads * (whole ? 1 : Q);
  const long long want = (a.n_queries + per_block - 1) / per_block;
  const long long resident = (long long)per_sm * n_sm;
  const int blocks = (int)(want < resident ? want : resident);
  kern<<<blocks, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int NPC, int CT, typename T>
int launch_q(const Args<T>& a, int q, int threads, cudaStream_t stream) {
  switch (q) {
    case 1:
      return launch<NPC, CT, 1>(a, threads, stream);
    case 2:
      return launch<NPC, CT, 2>(a, threads, stream);
    case 4:
      return launch<NPC, CT, 4>(a, threads, stream);
    case 8:
      return launch<NPC, CT, 8>(a, threads, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int bruteforce(const T* normals, const T* offsets, const T* cell_points,
               const T* volume, const int* cells, const T* point_data,
               int pd_stride, const int* slots, int n_vars, const T* r,
               int n_queries, int n_cells, int cell_type, T eps, T* vals,
               int out_stride, int* ic, unsigned char* found, int q,
               int threads, void* stream) {
  if (n_queries <= 0) return (int)cudaSuccess;
  if (n_cells <= 0 || n_vars < 0 || n_vars > iu::kMaxVarSlots ||
      threads < 32 || threads > kMaxThreads || threads % 32) {
    return (int)cudaErrorInvalidValue;
  }
  Args<T> a;
  a.normals = normals;
  a.offsets = offsets;
  a.cell_points = cell_points;
  a.volume = volume;
  a.cells = cells;
  a.point_data = point_data;
  a.pd_stride = pd_stride;
  a.vars = iu::make_var_slots(slots, n_vars);
  a.r = r;
  a.n_queries = n_queries;
  a.n_cells = n_cells;
  a.eps = eps;
  a.vals = vals;
  a.out_stride = out_stride;
  a.ic = ic;
  a.found = found;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cell_type) {
    case 0:
      return launch_q<3, 0>(a, q, threads, s);
    case 1:
      return launch_q<4, 1>(a, q, threads, s);
    case 2:
      return launch_q<4, 2>(a, q, threads, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry points (bound with ctypes): iu_interp_bruteforce for a
// float32 grid and queries, iu_interp_bruteforce_f64 for float64 ones
// (eps in double).  cell_type 0 triangle, 1 quad, 2 tetra; slots: host
// array of n_vars point_data columns (at most iu::kMaxVarSlots); vals
// (B, out_stride) gets columns [0, n_vars).  q: queries a thread (1, 2,
// 4 or 8); threads: a block's threads (a multiple of 32, at most 512).
// Returns the cudaError_t of the launch.
extern "C" int iu_interp_bruteforce(
    const float* normals, const float* offsets, const float* cell_points,
    const float* volume, const int* cells, const float* point_data,
    int pd_stride, const int* slots, int n_vars, const float* r,
    int n_queries, int n_cells, int cell_type, float eps, float* vals,
    int out_stride, int* ic, unsigned char* found, int q, int threads,
    void* stream) {
  return bruteforce<float>(normals, offsets, cell_points, volume, cells,
                           point_data, pd_stride, slots, n_vars, r, n_queries,
                           n_cells, cell_type, eps, vals, out_stride, ic,
                           found, q, threads, stream);
}

extern "C" int iu_interp_bruteforce_f64(
    const double* normals, const double* offsets, const double* cell_points,
    const double* volume, const int* cells, const double* point_data,
    int pd_stride, const int* slots, int n_vars, const double* r,
    int n_queries, int n_cells, int cell_type, double eps, double* vals,
    int out_stride, int* ic, unsigned char* found, int q, int threads,
    void* stream) {
  return bruteforce<double>(normals, offsets, cell_points, volume, cells,
                            point_data, pd_stride, slots, n_vars, r,
                            n_queries, n_cells, cell_type, eps, vals,
                            out_stride, ic, found, q, threads, stream);
}

extern "C" const char* iu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

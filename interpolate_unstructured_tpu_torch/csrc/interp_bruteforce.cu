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

#include <cuda_runtime.h>

#include "var_slots.cuh"
#include "wkern.cuh"

namespace {

constexpr int kTableBytes = 64 * 1024;  // a block's shared plane table
constexpr int kMaxThreads = 512;

struct Args {
  const float* normals;      // (C, NPC, 3) outward unit face normals
  const float* offsets;      // (C, NPC) face offsets d
  const float* cell_points;  // (C, NPC, 3)
  const float* volume;       // (C,) area (2D) / signed volume (3D)
  const int* cells;          // (C, NPC) vertex ids
  const float* point_data;   // (P, pd_stride)
  int pd_stride;
  iu::VarSlots vars;         // point_data columns to interpolate
  const float* r;            // (B, 3)
  int n_queries, n_cells;
  float eps;
  float* vals;               // (B, out_stride), columns [0, vars.n)
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

__device__ __forceinline__ float face_margin(float4 p, float rx, float ry,
                                             float rz) {
  return p.w - ((p.x * rx + p.y * ry) + p.z * rz);
}

__device__ __forceinline__ float4 plane(const Args& a, size_t face) {
  return make_float4(a.normals[3 * face], a.normals[3 * face + 1],
                     a.normals[3 * face + 2], a.offsets[face]);
}

// Planes of cells [c0, c0 + nc) into shared memory, (nx, ny, nz, d).
template <int NPC>
__device__ __forceinline__ void stage(const Args& a, float4* sp, int c0,
                                      int nc) {
  for (int i = threadIdx.x; i < nc * NPC; i += blockDim.x) {
    sp[i] = plane(a, (size_t)c0 * NPC + i);
  }
}

// One cell's margin: the minimum over its faces, NaN first (as amin).
template <int NPC>
__device__ __forceinline__ float cell_margin(const float4* p, float rx,
                                             float ry, float rz) {
  float m = face_margin(p[0], rx, ry, rz);
#pragma unroll
  for (int f = 1; f < NPC; ++f) m = min_nan(m, face_margin(p[f], rx, ry, rz));
  return m;
}

// The margins of cells [c0, c0 + nc), planes in sp, for Q queries,
// folded into each query's running best (bm, bi).
template <int NPC, int Q>
__device__ __forceinline__ void scan(const float4* __restrict__ sp, int c0,
                                     int nc, const float (&rx)[Q],
                                     const float (&ry)[Q],
                                     const float (&rz)[Q], float (&bm)[Q],
                                     int (&bi)[Q]) {
#pragma unroll 2
  for (int c = 0; c < nc; ++c) {
    float4 p[NPC];
#pragma unroll
    for (int f = 0; f < NPC; ++f) p[f] = sp[c * NPC + f];
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      const float m = cell_margin<NPC>(p, rx[j], ry[j], rz[j]);
      // m > best, or a NaN: once the best is NaN the index runs on, and
      // finish() looks up the first NaN cell
      bi[j] = !(m <= bm[j]) ? c0 + c : bi[j];
      bm[j] = max_nan(bm[j], m);
    }
  }
}

template <int NPC>
__device__ int first_nan_cell(const Args& a, float rx, float ry, float rz) {
  for (int c = 0; c < a.n_cells; ++c) {
    float4 p[NPC];
#pragma unroll
    for (int f = 0; f < NPC; ++f) p[f] = plane(a, (size_t)c * NPC + f);
    const float m = cell_margin<NPC>(p, rx, ry, rz);
    if (m != m) return c;
  }
  return 0;
}

// The verdict and the winner's interpolated values of query q.
// cell_type: 0 triangle, 1 quad, 2 tetra.
template <int NPC, int CT>
__device__ __noinline__ void finish(const Args& a, int q, float rx, float ry,
                                    float rz, float bm, int best) {
  if (bm != bm) best = first_nan_cell<NPC>(a, rx, ry, rz);
  const bool is_found = bm >= -a.eps;
  const float* g = a.cell_points + (size_t)best * NPC * 3;
  float v[NPC][3];
#pragma unroll
  for (int k = 0; k < NPC; ++k) {
#pragma unroll
    for (int d = 0; d < 3; ++d) v[k][d] = g[3 * k + d];
  }
  const float qr[3] = {rx, ry, rz};
  float w[NPC];
  if constexpr (CT == 0) {
    float a2[3];
    iu::triangle_areas2(v, qr, a2);
    const float inv = 0.5f / a.volume[best];
#pragma unroll
    for (int k = 0; k < 3; ++k) w[k] = a2[k] * inv;
  } else if constexpr (CT == 2) {
    float t[4];
    iu::tetra_triples(v, qr, t);
    const float inv = 1.0f / (6.0f * a.volume[best]);
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = t[k] * inv;
  } else {
    iu::quad_weights(v, qr, 8.0f * 1.1920928955078125e-07f, w);
  }

  size_t row[NPC];
#pragma unroll
  for (int k = 0; k < NPC; ++k) {
    row[k] = (size_t)a.cells[(size_t)best * NPC + k] * a.pd_stride;
  }
  float* out = a.vals + (size_t)q * a.out_stride;
  for (int iv = 0; iv < a.vars.n; ++iv) {
    const float* pd = a.point_data + a.vars.s[iv];
    float acc = w[0] * pd[row[0]];
#pragma unroll
    for (int k = 1; k < NPC; ++k) acc = acc + w[k] * pd[row[k]];
    out[iv] = acc;
  }
  a.ic[q] = is_found ? best : -1;
  a.found[q] = is_found ? 1 : 0;
}

// Queries q0, q0 + step, ..., q0 + (Q - 1) * step (all in range) against
// the whole table in sp.
template <int NPC, int CT, int Q>
__device__ __forceinline__ void run(const Args& a, const float4* sp,
                                    long long q0, long long step) {
  float rx[Q], ry[Q], rz[Q], bm[Q];
  int bi[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    const float* rq = a.r + 3 * (q0 + j * step);
    rx[j] = rq[0];
    ry[j] = rq[1];
    rz[j] = rq[2];
    bm[j] = __int_as_float(0xff800000);  // -inf
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
template <int NPC, int CT, int Q>
__global__ void __launch_bounds__(kMaxThreads)
    whole_table_kernel(const __grid_constant__ Args a) {
  extern __shared__ float4 sp[];
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

template <int NPC>
constexpr int kTileCells = kTableBytes / (NPC * 16);

// A table larger than kTableBytes, in tiles: the block takes Q queries a
// thread at a time and stages every tile for them.
template <int NPC, int CT, int Q>
__global__ void __launch_bounds__(kMaxThreads)
    tiled_kernel(const __grid_constant__ Args a) {
  extern __shared__ float4 sp[];
  const long long n = a.n_queries;
  const long long step = (long long)gridDim.x * blockDim.x * Q;
  for (long long base = (long long)blockIdx.x * blockDim.x * Q; base < n;
       base += step) {
    float rx[Q], ry[Q], rz[Q], bm[Q];
    int bi[Q];
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      const long long q = base + (long long)j * blockDim.x + threadIdx.x;
      const float* rq = a.r + 3 * (q < n ? q : 0);
      rx[j] = rq[0];
      ry[j] = rq[1];
      rz[j] = rq[2];
      bm[j] = __int_as_float(0xff800000);  // -inf
      bi[j] = 0;
    }
    for (int c0 = 0; c0 < a.n_cells; c0 += kTileCells<NPC>) {
      const int nc = min(kTileCells<NPC>, a.n_cells - c0);
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

template <int NPC, int CT, int Q>
int launch(const Args& a, int threads, cudaStream_t stream) {
  const bool whole = a.n_cells <= kTileCells<NPC>;
  const int smem = (whole ? a.n_cells : kTileCells<NPC>) * NPC * 16;
  void (*kern)(Args) = tiled_kernel<NPC, CT, Q>;
  if (whole) kern = whole_table_kernel<NPC, CT, Q>;
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

template <int NPC, int CT>
int launch_q(const Args& a, int q, int threads, cudaStream_t stream) {
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

}  // namespace

// Plain C entry point (bound with ctypes).  cell_type 0 triangle, 1
// quad, 2 tetra; slots: host array of n_vars point_data columns (at most
// iu::kMaxVarSlots); vals (B, out_stride) gets columns [0, n_vars).
// q: queries a thread (1, 2, 4 or 8); threads: a block's threads (a
// multiple of 32, at most 512).  Returns the cudaError_t of the launch.
extern "C" int iu_interp_bruteforce(
    const float* normals, const float* offsets, const float* cell_points,
    const float* volume, const int* cells, const float* point_data,
    int pd_stride, const int* slots, int n_vars, const float* r,
    int n_queries, int n_cells, int cell_type, float eps, float* vals,
    int out_stride, int* ic, unsigned char* found, int q, int threads,
    void* stream) {
  if (n_queries <= 0) return (int)cudaSuccess;
  if (n_cells <= 0 || n_vars < 0 || n_vars > iu::kMaxVarSlots ||
      threads < 32 || threads > kMaxThreads || threads % 32) {
    return (int)cudaErrorInvalidValue;
  }
  Args a;
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

extern "C" const char* iu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The batched neighbor walk (kernel B3): every query walks from r0 inside
// cell ic0 towards r1 until it arrives, leaves the domain or hits the
// step cap (iu_get_cell_through_neighbors + get_cell_intersection,
// m_interp_unstructured.f90:664-764).
//
// Replaces the JAX package's Pallas TPU kernel
// interpolate_unstructured_tpu/ops/pallas_walk.py:_kernel (wrapper
// walk_round, core _face_round), which ran ONE round for a tile of lanes
// on rows that XLA had gathered into a (B, 128) buffer; ops/locate.py's
// _walk_pallas looped it in a lax.while_loop until no lane was active.
// Each lane of that loop is independent, and an active lane steps in
// every round until it stops, so one query walking up to max_steps
// rounds to its end gives exactly the loop's per-lane result.  Here the
// state stays in registers for the whole walk, the host-side
// any(active) test per round disappears, and each query reads the NF*5
// leading elements of its current cell's row itself: there is no gather
// buffer.
//
// walk_kernel is the explicit walk (walk_rows: the public walk(), masked
// walks, the tracer's generic path), one thread a walk.  It takes r0, r1
// and ic0 and computes each walk's unit direction, length and whether it
// moves in the kernel, in the rounding of ops/walk_kernel.py:
// walk_direction (sqrtf of (x*x + y*y) + z*z, a degenerate walk divides
// by 1, IEEE division), where the first design read u, total and active
// from tensors that about six torch launches had written; each round
// reads the row's NF*5 leading elements with 16-byte loads (5 for tets,
// 4 for triangles; double2 in double: the wrapper checks that W is a
// whole number of 16-byte words and the table 16-byte aligned), then runs
// iu::walk_round_row (walk.cuh).  The block size is the
// wrapper's, by batch size (ops/walk_kernel.py:walk_threads): at the
// generic trace's 1024 walks a launch is one chain of dependent rounds
// per walk, so blocks of 32 spread the walks over 32 SMs; at 65,536 and
// more the block size hardly matters.  Four lanes a walk, each lane one
// face's distance and the round's best two faces merged by shuffles,
// lost to one thread a walk at every size from 1024 to 10M walks
// (tools/walk_rows_alternatives.cu, tools/walk_rows_sweep.py; PERF.md
// §6).
//
// What bounds it on an H100: memory latency.  Each round is one
// dependent read of 80 bytes (tets) from a random row of the 512-byte
// walk table, then ~60 flops; the next row's address depends on the
// result.  Bytes moved are about 80 B per step plus 60 B of per-query
// state in and out.
//
// Plain PyTorch version: ops/walk_kernel.py:walk_direction followed by
// walk_plain, whose rounding order this kernel follows (built with
// --fmad=false).
//
// get_cell_walk_kernel below is get_cell's whole walk stage, from "start
// cell known" to (ic, found), in one launch.  Per query, in registers:
// the origin (the seed bin's bin_pack
// row, or the start cell's center from the vertex block of its walk
// row), direction and distance as walk_direction computes them,
// phase 1 of p1 rounds,
// then for a query still walking the restart of the JAX package's
// _resume_walk (direction and distance from r_p, no previous cell) for
// at most max_steps - p1 more rounds, and get_cell's found rule.  The
// TPU needed the two phases to compact stragglers between while_loop
// rounds; here they stay only because the restart changes the rounding,
// and the port must agree with the JAX package.  5 bytes go out per
// query (ic, found), where the earlier composition moved 57 bytes of
// walk state in and out of an explicit walk and more through the torch
// around it.  While the port traces (utils/timing.py) the launch takes a
// step counter: each warp sums its walks' steps by shuffles and adds the
// sum with one atomic; with a null counter that is skipped, and the
// outputs are the same either way.
//
// What bounds it on an H100: the latency of dependent row reads, as for
// walk_kernel.  Each round reads the leading NF*5 floats of its row
// with 16-byte loads (5 for tets, 4 for triangles: the wrapper checks
// that W is a multiple of 4 and the table 16-byte aligned), and many
// resident threads hide the latency.  -Xptxas -v for sm_90a (the report
// ops/_kernels.py keeps beside the library): 44 registers for NF = 4
// and 40 for NF = 3, no spills, so 5 and 6 blocks of 256 threads, 1280
// and 1536 of an SM's 2048 threads, are resident.  Plain PyTorch
// version: ops/walk_kernel.py:get_cell_walk_plain.
//
// The kernels are templates on the rows' type T, instantiated for float
// (iu_walk, iu_get_cell_walk) and for double, a float64 grid's rows
// (iu_walk_f64, iu_get_cell_walk_f64), the JAX package's float64 route
// (its XLA walk loop, ops/locate.py:146-327).  A float64 walk row is 64
// doubles, the same 512 bytes, read with 16-byte loads as double2; the
// seed bin_pack row is 4 doubles; the tolerances come in as doubles.
// On the H100 FP64 runs at half the FP32 rate (34 TFLOP/s), and a round
// reads twice the bytes, still one dependent row read a round, so the
// double walk is bound by the same latency.

#include <cuda_runtime.h>

#include <cstdint>

#include "bins.cuh"
#include "walk.cuh"
#include "wkern.cuh"

namespace {

constexpr int kGetCellThreads = 256;

// Unit direction and length of the walk from p to r (degenerate walks,
// shorter than tiny, stay put), in walk_direction's rounding order.
template <typename T>
__device__ __forceinline__ void walk_direction(T px, T py, T pz, T rx, T ry,
                                               T rz, T tiny, T& ux, T& uy,
                                               T& uz, iu::WalkState<T>& s) {
  const T dx = rx - px, dy = ry - py, dz = rz - pz;
  const T total = iu::sqrt_t((dx * dx + dy * dy) + dz * dz);
  const bool degenerate = total < tiny;
  const T d = degenerate ? T(1) : total;
  ux = dx / d;
  uy = dy / d;
  uz = dz / d;
  s.px = px;
  s.py = py;
  s.pz = pz;
  s.dist_left = total;
  s.prev = -1;
  s.status = iu::kStatusArrived;
  s.active = !degenerate;
}

// One 16-byte load: 4 floats or 2 doubles.
__device__ __forceinline__ void load16(const float* __restrict__ p,
                                       float* out) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

__device__ __forceinline__ void load16(const double* __restrict__ p,
                                       double* out) {
  const double2 v = __ldg(reinterpret_cast<const double2*>(p));
  out[0] = v.x;
  out[1] = v.y;
}

// Elements of T in one 16-byte load.
template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);

// Columns [kVec * C0, kVec * C1) of a 16-byte aligned row, as 16-byte
// loads.
template <int C0, int C1, typename T>
__device__ __forceinline__ void load_cols(const T* __restrict__ row,
                                          T (&out)[kVec<T> * (C1 - C0)]) {
#pragma unroll
  for (int c = C0; c < C1; ++c) {
    load16(row + kVec<T> * c, out + kVec<T> * (c - C0));
  }
}

template <int NF, typename T>
__device__ __forceinline__ void walk_rounds(const T* __restrict__ table,
                                            int n_rows, int W, int n_max,
                                            T ux, T uy, T uz, T nudge,
                                            T eps_arrive, T big,
                                            iu::WalkState<T>& s) {
  constexpr int L = kVec<T>;
  constexpr int kChunks = (NF * 5 + L - 1) / L;
  for (int n = 0; n < n_max && s.active; ++n) {
    T g[L * kChunks];
    load_cols<0, kChunks>(table + (size_t)iu::clamp_row(s.ic, n_rows) * W, g);
    iu::walk_round_row<NF>(g, ux, uy, uz, nudge, eps_arrive, big, nullptr, 0,
                           s);
  }
}

// A seed bin's packed row (seed id as T | seed center xyz), 16-byte
// aligned.
__device__ __forceinline__ void seed_row(const float* __restrict__ pack,
                                         int b, float (&g)[4]) {
  load16(pack + 4 * (size_t)b, g);
}

__device__ __forceinline__ void seed_row(const double* __restrict__ pack,
                                         int b, double (&g)[4]) {
  load16(pack + 4 * (size_t)b, g);
  load16(pack + 4 * (size_t)b + 2, g + 2);
}

// get_cell's walk of query q, written to out_ic[q] and out_found[q];
// returns the steps it took over both phases.
template <int NF, typename T>
__device__ __forceinline__ int get_cell_walk_query(
    const T* __restrict__ table, int n_rows, int W, const T* __restrict__ r,
    const int* __restrict__ start, const T* __restrict__ bin_pack,
    const int* __restrict__ bin_table, const iu::BinGrid<T>& bins, T nudge,
    T eps_arrive, T big, T tiny, int max_steps, int p1, int q,
    int* __restrict__ out_ic, unsigned char* __restrict__ out_found) {
  constexpr int NPC = NF;  // triangles, quads and tets
  constexpr int L = kVec<T>;
  constexpr int V0 = NF * 5;  // vertex block [V0, V0 + NPC * 3)
  constexpr int C0 = V0 / L, C1 = (V0 + NPC * 3 + L - 1) / L;
  const T rx = r[3 * q + 0];
  const T ry = r[3 * q + 1];
  const T rz = r[3 * q + 2];

  int ic0 = start != nullptr ? start[q] : -1;
  T ox = T(0), oy = T(0), oz = T(0);
  if (start == nullptr ||
      (bin_table != nullptr && (ic0 < 0 || ic0 >= n_rows))) {
    int i, j, k;
    iu::bin_ijk(bins, rx, ry, rz, i, j, k);
    const int b = iu::bin_flat(bins, i, j, k);
    if (start == nullptr) {
      // pure cold start: seed id and origin from one packed row
      T g[4];
      seed_row(bin_pack, b, g);
      ic0 = (int)g[0];
      ox = g[1];
      oy = g[2];
      oz = g[3];
    } else {
      ic0 = bin_table[b];  // an out-of-range guess reseeds cold
    }
  }
  if (start != nullptr) {
    // the start cell's center, summed in vertex order
    T v[L * (C1 - C0)];
    load_cols<C0, C1>(table + (size_t)iu::clamp_row(ic0, n_rows) * W, v);
    constexpr int o = V0 - L * C0;
    ox = v[o + 0];
    oy = v[o + 1];
    oz = v[o + 2];
#pragma unroll
    for (int k = 1; k < NPC; ++k) {
      ox = ox + v[o + 3 * k + 0];
      oy = oy + v[o + 3 * k + 1];
      oz = oz + v[o + 3 * k + 2];
    }
    ox = ox / (T)NPC;
    oy = oy / (T)NPC;
    oz = oz / (T)NPC;
  }

  iu::WalkState<T> s;
  T ux, uy, uz;
  walk_direction(ox, oy, oz, rx, ry, rz, tiny, ux, uy, uz, s);
  s.ic = ic0;
  s.steps = 0;
  walk_rounds<NF>(table, n_rows, W, p1 > 0 ? p1 : max_steps, ux, uy, uz,
                  nudge, eps_arrive, big, s);
  if (p1 > 0 && s.active) {
    // phase 2: a fresh walk from where phase 1 stopped
    walk_direction(s.px, s.py, s.pz, rx, ry, rz, tiny, ux, uy, uz, s);
    walk_rounds<NF>(table, n_rows, W, max_steps - p1, ux, uy, uz, nudge,
                    eps_arrive, big, s);
  }
  const bool found = !s.active && s.status == iu::kStatusArrived && s.ic >= 0;
  out_ic[q] = found ? s.ic : (s.ic < -1 ? s.ic : -1);
  out_found[q] = found ? 1 : 0;
  return s.steps;
}

// step_count: null, or a device counter that gets the steps of every
// walk, summed over each warp and added once a warp (blocks are whole
// warps, and every lane reaches the sum).
template <int NF, typename T>
__global__ void __launch_bounds__(kGetCellThreads)
get_cell_walk_kernel(const T* __restrict__ table, int n_rows, int W,
                     const T* __restrict__ r,
                     const int* __restrict__ start,
                     const T* __restrict__ bin_pack,
                     const int* __restrict__ bin_table,
                     iu::BinGrid<T> bins, int n_queries, T nudge,
                     T eps_arrive, T big, T tiny, int max_steps, int p1,
                     int* __restrict__ out_ic,
                     unsigned char* __restrict__ out_found,
                     unsigned long long* __restrict__ step_count) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  const int steps =
      q < n_queries
          ? get_cell_walk_query<NF>(table, n_rows, W, r, start, bin_pack,
                                    bin_table, bins, nudge, eps_arrive, big,
                                    tiny, max_steps, p1, q, out_ic, out_found)
          : 0;
  if (step_count != nullptr) {
    unsigned long long sum = (unsigned long long)steps;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sum += __shfl_down_sync(0xffffffffu, sum, o);
    }
    if ((threadIdx.x & 31) == 0 && sum != 0) atomicAdd(step_count, sum);
  }
}

// Writes a finished walk's results at position q.
template <typename T>
__device__ __forceinline__ void walk_out(const iu::WalkState<T>& s, int q,
                                         int* __restrict__ out_ic,
                                         T* __restrict__ out_rp,
                                         int* __restrict__ out_steps,
                                         int* __restrict__ out_status) {
  out_ic[q] = s.ic;
  out_rp[3 * q + 0] = s.px;
  out_rp[3 * q + 1] = s.py;
  out_rp[3 * q + 2] = s.pz;
  out_steps[q] = s.steps;
  out_status[q] = s.active ? iu::kStatusStepCap : s.status;
}

// The explicit walk, one thread a walk: direction from (r0, r1), rows
// read with 16-byte loads.
template <int NF, typename T>
__global__ void walk_kernel(const T* __restrict__ table, int n_rows, int W,
                            const T* __restrict__ r0,
                            const T* __restrict__ r1,
                            const int* __restrict__ ic0,
                            const int* __restrict__ mask, int n_queries,
                            T nudge, T eps_arrive, T big, T tiny,
                            int max_steps, int* __restrict__ out_ic,
                            T* __restrict__ out_rp,
                            int* __restrict__ out_steps,
                            int* __restrict__ out_status) {
  constexpr int L = kVec<T>;
  constexpr int kChunks = (NF * 5 + L - 1) / L;
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n_queries) return;
  iu::WalkState<T> s;
  T ux, uy, uz;
  walk_direction(r0[3 * q + 0], r0[3 * q + 1], r0[3 * q + 2], r1[3 * q + 0],
                 r1[3 * q + 1], r1[3 * q + 2], tiny, ux, uy, uz, s);
  s.ic = ic0[q];
  s.steps = 0;
  const int mask0 = mask != nullptr ? mask[iu::clamp_row(s.ic, n_rows)] : 0;
  for (int n = 0; n < max_steps && s.active; ++n) {
    T g[L * kChunks];
    load_cols<0, kChunks>(table + (size_t)iu::clamp_row(s.ic, n_rows) * W, g);
    iu::walk_round_row<NF>(g, ux, uy, uz, nudge, eps_arrive, big, mask,
                           mask0, s);
  }
  walk_out(s, q, out_ic, out_rp, out_steps, out_status);
}

template <typename T>
int walk_launch(const T* table, int n_rows, int W, int nf, const T* r0,
                const T* r1, const int* ic0, const int* mask, int n_queries,
                T nudge, T eps_arrive, T big, T tiny, int max_steps,
                int threads, int* out_ic, T* out_rp, int* out_steps,
                int* out_status, void* stream) {
  if (n_queries <= 0) return (int)cudaSuccess;
  if (n_rows <= 0 || W % kVec<T> != 0 || W < 5 * nf ||
      reinterpret_cast<uintptr_t>(table) % 16 != 0 || threads < 32 ||
      threads > 256 || threads % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (n_queries + threads - 1) / threads;
#define IU_WALK(NF_)                                                       \
  walk_kernel<NF_, T><<<blocks, threads, 0, s>>>(                          \
      table, n_rows, W, r0, r1, ic0, mask, n_queries, nudge, eps_arrive,   \
      big, tiny, max_steps, out_ic, out_rp, out_steps, out_status)
  if (nf == 3) {
    IU_WALK(3);
  } else if (nf == 4) {
    IU_WALK(4);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef IU_WALK
  return (int)cudaGetLastError();
}

template <typename T>
int get_cell_walk_launch(const T* table, int n_rows, int W, int nf,
                         const T* r, const int* start, const T* bin_pack,
                         const int* bin_table, const T* bin_rmin,
                         const T* bin_inv_h, int nbx, int nby, int nbz,
                         int n_queries, T nudge, T eps_arrive, T big, T tiny,
                         int max_steps, int p1, int* out_ic,
                         unsigned char* out_found,
                         unsigned long long* step_count, void* stream) {
  if (n_queries <= 0) return (int)cudaSuccess;
  if (n_rows <= 0 || W % kVec<T> != 0 || W < 8 * nf || p1 < 0 ||
      (start == nullptr && bin_pack == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const iu::BinGrid<T> bins{bin_rmin, bin_inv_h, nbx, nby, nbz};
  const int blocks = (n_queries + kGetCellThreads - 1) / kGetCellThreads;
#define IU_GET_CELL_WALK(NF_)                                               \
  get_cell_walk_kernel<NF_, T><<<blocks, kGetCellThreads, 0, s>>>(          \
      table, n_rows, W, r, start, bin_pack, bin_table, bins, n_queries,      \
      nudge, eps_arrive, big, tiny, max_steps, p1, out_ic, out_found,       \
      step_count)
  if (nf == 3) {
    IU_GET_CELL_WALK(3);
  } else if (nf == 4) {
    IU_GET_CELL_WALK(4);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef IU_GET_CELL_WALK
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes).  table: (n_rows, W) walk
// rows, float32 (iu_walk) or float64 (iu_walk_f64, with the positions
// and tolerances in double), W * the element size a multiple of 16
// bytes, 16-byte aligned; r0, r1, out_rp: (B, 3) starts, targets and
// final positions; ic0: (B,) int32 start cells; mask: (n_rows,) int32
// per-cell mask values, or null for a walk without a mask; nf: 3 or 4;
// tiny: walks shorter than it stay put; threads: a block's threads, a
// multiple of 32 up to 256 (the double kernel's registers do not fit
// 1024 threads a block).  Returns the cudaError_t of the launch.
extern "C" int iu_walk(const float* table, int n_rows, int W, int nf,
                       const float* r0, const float* r1, const int* ic0,
                       const int* mask, int n_queries, float nudge,
                       float eps_arrive, float big, float tiny,
                       int max_steps, int threads, int* out_ic,
                       float* out_rp, int* out_steps, int* out_status,
                       void* stream) {
  return walk_launch<float>(table, n_rows, W, nf, r0, r1, ic0, mask,
                            n_queries, nudge, eps_arrive, big, tiny,
                            max_steps, threads, out_ic, out_rp, out_steps,
                            out_status, stream);
}

extern "C" int iu_walk_f64(const double* table, int n_rows, int W, int nf,
                           const double* r0, const double* r1,
                           const int* ic0, const int* mask, int n_queries,
                           double nudge, double eps_arrive, double big,
                           double tiny, int max_steps, int threads,
                           int* out_ic, double* out_rp, int* out_steps,
                           int* out_status, void* stream) {
  return walk_launch<double>(table, n_rows, W, nf, r0, r1, ic0, mask,
                             n_queries, nudge, eps_arrive, big, tiny,
                             max_steps, threads, out_ic, out_rp, out_steps,
                             out_status, stream);
}

// Plain C entry points of get_cell's walk stage (bound with ctypes).
// table: (n_rows, W) walk rows, float32 (iu_get_cell_walk) or float64
// (iu_get_cell_walk_f64, every float argument in double), W * the
// element size a multiple of 16 bytes, 16-byte aligned; r: (B, 3)
// queries; start: (B,) int32 start cells, or null for a pure cold start
// from bin_pack ((n_bins, 4): seed id | seed center); bin_table:
// (n_bins,) int32 seeds that replace start cells outside [0, n_rows), or
// null to take start as given; bin_rmin, bin_inv_h: (3,) on the device;
// p1: phase-1 rounds (0: one phase of max_steps rounds).  out_ic: (B,)
// int32, out_found: (B,) bool.  step_count: a device counter (one 64-bit
// word) that the launch adds every walk's steps to, or null.  Returns the
// cudaError_t of the launch.
extern "C" int iu_get_cell_walk(const float* table, int n_rows, int W, int nf,
                                const float* r, const int* start,
                                const float* bin_pack, const int* bin_table,
                                const float* bin_rmin, const float* bin_inv_h,
                                int nbx, int nby, int nbz, int n_queries,
                                float nudge, float eps_arrive, float big,
                                float tiny, int max_steps, int p1,
                                int* out_ic, unsigned char* out_found,
                                unsigned long long* step_count,
                                void* stream) {
  return get_cell_walk_launch<float>(
      table, n_rows, W, nf, r, start, bin_pack, bin_table, bin_rmin,
      bin_inv_h, nbx, nby, nbz, n_queries, nudge, eps_arrive, big, tiny,
      max_steps, p1, out_ic, out_found, step_count, stream);
}

extern "C" int iu_get_cell_walk_f64(
    const double* table, int n_rows, int W, int nf, const double* r,
    const int* start, const double* bin_pack, const int* bin_table,
    const double* bin_rmin, const double* bin_inv_h, int nbx, int nby,
    int nbz, int n_queries, double nudge, double eps_arrive, double big,
    double tiny, int max_steps, int p1, int* out_ic,
    unsigned char* out_found, unsigned long long* step_count, void* stream) {
  return get_cell_walk_launch<double>(
      table, n_rows, W, nf, r, start, bin_pack, bin_table, bin_rmin,
      bin_inv_h, nbx, nby, nbz, n_queries, nudge, eps_arrive, big, tiny,
      max_steps, p1, out_ic, out_found, step_count, stream);
}

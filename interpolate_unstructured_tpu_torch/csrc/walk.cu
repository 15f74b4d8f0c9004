// The batched neighbor walk (kernel B3): every query walks from r0 inside
// cell ic0 along u until it arrives, leaves the domain or hits the step
// cap (iu_get_cell_through_neighbors + get_cell_intersection,
// m_interp_unstructured.f90:664-764).
//
// Replaces the JAX package's Pallas TPU kernel
// interpolate_unstructured_tpu/ops/pallas_walk.py:_kernel (wrapper
// walk_round, core _face_round), which ran ONE round for a tile of lanes
// on rows that XLA had gathered into a (B, 128) buffer; ops/locate.py's
// _walk_pallas looped it in a lax.while_loop until no lane was active.
// Each lane of that loop is independent, and an active lane steps in
// every round until it stops, so one thread per query looping up to
// max_steps rounds gives exactly the loop's per-lane result.  Here the
// state stays in registers for the whole walk, the host-side
// any(active) test per round disappears, and each thread reads the
// NF*5 leading floats of its current cell's row itself: there is no
// gather buffer.
//
// What bounds it on an H100: memory latency.  Each round is one
// dependent read of 80 bytes (tets) from a random row of the 512-byte
// walk table, then ~60 flops; the next row's address depends on the
// result.  Bytes moved are about 80 B per step plus 61 B of per-query
// state in and out.  The design keeps that minimal (no gather buffer,
// no per-round state traffic) and relies on many resident threads to
// hide the latency of the dependent reads.
//
// The face round is iu::walk_round in csrc/walk.cuh (shared with the
// tracer kernel).  Plain PyTorch version:
// ops/walk_kernel.py:walk_plain, whose rounding order this kernel
// follows (built with --fmad=false).

#include <cuda_runtime.h>

#include "walk.cuh"

namespace {

constexpr int kThreads = 128;

template <int NF>
__global__ void walk_kernel(const float* __restrict__ table, int n_rows,
                            int W, const float* __restrict__ r0,
                            const float* __restrict__ u,
                            const float* __restrict__ total,
                            const unsigned char* __restrict__ active0,
                            const int* __restrict__ ic0,
                            const int* __restrict__ mask, int n_queries,
                            float nudge, float eps_arrive, float big,
                            int max_steps, int* __restrict__ out_ic,
                            float* __restrict__ out_rp,
                            int* __restrict__ out_steps,
                            int* __restrict__ out_status) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n_queries) return;
  const float ux = u[3 * q + 0];
  const float uy = u[3 * q + 1];
  const float uz = u[3 * q + 2];
  iu::WalkState s;
  s.px = r0[3 * q + 0];
  s.py = r0[3 * q + 1];
  s.pz = r0[3 * q + 2];
  s.dist_left = total[q];
  s.ic = ic0[q];
  s.prev = -1;
  s.status = iu::kStatusArrived;
  s.steps = 0;
  s.active = active0[q] != 0;
  const int mask0 = mask != nullptr ? mask[iu::clamp_row(s.ic, n_rows)] : 0;
  for (int n = 0; n < max_steps && s.active; ++n) {
    iu::walk_round<NF>(table, n_rows, W, ux, uy, uz, nudge, eps_arrive, big,
                       mask, mask0, s);
  }
  out_ic[q] = s.ic;
  out_rp[3 * q + 0] = s.px;
  out_rp[3 * q + 1] = s.py;
  out_rp[3 * q + 2] = s.pz;
  out_steps[q] = s.steps;
  out_status[q] = s.active ? iu::kStatusStepCap : s.status;
}

template <int NF>
void launch(const float* table, int n_rows, int W, const float* r0,
            const float* u, const float* total, const unsigned char* active0,
            const int* ic0, const int* mask, int n_queries, float nudge,
            float eps_arrive, float big, int max_steps, int* out_ic,
            float* out_rp, int* out_steps, int* out_status, cudaStream_t s) {
  const int blocks = (n_queries + kThreads - 1) / kThreads;
  walk_kernel<NF><<<blocks, kThreads, 0, s>>>(
      table, n_rows, W, r0, u, total, active0, ic0, mask, n_queries, nudge,
      eps_arrive, big, max_steps, out_ic, out_rp, out_steps, out_status);
}

}  // namespace

// Plain C entry point (bound with ctypes).  table: (n_rows, W) float32
// walk rows; r0, u, out_rp: (B, 3); total: (B,); active0: (B,) bool, the
// lanes that walk (not degenerate); ic0: (B,) int32; mask: (n_rows,)
// int32 per-cell mask values, or null for a walk without a mask; nf: 3
// or 4.  Returns the cudaError_t of the launch.
extern "C" int iu_walk(const float* table, int n_rows, int W, int nf,
                       const float* r0, const float* u, const float* total,
                       const unsigned char* active0, const int* ic0,
                       const int* mask, int n_queries, float nudge,
                       float eps_arrive, float big, int max_steps,
                       int* out_ic, float* out_rp,
                       int* out_steps, int* out_status, void* stream) {
  if (n_queries <= 0) return (int)cudaSuccess;
  if (n_rows <= 0 || W < 5 * nf) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nf == 3) {
    launch<3>(table, n_rows, W, r0, u, total, active0, ic0, mask, n_queries,
              nudge, eps_arrive, big, max_steps, out_ic, out_rp, out_steps,
              out_status, s);
  } else if (nf == 4) {
    launch<4>(table, n_rows, W, r0, u, total, active0, ic0, mask, n_queries,
              nudge, eps_arrive, big, max_steps, out_ic, out_rp, out_steps,
              out_status, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

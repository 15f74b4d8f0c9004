// Every field line's whole RK23 loop (kernel B4): per iteration, k1 from
// the stored field sample, the walks to the stage-2, stage-3 and stage-4
// targets of one Bogacki-Shampine step, interpolating the field from the
// trace table on each arrival, then the error estimate, the accept test,
// the boundary shrink, the store of the new point and the step-size
// control (iu_integrate_along_field, m_interp_unstructured.f90:
// 1078-1190).
//
// Replaces the JAX package's Pallas TPU kernel
// interpolate_unstructured_tpu/ops/pallas_trace.py:_kernel (wrapper
// trace_round).  That kernel ran ONE round of the stages for a tile of
// lanes, on trace rows that XLA had gathered into a (B, W) buffer and on
// state stacked into F (32, B) and I (8, B) blocks; trace.py's
// _fused_stages looped it in a lax.while_loop with a count of walking
// lanes per round, and integrate_along_field's lax.while_loop ran the
// iterations around it.  A line's state depends on itself only, and a
// finished line is left unchanged, so here one thread per line keeps its
// state in registers and loops its own iterations until it is done (or
// max_iterations), each iteration's stages looping their rounds until
// the stage machine finishes (or a round cap that the stages never
// reach).  It reads its current cell's row itself.  There is no gather
// buffer, no per-round or per-iteration state traffic and no host-side
// loop: one launch per trace.  The one value shared across lines is
// n_rounds, the sum over iterations of the largest round count of any
// line (as the JAX package counts it): an atomicMax per line and
// iteration into an int32 buffer indexed by iteration, summed on the
// device after the launch.
//
// Each round: the neighbor-walk round of csrc/walk.cuh (iu::face_round,
// which reads the NF*5 walk columns); on arrival (no face crossed before
// the target) the field at the target from the same row's vertex, volume
// and field columns, with the weights of csrc/wkern.cuh, then k = +-field
// / max(|field|, tiny) and the stage machine: k2 -> aim at anchor + 0.75 dx
// k2, k3 -> aim at anchor + dx (2 k1 + 3 k2 + 4 k3) / 9, k4 and the field
// there -> done.  A walk that leaves the domain, or still walks after
// max_steps rounds of one stage, fails the iteration and records its
// position and cell for the boundary shrink.  The tracer's round is not
// iu::walk_round: it caps each stage, not the whole walk, and it runs
// the stage machine.
//
// What bounds it on an H100: memory latency, as for the walk.  Each round
// is one dependent read of a random 256-byte trace row (the 80 leading
// bytes every round, 100 more on arrival for tets), and a line's rounds
// and iterations are a chain of such reads.  Counting each byte once, a
// trace moves its lines' start state and end codes, the points it
// stores and the distinct rows it visits: far less than the time of the
// chain.  The design keeps the bytes at that minimum (state in
// registers, rows read in place) and relies on many resident threads to
// hide the dependent reads; a bundle of 1024 lines takes 16 blocks of
// 64 on 16 of the 132 SMs, so its time is its slowest line's chain.
//
// Plain PyTorch version: ops/trace_kernel.py:trace_loop_plain (stages:
// trace_plain; the rest: step_control), whose rounding order this kernel
// follows (built with --fmad=false): every three-term dot product as
// (x + y) + z, reciprocal-multiply weights, k123 as ((2 k1 + 3 k2) +
// 4 k3) / 9, IEEE division where the plain version divides by a tensor,
// powf for err ** (1/3) at the float32 exponent torch takes, Python
// scalars rounded to float32 by the wrapper as torch rounds them, and
// min, max and clamp propagating NaN as torch's do.

#include <cuda_runtime.h>

#include "walk.cuh"
#include "wkern.cuh"

namespace {

constexpr int kThreads = 64;

// Cell types: 0 triangle (nf = npc = 3, 2D), 1 quad (4/4, 2D), 2 tetra
// (4/4, 3D).
template <int CT>
struct Cell {
  static constexpr int NF = CT == 0 ? 3 : 4;
  static constexpr int NPC = NF;
  static constexpr int NDIM = CT == 2 ? 3 : 2;
};

__device__ __forceinline__ float norm3(const float a[3]) {
  return sqrtf((a[0] * a[0] + a[1] * a[1]) + a[2] * a[2]);
}

// Field at q from a trace row: weights of the row's cell over its vertex
// field values, summed in vertex order; zero past NDIM.
template <int CT>
__device__ __forceinline__ void field_at(const float* __restrict__ row,
                                         const float q[3], float fld[3]) {
  constexpr int NF = Cell<CT>::NF, NPC = Cell<CT>::NPC;
  constexpr int NDIM = Cell<CT>::NDIM;
  const float* cp = row + NF * 5;
  float v[NPC][3];
#pragma unroll
  for (int k = 0; k < NPC; ++k) {
#pragma unroll
    for (int d = 0; d < 3; ++d) v[k][d] = cp[k * 3 + d];
  }
  const float vol = cp[NPC * 3];
  const float* fv = cp + NPC * 3 + 1;
  float w[NPC];
  if constexpr (CT == 0) {
    float a2[3];
    iu::triangle_areas2(v, q, a2);
    const float inv = 0.5f / vol;
#pragma unroll
    for (int k = 0; k < 3; ++k) w[k] = a2[k] * inv;
  } else if constexpr (CT == 1) {
    iu::quad_weights(v, q, 8.0f * 1.1920928955078125e-07f, w);
  } else {
    float t[4];
    iu::tetra_triples(v, q, t);
    const float inv = 1.0f / (6.0f * vol);
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = t[k] * inv;
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    if (d < NDIM) {
      float acc = w[0] * fv[d];
#pragma unroll
      for (int k = 1; k < NPC; ++k) acc = acc + w[k] * fv[k * NDIM + d];
      fld[d] = acc;
    } else {
      fld[d] = 0.0f;
    }
  }
}

// Unit direction and length of delta; direction 0 at lengths <= tiny.
__device__ __forceinline__ float unit_or_zero(const float delta[3],
                                              float tiny, float u[3]) {
  const float total = norm3(delta);
  const float invt = total > tiny ? 1.0f / total : 0.0f;
#pragma unroll
  for (int d = 0; d < 3; ++d) u[d] = delta[d] * invt;
  return total;
}

// torch's minimum, maximum and clamp, which return a NaN operand
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tclamp(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float tclamp_min(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}

// Walk and stage parameters of a trace.
struct StageArgs {
  const float* table;
  int n_rows, W;
  float nudge, eps_arrive, tiny, big;
  bool reverse, axisymmetric;
  int max_steps;  // walk rounds a stage may take
  float min_radius;
  int round_cap;
};

// Results of the stages of one iteration (ops/trace_kernel.py:Stages).
struct StageOut {
  float k2[3], k3[3], k4[3], f4[3], rpf[3];
  int ic, fail, icf, rounds;
};

// Stages 2-4 of one RK iteration of one line from anchor a with
// stage-1 derivative k1 and step dx, starting in cell ic_start.
template <int CT>
__device__ __forceinline__ void rk_stages(const StageArgs& P,
                                          const float a[3],
                                          const float k1[3], float dx,
                                          int ic_start, StageOut& o) {
  constexpr int NF = Cell<CT>::NF;
  // Stage-2 walk: from the anchor towards anchor + dx/2 k1
  float tgt[3], delta[3], u[3], p[3];
  const float half = 0.5f * dx;
#pragma unroll
  for (int d = 0; d < 3; ++d) tgt[d] = a[d] + half * k1[d];
  if (P.axisymmetric) tgt[0] = fmaxf(tgt[0], P.min_radius);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    delta[d] = tgt[d] - a[d];
    p[d] = a[d];
    o.k2[d] = o.k3[d] = o.k4[d] = o.f4[d] = 0.0f;
    o.rpf[d] = a[d];
  }
  float dl = unit_or_zero(delta, P.tiny, u);

  int ic = ic_start < 0 ? 0 : ic_start;
  int prev = -1, steps = 0, fail = 0, icf = -1, rounds = 0;
  int stage = 2;
  bool walking = true;

  while (walking && rounds < P.round_cap) {
    ++rounds;
    const float* row = P.table + (size_t)iu::clamp_row(ic, P.n_rows) * P.W;
    int ic_next;
    bool hit;
    const float face_dist = iu::face_round<NF>(row, u[0], u[1], u[2], p[0],
                                               p[1], p[2], prev, P.big,
                                               &ic_next, &hit);
    const bool crossing = hit && (dl - face_dist > P.eps_arrive);
    const bool out_of_domain = ic_next < 0;
    const bool continuing = crossing && !out_of_domain;
    const float advance = face_dist + (continuing ? P.nudge : 0.0f);
    if (hit) {
#pragma unroll
      for (int d = 0; d < 3; ++d) p[d] = p[d] + advance * u[d];
      dl = dl - advance;
    }
    steps += 1;
    if (continuing) prev = ic;
    if (crossing) ic = ic_next;
    const bool capped = continuing && steps >= P.max_steps;

    if (!crossing) {
      // Arrived in the row's cell: the field at the target, k = +-unit
      float fld[3], kn[3];
      field_at<CT>(row, tgt, fld);
      const float fn = fmaxf(norm3(fld), P.tiny);
#pragma unroll
      for (int d = 0; d < 3; ++d) kn[d] = (P.reverse ? -fld[d] : fld[d]) / fn;
      const bool enter = stage == 2 || stage == 3;
      float t[3];
      if (stage == 2) {
        const float c = 0.75f * dx;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          o.k2[d] = kn[d];
          t[d] = a[d] + c * o.k2[d];
        }
      } else if (stage == 3) {
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          o.k3[d] = kn[d];
          const float k123 =
              (2.0f * k1[d] + 3.0f * o.k2[d] + 4.0f * o.k3[d]) / 9.0f;
          t[d] = a[d] + dx * k123;
        }
      } else {
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          o.k4[d] = kn[d];
          o.f4[d] = fld[d];
        }
      }
      if (enter) {
        // The next stage walks from this target to the new one
        if (P.axisymmetric) t[0] = fmaxf(t[0], P.min_radius);
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          delta[d] = t[d] - tgt[d];
          p[d] = tgt[d];
          tgt[d] = t[d];
        }
        dl = unit_or_zero(delta, P.tiny, u);
        prev = -1;
        steps = 0;
      }
      stage += 1;
      walking = enter;
    } else if (out_of_domain || capped) {
      stage = 5;
      fail = 1;
#pragma unroll
      for (int d = 0; d < 3; ++d) o.rpf[d] = p[d];
      icf = ic;
      walking = false;
    }
  }
  o.ic = ic;
  o.fail = fail;
  o.icf = icf;
  o.rounds = rounds;
}

// Step control of a trace (ops/trace_kernel.py:step_control), its
// Python scalars rounded to float32 by the wrapper.
struct StepArgs {
  float min_dx, max_dx, two_min_dx, rtol, atol, shrink_fac, safety, third;
  int max_steps;  // points a line stores
  int max_iterations;
};

constexpr int kBmStepCap = -3;  // ops/trace_kernel.py:BM_STEP_CAP

// One thread per line: the line's RK loop (ops/trace_kernel.py:
// trace_loop_plain) from its start point y0 and field field0 in cell
// ic0; lines with done0 set do not start.  y_buf, yf_buf (n, max_steps
// + 1, NDIM) hold the start in row 0 and take the stored points.
template <int CT>
__global__ void __launch_bounds__(kThreads)
trace_loop_kernel(StageArgs P, StepArgs S, const float* __restrict__ y0,
                  const float* __restrict__ field0,
                  const int* __restrict__ ic0,
                  const unsigned char* __restrict__ done0,
                  const int* __restrict__ bm0, int n,
                  float* __restrict__ y_buf, float* __restrict__ yf_buf,
                  int* __restrict__ n_steps_out, int* __restrict__ bm_out,
                  int* __restrict__ iter_out, int* __restrict__ rounds_it) {
  constexpr int NDIM = Cell<CT>::NDIM;
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n) return;
  float anchor[3] = {0.0f, 0.0f, 0.0f}, fa[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    if (d < NDIM) anchor[d] = y0[NDIM * q + d];
    fa[d] = field0[3 * q + d];
  }
  int ic_prev = ic0[q];
  bool done = done0[q] != 0;
  int bm = bm0[q];
  float dx = S.max_dx;
  int n_idx = 0, last_rejected = -100, iteration = 0;
  bool overflow = false;
  const size_t row0 = (size_t)q * (S.max_steps + 1);

  for (int it = 0; it < S.max_iterations && !done; ++it) {
    // k1 reuses the stored field sample (:1109-1115)
    float k1[3];
    const float fn = tclamp_min(norm3(fa), P.tiny);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      k1[d] = d < NDIM ? (P.reverse ? -fa[d] : fa[d]) / fn : 0.0f;
    }
    StageOut o;
    rk_stages<CT>(P, anchor, k1, dx, ic_prev, o);
    atomicMax(rounds_it + it, o.rounds);
    const bool failed = o.fail != 0;
    const bool cap_fail = failed && o.icf >= 0;

    // third-order point and the embedded 2nd-order estimate (:1159-1163)
    float ys3[3] = {0.0f, 0.0f, 0.0f};
    float q_sum = 0.0f;
#pragma unroll
    for (int d = 0; d < NDIM; ++d) {
      const float k123 =
          (2.0f * k1[d] + 3.0f * o.k2[d] + 4.0f * o.k3[d]) / 9.0f;
      ys3[d] = anchor[d] + dx * k123;
      const float ks = ((7.0f * k1[d] + 6.0f * o.k2[d]) + 8.0f * o.k3[d]) +
                       3.0f * o.k4[d];
      const float y2 = anchor[d] + (dx * ks) / 24.0f;
      const float sc = S.atol + tmax(fabsf(ys3[d]), fabsf(y2)) * S.rtol;
      float qd = (ys3[d] - y2) / sc;
      qd = qd * qd;
      q_sum = d == 0 ? qd : q_sum + qd;
    }
    const float err = sqrtf(q_sum / 3.0f);
    const bool accept = !failed && (err <= 1.0f || dx < S.two_min_dx);

    // failure path: shrink dx to the boundary distance, at most 0.75 dx
    float db[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) db[d] = o.rpf[d] - anchor[d];
    const float dx_fail = tmin(S.shrink_fac * norm3(db), 0.75f * dx);
    const bool hit_boundary = failed && dx_fail < S.min_dx;

    // accept path: store the new point
    const int n_new = accept ? n_idx + 1 : n_idx;
    const bool overflow_now = accept && n_new >= S.max_steps;
    if (accept && !overflow_now) {
      if (P.axisymmetric) ys3[0] = tclamp_min(ys3[0], P.min_radius);
      float* yr = y_buf + (row0 + n_new) * NDIM;
      float* fr = yf_buf + (row0 + n_new) * NDIM;
#pragma unroll
      for (int d = 0; d < NDIM; ++d) {
        yr[d] = ys3[d];
        fr[d] = o.f4[d];
        anchor[d] = ys3[d];
      }
#pragma unroll
      for (int d = 0; d < 3; ++d) fa[d] = o.f4[d];
      n_idx = n_new;
    }
    if (accept) ic_prev = o.ic;

    // step-size control (:1178-1188)
    if (failed || !accept) last_rejected = it;
    const float max_growth = last_rejected > it - 2 ? 1.0f : 2.0f;
    const float inv = 1.0f / err;
    const float factor = tmin(max_growth, S.safety * powf(inv, S.third));
    const float dx_ok = tclamp(dx * factor, S.min_dx, S.max_dx);
    dx = failed ? dx_fail : dx_ok;

    done = hit_boundary || overflow_now;
    // a step-cap failure at min_dx is a walk-budget artifact, reported
    // distinctly; no icell mask on this path: -1 for a boundary
    if (hit_boundary) bm = cap_fail ? kBmStepCap : -1;
    iteration = it + 1;
    overflow = overflow || overflow_now;
  }
  n_steps_out[q] = overflow ? S.max_steps + 1 : n_idx + 1;
  bm_out[q] = bm;
  iter_out[q] = iteration;
}

template <int CT>
void launch(const StageArgs& P, const StepArgs& S, const float* y0,
            const float* field0, const int* ic0, const unsigned char* done0,
            const int* bm0, int n, float* y_buf, float* yf_buf, int* n_steps,
            int* bm, int* iters, int* rounds_it, cudaStream_t s) {
  const int blocks = (n + kThreads - 1) / kThreads;
  trace_loop_kernel<CT><<<blocks, kThreads, 0, s>>>(
      P, S, y0, field0, ic0, done0, bm0, n, y_buf, yf_buf, n_steps, bm, iters,
      rounds_it);
}

}  // namespace

// Plain C entry point (bound with ctypes).  table: (n_rows, W) float32
// trace rows (normals | offsets | neighbor ids | vertices | volume |
// field vertex values); cell_type 0 triangle, 1 quad, 2 tetra; y0: (n,
// ndim) start points; field0: (n, 3) the field there, zero-padded; ic0:
// (n,) int32 start cells; done0: (n,) bool lines that do not start; bm0:
// (n,) int32 their codes.  The step-control scalars come rounded to
// float32 (two_min_dx = 2 min_dx, shrink_fac = 1 - shrink_eps, safety,
// third = 1/3).  Outputs: y_buf, yf_buf (n, max_steps + 1, ndim) with
// row 0 set by the caller, n_steps, bm, iterations (n,) int32, rounds_it
// (max_iterations,) int32 zeroed by the caller.  Returns the
// cudaError_t of the launch.
extern "C" int iu_trace_loop(
    const float* table, int n_rows, int W, int cell_type, const float* y0,
    const float* field0, const int* ic0, const unsigned char* done0,
    const int* bm0, int n, float nudge, float eps_arrive, float tiny,
    float big, int reverse, int axisymmetric, int walk_steps,
    float min_radius, int round_cap, float min_dx, float max_dx,
    float two_min_dx, float rtol, float atol, float shrink_fac, float safety,
    float third, int max_steps, int max_iterations, float* y_buf,
    float* yf_buf, int* n_steps, int* bm, int* iters, int* rounds_it,
    void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (n_rows <= 0 || max_steps < 1 || max_iterations < 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const StageArgs P{table,      n_rows,      W,           nudge,
                    eps_arrive, tiny,        big,         reverse != 0,
                    axisymmetric != 0,       walk_steps,  min_radius,
                    round_cap};
  const StepArgs S{min_dx,     max_dx, two_min_dx, rtol,      atol,
                   shrink_fac, safety, third,      max_steps, max_iterations};
  switch (cell_type) {
    case 0:
      launch<0>(P, S, y0, field0, ic0, done0, bm0, n, y_buf, yf_buf, n_steps,
                bm, iters, rounds_it, s);
      break;
    case 1:
      launch<1>(P, S, y0, field0, ic0, done0, bm0, n, y_buf, yf_buf, n_steps,
                bm, iters, rounds_it, s);
      break;
    case 2:
      launch<2>(P, S, y0, field0, ic0, done0, bm0, n, y_buf, yf_buf, n_steps,
                bm, iters, rounds_it, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

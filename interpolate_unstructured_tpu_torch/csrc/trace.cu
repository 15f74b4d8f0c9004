// The fused stages of one tracer RK23 iteration (kernel B4): for every
// trajectory, walk to the stage-2, stage-3 and stage-4 targets of one
// Bogacki-Shampine step, interpolating the field from the trace table on
// each arrival (iu_integrate_along_field, m_interp_unstructured.f90:
// 1122-1156).
//
// Replaces the JAX package's Pallas TPU kernel
// interpolate_unstructured_tpu/ops/pallas_trace.py:_kernel (wrapper
// trace_round).  That kernel ran ONE round for a tile of lanes, on trace
// rows that XLA had gathered into a (B, W) buffer and on state stacked
// into F (32, B) and I (8, B) blocks; trace.py's _fused_stages looped it
// in a lax.while_loop with a count of walking lanes per round, padding to
// the tile and a compaction of the stragglers.  An inactive lane is left
// unchanged by a round, so a lane's result does not depend on the others:
// here one thread per trajectory keeps its state in registers and loops
// its own rounds until its stage machine finishes (or a round cap that
// the stages never reach), and reads its current cell's row itself.
// There is no gather buffer, no per-round state traffic and no host-side
// loop condition: one launch per RK iteration.
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
// bytes every round, 100 more on arrival for tets); lane state is 33
// bytes in and 76 out; the arithmetic is ~60 flops a round and ~100 an
// arrival.  Bytes per iteration are about B x (109 + 80 x rounds + 300),
// so the bound is that over 3.35 TB/s.  The design keeps the bytes at
// that minimum (state in registers, rows read in place) and relies on
// many resident threads to hide the dependent reads.  A lane walks three
// short stages (a few rounds each), so the launch of a small bundle is
// short and the host loop around it (trace.py) may cost more than it.
//
// Plain PyTorch version: ops/trace_kernel.py:trace_plain, whose rounding
// order this kernel follows (built with --fmad=false): every three-term
// dot product as (x + y) + z, reciprocal-multiply weights, k123 as
// ((2 k1 + 3 k2) + 4 k3) / 9.

#include <cuda_runtime.h>

#include "walk.cuh"
#include "wkern.cuh"

namespace {

constexpr int kThreads = 128;

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

template <int CT>
__global__ void trace_kernel(
    const float* __restrict__ table, int n_rows, int W,
    const float* __restrict__ anchor, const float* __restrict__ k1g,
    const float* __restrict__ dxg, const int* __restrict__ ic_start,
    const unsigned char* __restrict__ act, int n, float nudge,
    float eps_arrive, float tiny, float big, bool reverse, bool axisymmetric,
    int max_steps, float min_radius, int round_cap, float* __restrict__ out_f,
    int* __restrict__ out_i) {
  constexpr int NF = Cell<CT>::NF;
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n) return;
  float a[3], k1[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    a[d] = anchor[3 * q + d];
    k1[d] = k1g[3 * q + d];
  }
  const float dx = dxg[q];

  // Stage-2 walk: from the anchor towards anchor + dx/2 k1
  float tgt[3], delta[3], u[3], p[3];
  const float half = 0.5f * dx;
#pragma unroll
  for (int d = 0; d < 3; ++d) tgt[d] = a[d] + half * k1[d];
  if (axisymmetric) tgt[0] = fmaxf(tgt[0], min_radius);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    delta[d] = tgt[d] - a[d];
    p[d] = a[d];
  }
  float dl = unit_or_zero(delta, tiny, u);

  float k2[3] = {0.0f, 0.0f, 0.0f}, k3[3] = {0.0f, 0.0f, 0.0f};
  float k4[3] = {0.0f, 0.0f, 0.0f}, f4[3] = {0.0f, 0.0f, 0.0f};
  float rpf[3] = {a[0], a[1], a[2]};
  int ic = ic_start[q] < 0 ? 0 : ic_start[q];
  int prev = -1, steps = 0, fail = 0, icf = -1, rounds = 0;
  int stage = act[q] != 0 ? 2 : 5;
  bool walking = act[q] != 0;

  while (walking && rounds < round_cap) {
    ++rounds;
    const float* row = table + (size_t)iu::clamp_row(ic, n_rows) * W;
    int ic_next;
    bool hit;
    const float face_dist = iu::face_round<NF>(row, u[0], u[1], u[2], p[0],
                                               p[1], p[2], prev, big,
                                               &ic_next, &hit);
    const bool crossing = hit && (dl - face_dist > eps_arrive);
    const bool out_of_domain = ic_next < 0;
    const bool continuing = crossing && !out_of_domain;
    const float advance = face_dist + (continuing ? nudge : 0.0f);
    if (hit) {
#pragma unroll
      for (int d = 0; d < 3; ++d) p[d] = p[d] + advance * u[d];
      dl = dl - advance;
    }
    steps += 1;
    if (continuing) prev = ic;
    if (crossing) ic = ic_next;
    const bool capped = continuing && steps >= max_steps;

    if (!crossing) {
      // Arrived in the row's cell: the field at the target, k = +-unit
      float fld[3], kn[3];
      field_at<CT>(row, tgt, fld);
      const float fn = fmaxf(norm3(fld), tiny);
#pragma unroll
      for (int d = 0; d < 3; ++d) kn[d] = (reverse ? -fld[d] : fld[d]) / fn;
      const bool enter = stage == 2 || stage == 3;
      float t[3];
      if (stage == 2) {
        const float c = 0.75f * dx;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          k2[d] = kn[d];
          t[d] = a[d] + c * k2[d];
        }
      } else if (stage == 3) {
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          k3[d] = kn[d];
          const float k123 = (2.0f * k1[d] + 3.0f * k2[d] + 4.0f * k3[d]) / 9.0f;
          t[d] = a[d] + dx * k123;
        }
      } else {
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          k4[d] = kn[d];
          f4[d] = fld[d];
        }
      }
      if (enter) {
        // The next stage walks from this target to the new one
        if (axisymmetric) t[0] = fmaxf(t[0], min_radius);
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          delta[d] = t[d] - tgt[d];
          p[d] = tgt[d];
          tgt[d] = t[d];
        }
        dl = unit_or_zero(delta, tiny, u);
        prev = -1;
        steps = 0;
      }
      stage += 1;
      walking = enter;
    } else if (out_of_domain || capped) {
      stage = 5;
      fail = 1;
#pragma unroll
      for (int d = 0; d < 3; ++d) rpf[d] = p[d];
      icf = ic;
      walking = false;
    }
  }

  float* of = out_f + (size_t)15 * q;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    of[d] = k2[d];
    of[3 + d] = k3[d];
    of[6 + d] = k4[d];
    of[9 + d] = f4[d];
    of[12 + d] = rpf[d];
  }
  int* oi = out_i + (size_t)4 * q;
  oi[0] = ic;
  oi[1] = fail;
  oi[2] = icf;
  oi[3] = rounds;
}

template <int CT>
void launch(const float* table, int n_rows, int W, const float* anchor,
            const float* k1, const float* dx, const int* ic_start,
            const unsigned char* act, int n, float nudge, float eps_arrive,
            float tiny, float big, bool reverse, bool axisymmetric,
            int max_steps, float min_radius, int round_cap, float* out_f,
            int* out_i, cudaStream_t s) {
  const int blocks = (n + kThreads - 1) / kThreads;
  trace_kernel<CT><<<blocks, kThreads, 0, s>>>(
      table, n_rows, W, anchor, k1, dx, ic_start, act, n, nudge, eps_arrive,
      tiny, big, reverse, axisymmetric, max_steps, min_radius, round_cap,
      out_f, out_i);
}

}  // namespace

// Plain C entry point (bound with ctypes).  table: (n_rows, W) float32
// trace rows (normals | offsets | neighbor ids | vertices | volume |
// field vertex values); cell_type 0 triangle, 1 quad, 2 tetra; anchor,
// k1: (n, 3) zero-padded; dx: (n,); ic_start: (n,) int32; act: (n,) bool.
// Outputs: out_f (n, 15) = k2 | k3 | k4 | field4 | rp_fail, out_i (n, 4)
// = ic | fail | ic_fail | rounds.  Returns the cudaError_t of the launch.
extern "C" int iu_trace(const float* table, int n_rows, int W, int cell_type,
                        const float* anchor, const float* k1, const float* dx,
                        const int* ic_start, const unsigned char* act, int n,
                        float nudge, float eps_arrive, float tiny, float big,
                        int reverse, int axisymmetric, int max_steps,
                        float min_radius, int round_cap, float* out_f,
                        int* out_i, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (n_rows <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool rev = reverse != 0, axi = axisymmetric != 0;
  switch (cell_type) {
    case 0:
      launch<0>(table, n_rows, W, anchor, k1, dx, ic_start, act, n, nudge,
                eps_arrive, tiny, big, rev, axi, max_steps, min_radius,
                round_cap, out_f, out_i, s);
      break;
    case 1:
      launch<1>(table, n_rows, W, anchor, k1, dx, ic_start, act, n, nudge,
                eps_arrive, tiny, big, rev, axi, max_steps, min_radius,
                round_cap, out_f, out_i, s);
      break;
    case 2:
      launch<2>(table, n_rows, W, anchor, k1, dx, ic_start, act, n, nudge,
                eps_arrive, tiny, big, rev, axi, max_steps, min_radius,
                round_cap, out_f, out_i, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

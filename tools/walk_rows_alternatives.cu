// Designs of the explicit walk (kernel B3's walk_rows) that
// tools/walk_rows_sweep.py times against the port's (csrc/walk.cu
// walk_kernel, included below, one thread a walk).  Built by the sweep
// alone into its own library; the port never loads it.
//
//   parent: the design before the redesign, one thread a walk, 128
//     threads a block; the unit direction u, the length and whether the
//     walk moves come in from tensors that torch computed
//     (ops/walk_kernel.py:walk_direction); each round reads the row's
//     NF*5 leading elements as separate loads, through iu::walk_round
//     (csrc/walk.cuh);
//   lanes: four lanes a walk, the direction computed in the kernel; lane
//     f < NF reads face f's normal, offset and neighbor and computes its
//     distance, so the NF IEEE divisions of a round run side by side;
//     two xor-shuffle steps merge the lanes' (distance, face) pairs into
//     the round's best and runner-up, ordered by (distance, face index),
//     which is what face_round's sequential scan with strict < keeps
//     (the first of equal minima, then the least of the rest, never a
//     distance that is not < big); every lane then applies the same
//     state update (no mask: the sweep's walks take none).
//
// Their rounds are the port's (walk.cuh, --fmad=false), so each is
// torch.equal to ops/walk_kernel.py:walk_rows_plain.

#include "../interpolate_unstructured_tpu_torch/csrc/walk.cu"

namespace {

constexpr int kThreads = 128;
constexpr int kWalkLanes = 4;  // lanes a walk of walk_lanes_kernel

template <int NF, typename T>
__global__ void parent_walk_kernel(
    const T* __restrict__ table, int n_rows, int W, const T* __restrict__ r0,
    const T* __restrict__ u, const T* __restrict__ total,
    const unsigned char* __restrict__ active0, const int* __restrict__ ic0,
    const int* __restrict__ mask, int n_queries, T nudge, T eps_arrive, T big,
    int max_steps, int* __restrict__ out_ic, T* __restrict__ out_rp,
    int* __restrict__ out_steps, int* __restrict__ out_status) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n_queries) return;
  const T ux = u[3 * q + 0];
  const T uy = u[3 * q + 1];
  const T uz = u[3 * q + 2];
  iu::WalkState<T> s;
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

template <typename T>
int parent_launch(const T* table, int n_rows, int W, int nf, const T* r0,
                  const T* u, const T* total, const unsigned char* active0,
                  const int* ic0, const int* mask, int n_queries, T nudge,
                  T eps_arrive, T big, int max_steps, int* out_ic, T* out_rp,
                  int* out_steps, int* out_status, void* stream) {
  if (n_queries <= 0) return (int)cudaSuccess;
  if (n_rows <= 0 || W < 5 * nf) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (n_queries + kThreads - 1) / kThreads;
#define IU_WALK(NF_)                                                         \
  parent_walk_kernel<NF_, T><<<blocks, kThreads, 0, s>>>(                    \
      table, n_rows, W, r0, u, total, active0, ic0, mask, n_queries, nudge, \
      eps_arrive, big, max_steps, out_ic, out_rp, out_steps, out_status)
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

// walk.cuh's face_round after its scan, and walk_round_row after
// face_round, as functions of the round's best (d1, n1) and runner-up
// (d2, n2), which the four lanes merge instead of one thread's scan.
template <typename T>
__device__ __forceinline__ T face_pick(T d1, int n1, T d2, int n2, int prev,
                                       T big, int* ic_next, bool* hit) {
  const bool backtrack = (n1 == prev) && (prev >= 0);
  T face_dist = backtrack ? d2 : d1;
  *ic_next = backtrack ? n2 : n1;
  *hit = face_dist < T(0.5) * big;
  return face_dist < T(0) ? T(0) : face_dist;  // never step backwards
}

template <typename T>
__device__ __forceinline__ void walk_advance(T face_dist, int ic_next,
                                             bool hit, T ux, T uy, T uz,
                                             T nudge, T eps_arrive,
                                             iu::WalkState<T>& s) {
  const bool crossing = hit && (s.dist_left - face_dist > eps_arrive);
  const bool out_of_domain = ic_next < 0;
  const bool continuing = crossing && !out_of_domain;
  const T advance = face_dist + (continuing ? nudge : T(0));
  if (hit) {
    s.px = s.px + advance * ux;
    s.py = s.py + advance * uy;
    s.pz = s.pz + advance * uz;
    s.dist_left = s.dist_left - advance;
  }
  s.status = (crossing && out_of_domain) ? iu::kStatusBoundary
                                         : iu::kStatusArrived;
  if (continuing) s.prev = s.ic;
  if (crossing) s.ic = ic_next;
  s.steps += 1;
  s.active = continuing;
}

// A (distance, face) entry of a round's top two; face kNoFace marks an
// empty entry (distance big), after every recorded face.
constexpr int kNoFace = 1 << 20;

template <typename T>
struct FaceEntry {
  T d;
  int f;
  int nbr;
};

// (distance, face index) order: the order face_round's scan keeps.
template <typename T>
__device__ __forceinline__ bool before(const FaceEntry<T>& a,
                                       const FaceEntry<T>& b) {
  return a.d < b.d || (a.d == b.d && a.f < b.f);
}

template <typename T>
__device__ __forceinline__ FaceEntry<T> shfl_entry(unsigned gmask,
                                                   const FaceEntry<T>& e,
                                                   int off) {
  return {__shfl_xor_sync(gmask, e.d, off, kWalkLanes),
          __shfl_xor_sync(gmask, e.f, off, kWalkLanes),
          __shfl_xor_sync(gmask, e.nbr, off, kWalkLanes)};
}

// The explicit walk, kWalkLanes lanes a walk: lane f < NF computes face
// f's distance; two xor-shuffle steps merge the group's sorted pairs
// (best, runner-up) so that every lane holds the round's top two.
template <int NF, typename T>
__global__ void walk_lanes_kernel(const T* __restrict__ table, int n_rows,
                                  int W, const T* __restrict__ r0,
                                  const T* __restrict__ r1,
                                  const int* __restrict__ ic0, int n_queries,
                                  T nudge, T eps_arrive, T big, T tiny,
                                  int max_steps, int* __restrict__ out_ic,
                                  T* __restrict__ out_rp,
                                  int* __restrict__ out_steps,
                                  int* __restrict__ out_status) {
  static_assert(NF <= kWalkLanes, "a lane a face");
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int q = (int)(t / kWalkLanes);
  const int f = threadIdx.x % kWalkLanes;
  if (q >= n_queries) return;  // the whole group
  const unsigned gmask = 0xfu << (threadIdx.x & 31 & ~(kWalkLanes - 1));
  iu::WalkState<T> s;
  T ux, uy, uz;
  walk_direction(r0[3 * q + 0], r0[3 * q + 1], r0[3 * q + 2], r1[3 * q + 0],
                 r1[3 * q + 1], r1[3 * q + 2], tiny, ux, uy, uz, s);
  s.ic = ic0[q];
  s.steps = 0;
  for (int n = 0; n < max_steps && s.active; ++n) {
    const T* row = table + (size_t)iu::clamp_row(s.ic, n_rows) * W;
    FaceEntry<T> a{big, kNoFace, -1};
    if (f < NF) {
      const T nx = __ldg(row + f * 3 + 0);
      const T ny = __ldg(row + f * 3 + 1);
      const T nz = __ldg(row + f * 3 + 2);
      const T off = __ldg(row + NF * 3 + f);
      const int nbr = (int)__ldg(row + NF * 4 + f);
      const T pdn = (nx * ux + ny * uy) + nz * uz;
      const T rpn = (nx * s.px + ny * s.py) + nz * s.pz;
      const T dist = pdn > T(0) ? (off - rpn) / pdn : big;
      if (dist < big) a = {dist, f, nbr};
    }
    FaceEntry<T> b{big, kNoFace, -1};
#pragma unroll
    for (int off = 1; off < kWalkLanes; off <<= 1) {
      const FaceEntry<T> oa = shfl_entry(gmask, a, off);
      const FaceEntry<T> ob = shfl_entry(gmask, b, off);
      if (before(oa, a)) {
        b = before(a, ob) ? a : ob;
        a = oa;
      } else {
        b = before(oa, b) ? oa : b;
      }
    }
    int ic_next;
    bool hit;
    const T face_dist = face_pick(a.d, a.nbr, b.d, b.nbr, s.prev, big,
                                  &ic_next, &hit);
    walk_advance(face_dist, ic_next, hit, ux, uy, uz, nudge, eps_arrive, s);
  }
  if (f == 0) walk_out(s, q, out_ic, out_rp, out_steps, out_status);
}

template <typename T>
int lanes_launch(const T* table, int n_rows, int W, int nf, const T* r0,
                 const T* r1, const int* ic0, int n_queries, T nudge,
                 T eps_arrive, T big, T tiny, int max_steps, int threads,
                 int* out_ic, T* out_rp, int* out_steps, int* out_status,
                 void* stream) {
  if (n_queries <= 0) return (int)cudaSuccess;
  if (n_rows <= 0 || W < 5 * nf || threads % 32 != 0 || threads < 32 ||
      threads > 1024) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_threads = (long long)n_queries * kWalkLanes;
  const int blocks = (int)((n_threads + threads - 1) / threads);
#define IU_LANES(NF_)                                                       \
  walk_lanes_kernel<NF_, T><<<blocks, threads, 0, s>>>(                     \
      table, n_rows, W, r0, r1, ic0, n_queries, nudge, eps_arrive,          \
      big, tiny, max_steps, out_ic, out_rp, out_steps, out_status)
  if (nf == 3) {
    IU_LANES(3);
  } else if (nf == 4) {
    IU_LANES(4);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef IU_LANES
  return (int)cudaGetLastError();
}

}  // namespace

// table: (n_rows, W) walk rows; r0, u, out_rp: (B, 3); total: (B,);
// active0: (B,) bool; ic0: (B,) int32; mask: (n_rows,) int32 or null;
// nf: 3 or 4.  Returns the cudaError_t of the launch.
extern "C" int walk_parent(const float* table, int n_rows, int W, int nf,
                           const float* r0, const float* u,
                           const float* total, const unsigned char* active0,
                           const int* ic0, const int* mask, int n_queries,
                           float nudge, float eps_arrive, float big,
                           int max_steps, int* out_ic, float* out_rp,
                           int* out_steps, int* out_status, void* stream) {
  return parent_launch<float>(table, n_rows, W, nf, r0, u, total, active0,
                              ic0, mask, n_queries, nudge, eps_arrive, big,
                            max_steps, out_ic, out_rp, out_steps, out_status,
                            stream);
}

extern "C" int walk_parent_f64(const double* table, int n_rows, int W,
                               int nf, const double* r0, const double* u,
                               const double* total,
                               const unsigned char* active0, const int* ic0,
                               const int* mask, int n_queries, double nudge,
                               double eps_arrive, double big, int max_steps,
                               int* out_ic, double* out_rp, int* out_steps,
                               int* out_status, void* stream) {
  return parent_launch<double>(table, n_rows, W, nf, r0, u, total, active0,
                             ic0, mask, n_queries, nudge, eps_arrive, big,
                             max_steps, out_ic, out_rp, out_steps, out_status,
                             stream);
}

// The four-lane design: r0, r1, out_rp (B, 3); ic0 (B,) int32; no mask;
// threads: a block's threads (four a walk).
extern "C" int walk_lanes(const float* table, int n_rows, int W, int nf,
                          const float* r0, const float* r1, const int* ic0,
                          int n_queries, float nudge, float eps_arrive,
                          float big, float tiny, int max_steps, int threads,
                          int* out_ic, float* out_rp, int* out_steps,
                          int* out_status, void* stream) {
  return lanes_launch<float>(table, n_rows, W, nf, r0, r1, ic0, n_queries,
                             nudge, eps_arrive, big, tiny, max_steps, threads,
                             out_ic, out_rp, out_steps, out_status, stream);
}

extern "C" int walk_lanes_f64(const double* table, int n_rows, int W, int nf,
                              const double* r0, const double* r1,
                              const int* ic0, int n_queries, double nudge,
                              double eps_arrive, double big, double tiny,
                              int max_steps, int threads, int* out_ic,
                              double* out_rp, int* out_steps, int* out_status,
                              void* stream) {
  return lanes_launch<double>(table, n_rows, W, nf, r0, r1, ic0, n_queries,
                              nudge, eps_arrive, big, tiny, max_steps,
                              threads, out_ic, out_rp, out_steps, out_status,
                              stream);
}

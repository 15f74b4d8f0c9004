// One neighbor-walk round for one query: exit-face selection and the
// state update (the core of kernel B3, csrc/walk.cu, and of the tracer's
// fused round, which includes this header).
//
// Port of the JAX package's ops/pallas_walk.py:_face_round and the round
// body of its _kernel.  A walk row starts with the cell's face normals
// (NF*3, column f*3 + d), face offsets (NF) and neighbor ids as floats
// (NF); only those NF*5 leading floats are read.  Every sum of three
// products is taken as (x + y) + z, as the plain PyTorch version
// (ops/walk_kernel.py:walk_plain) computes it; build with --fmad=false so
// that nothing is contracted into an FMA.  T is the walk rows' type:
// float, or double for a float64 grid (the tracer's kernel, float32
// only, takes float).
#pragma once

namespace iu {

constexpr int kStatusArrived = 0;
constexpr int kStatusBoundary = -1;
constexpr int kStatusMaskChanged = 1;
constexpr int kStatusStepCap = 2;

// Per-query walk state kept in registers across rounds.
template <typename T>
struct WalkState {
  T px, py, pz;      // current position r_p
  T dist_left;       // distance left to the target along u
  int ic;            // current cell
  int prev;          // cell left by the last continuing hop (-1: none)
  int status;        // kStatus* code of the last round
  int steps;         // rounds this query was active in
  bool active;       // still walking
};

// Exit face along u from p: the least distance to a face plane among
// faces with path . n > 0, tracked with the runner-up in one pass
// (strict <, so the first of equal distances wins).  When the best face
// leads straight back to `prev` (float rounding at a grazing face), the
// runner-up is taken instead (ops/locate.py:253-266 of the JAX package).
// Returns the distance clamped at 0 and the neighbor across that face;
// *hit is false when no face had path . n > 0.
template <int NF, typename T>
__device__ __forceinline__ T face_round(const T* __restrict__ row, T ux, T uy,
                                        T uz, T px, T py, T pz, int prev,
                                        T big, int* ic_next, bool* hit) {
  T d1 = big, d2 = big;
  int n1 = -1, n2 = -1;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const T nx = row[f * 3 + 0];
    const T ny = row[f * 3 + 1];
    const T nz = row[f * 3 + 2];
    const T off = row[NF * 3 + f];
    const int nbr = (int)row[NF * 4 + f];
    const T pdn = (nx * ux + ny * uy) + nz * uz;
    const T rpn = (nx * px + ny * py) + nz * pz;
    const T dist = pdn > T(0) ? (off - rpn) / pdn : big;
    if (dist < d1) {
      d2 = d1;
      n2 = n1;
      d1 = dist;
      n1 = nbr;
    } else if (dist < d2) {
      d2 = dist;
      n2 = nbr;
    }
  }
  const bool backtrack = (n1 == prev) && (prev >= 0);
  T face_dist = backtrack ? d2 : d1;
  *ic_next = backtrack ? n2 : n1;
  *hit = face_dist < T(0.5) * big;
  return face_dist < T(0) ? T(0) : face_dist;  // never step backwards
}

// Row index clamped into [0, n_rows), as an XLA gather clamps it.
__device__ __forceinline__ int clamp_row(int ic, int n_rows) {
  return ic < 0 ? 0 : (ic >= n_rows ? n_rows - 1 : ic);
}

// One round for an active query on the row of its current cell (in
// device memory or in registers): hop across the exit face, or arrive,
// or leave the domain (status and position as the JAX kernel sets them).
// With a per-cell mask column (mask != nullptr), a hop into a cell whose
// value differs from mask0, the start cell's, stops on the face in that
// cell with kStatusMaskChanged (the JAX package's ops/locate.py:279-308).
template <int NF, typename T>
__device__ __forceinline__ void walk_round_row(const T* row, T ux, T uy, T uz,
                                               T nudge, T eps_arrive, T big,
                                               const int* __restrict__ mask,
                                               int mask0, WalkState<T>& s) {
  int ic_next;
  bool hit;
  const T face_dist = face_round<NF>(row, ux, uy, uz, s.px, s.py, s.pz,
                                     s.prev, big, &ic_next, &hit);
  // Arrival is eps-tolerant: a target within eps_arrive past the exit
  // face still counts as arrived in the current cell.
  const bool crossing = hit && (s.dist_left - face_dist > eps_arrive);
  const bool out_of_domain = ic_next < 0;
  const bool mask_changed = mask != nullptr && crossing && !out_of_domain &&
                            mask[ic_next] != mask0;
  const bool continuing = crossing && !out_of_domain && !mask_changed;
  // Continuing hops overshoot the face by `nudge`; terminating hops stay
  // exactly on it.  No face hit: stay put.
  const T advance = face_dist + (continuing ? nudge : T(0));
  if (hit) {
    s.px = s.px + advance * ux;
    s.py = s.py + advance * uy;
    s.pz = s.pz + advance * uz;
    s.dist_left = s.dist_left - advance;
  }
  s.status = (crossing && out_of_domain)
                 ? kStatusBoundary
                 : (mask_changed ? kStatusMaskChanged : kStatusArrived);
  if (continuing) s.prev = s.ic;
  if (crossing) s.ic = ic_next;
  s.steps += 1;
  s.active = continuing;
}

// walk_round_row on the table row of the current cell, read in place.
template <int NF, typename T>
__device__ __forceinline__ void walk_round(const T* __restrict__ table,
                                           int n_rows, int W, T ux, T uy,
                                           T uz, T nudge, T eps_arrive, T big,
                                           const int* __restrict__ mask,
                                           int mask0, WalkState<T>& s) {
  walk_round_row<NF>(table + (size_t)clamp_row(s.ic, n_rows) * W, ux, uy, uz,
                     nudge, eps_arrive, big, mask, mask0, s);
}

}  // namespace iu

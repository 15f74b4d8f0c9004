// Per-cell interpolation weight formulas, one definition for every
// CUDA kernel of the port (brute-force interpolate, candidate-row
// probe, the tracer), templated on the scalar type T: float, or double
// for a float64 grid.
//
// Operation for operation the same as ops/wkern.py (which ports the JAX
// package's ops/wkern.py): triangle m_interp_unstructured.f90:529-551,
// tetra :553-586, quad :588-641.  The library is built with
// --fmad=false, so every product and sum rounds on its own, in the
// same order as the torch plain versions; an edit here is an edit
// there.
#pragma once

namespace iu {

__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }
__device__ __forceinline__ float abs_t(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_t(double x) { return fabs(x); }
__device__ __forceinline__ float max_t(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double max_t(double a, double b) {
  return fmax(a, b);
}

// The quad weights' relative threshold, 8 * the type's machine epsilon
// (ops/wkern.py:Plain.rel_eps).
template <typename T>
__host__ __device__ constexpr T quad_rel_eps();
template <>
__host__ __device__ constexpr float quad_rel_eps<float>() {
  return 8.0f * 1.1920928955078125e-07f;
}
template <>
__host__ __device__ constexpr double quad_rel_eps<double>() {
  return 8.0 * 2.220446049250313e-16;
}

template <typename T>
__device__ __forceinline__ void cross_c(T ax, T ay, T az, T bx, T by, T bz,
                                        T& cx, T& cy, T& cz) {
  cx = ay * bz - az * by;
  cy = az * bx - ax * bz;
  cz = ax * by - ay * bx;
}

template <typename T>
__device__ __forceinline__ T dot3_c(T ax, T ay, T az, T bx, T by, T bz) {
  return (ax * bx + ay * by) + az * bz;
}

// Twice the opposite sub-triangle areas |cross(q - v_j, q - v_k)| for
// (j, k) = (1,2), (2,0), (0,1); callers normalize by the cell area.
template <typename T>
__device__ __forceinline__ void triangle_areas2(const T v[][3], const T q[3],
                                                T out[3]) {
  const int jj[3] = {1, 2, 0};
  const int kk[3] = {2, 0, 1};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int j = jj[i], k = kk[i];
    T ex = q[0] - v[j][0], ey = q[1] - v[j][1], ez = q[2] - v[j][2];
    T fx = q[0] - v[k][0], fy = q[1] - v[k][1], fz = q[2] - v[k][2];
    T cx, cy, cz;
    cross_c(ex, ey, ez, fx, fy, fz, cx, cy, cz);
    out[i] = sqrt_t(dot3_c(cx, cy, cz, cx, cy, cz));
  }
}

// Signed scalar triple products; callers divide by 6 * volume.
template <typename T>
__device__ __forceinline__ void tetra_triples(const T v[][3], const T q[3],
                                              T out[4]) {
  T v1r[3], v2r[3], e13[3], e12[3], e02[3], e03[3], e01[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    v1r[d] = q[d] - v[0][d];
    v2r[d] = q[d] - v[1][d];
    e13[d] = v[3][d] - v[1][d];
    e12[d] = v[2][d] - v[1][d];
    e02[d] = v[2][d] - v[0][d];
    e03[d] = v[3][d] - v[0][d];
    e01[d] = v[1][d] - v[0][d];
  }
  T cx, cy, cz;
  cross_c(e13[0], e13[1], e13[2], e12[0], e12[1], e12[2], cx, cy, cz);
  out[0] = dot3_c(v2r[0], v2r[1], v2r[2], cx, cy, cz);
  cross_c(e02[0], e02[1], e02[2], e03[0], e03[1], e03[2], cx, cy, cz);
  out[1] = dot3_c(v1r[0], v1r[1], v1r[2], cx, cy, cz);
  cross_c(e03[0], e03[1], e03[2], e01[0], e01[1], e01[2], cx, cy, cz);
  out[2] = dot3_c(v1r[0], v1r[1], v1r[2], cx, cy, cz);
  cross_c(e01[0], e01[1], e01[2], e02[0], e02[1], e02[2], cx, cy, cz);
  out[3] = dot3_c(v1r[0], v1r[1], v1r[2], cx, cy, cz);
}

// Inverse-bilinear quad weights, branch-free (see quad_weights_generic
// in ops/wkern.py for the derivation).  v in the reference's
// (1,2)-(4,3) vertex order; rel_eps = quad_rel_eps<T>().
template <typename T>
__device__ __forceinline__ void quad_weights(const T v[][3], const T q[3],
                                             T rel_eps, T out[4]) {
  T qv[3], b1[3], b2[3], b3[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    qv[d] = q[d] - v[0][d];
    b1[d] = v[1][d] - v[0][d];
    b2[d] = v[3][d] - v[0][d];
    b3[d] = ((v[0][d] - v[1][d]) - v[3][d]) + v[2][d];
  }
  const T qa = b2[0] * b3[1] - b2[1] * b3[0];
  const T qb = (b3[0] * qv[1] - b3[1] * qv[0]) -
               (b1[0] * b2[1] - b1[1] * b2[0]);
  const T qc = b1[0] * qv[1] - b1[1] * qv[0];
  const T disc = qb * qb - T(4) * (qa * qc);
  const T root = sqrt_t(disc < T(0) ? T(0) : disc);

  const bool pos = qb >= T(0);
  const T qq = T(-0.5) * (qb + (pos ? root : -root));
  const bool tiny_qa = abs_t(qa) <= rel_eps * abs_t(qb);
  const bool linear = pos && tiny_qa;
  const T qa_safe = tiny_qa ? T(1) : qa;
  const T qb_safe = !(abs_t(qb) > T(0)) ? T(1) : qb;
  const T qq_safe = (qq == T(0)) ? T(1) : qq;
  const T mu = linear ? (-qc) / qb_safe : (pos ? qq / qa_safe : qc / qq_safe);

  T d3[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) d3[d] = b1[d] + mu * b3[d];
  const T a0 = abs_t(d3[0]), a1 = abs_t(d3[1]), a2 = abs_t(d3[2]);
  // First-occurrence maxloc over the 3 components (:628-632)
  const bool use0 = a0 >= a1;
  const T d01 = use0 ? d3[0] : d3[1];
  const T q01 = use0 ? qv[0] : qv[1];
  const T b01 = use0 ? b2[0] : b2[1];
  const bool use01 = max_t(a0, a1) >= a2;
  T dd = use01 ? d01 : d3[2];
  const T qd = use01 ? q01 : qv[2];
  const T bd = use01 ? b01 : b2[2];
  dd = (dd == T(0)) ? T(1) : dd;
  const T lam = (qd - bd * mu) / dd;

  const T il = T(1) - lam;
  const T im = T(1) - mu;
  out[0] = il * im;
  out[1] = lam * im;
  out[2] = lam * mu;
  out[3] = il * mu;
}

}  // namespace iu

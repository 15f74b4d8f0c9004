// Per-cell interpolation weight formulas, one definition for every
// CUDA kernel of the port (brute-force interpolate, candidate-row
// probe, and later the walk and tracer kernels).
//
// Operation for operation the same as ops/wkern.py (which ports the JAX
// package's ops/wkern.py): triangle m_interp_unstructured.f90:529-551,
// tetra :553-586, quad :588-641.  The library is built with
// --fmad=false, so every product and sum rounds on its own, in the
// same order as the torch plain versions; an edit here is an edit
// there.
#pragma once

namespace iu {

__device__ __forceinline__ void cross_c(float ax, float ay, float az,
                                        float bx, float by, float bz,
                                        float& cx, float& cy, float& cz) {
  cx = ay * bz - az * by;
  cy = az * bx - ax * bz;
  cz = ax * by - ay * bx;
}

__device__ __forceinline__ float dot3_c(float ax, float ay, float az,
                                        float bx, float by, float bz) {
  return (ax * bx + ay * by) + az * bz;
}

// Twice the opposite sub-triangle areas |cross(q - v_j, q - v_k)| for
// (j, k) = (1,2), (2,0), (0,1); callers normalize by the cell area.
__device__ __forceinline__ void triangle_areas2(const float v[][3],
                                                const float q[3],
                                                float out[3]) {
  const int jj[3] = {1, 2, 0};
  const int kk[3] = {2, 0, 1};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int j = jj[i], k = kk[i];
    float ex = q[0] - v[j][0], ey = q[1] - v[j][1], ez = q[2] - v[j][2];
    float fx = q[0] - v[k][0], fy = q[1] - v[k][1], fz = q[2] - v[k][2];
    float cx, cy, cz;
    cross_c(ex, ey, ez, fx, fy, fz, cx, cy, cz);
    out[i] = sqrtf(dot3_c(cx, cy, cz, cx, cy, cz));
  }
}

// Signed scalar triple products; callers divide by 6 * volume.
__device__ __forceinline__ void tetra_triples(const float v[][3],
                                              const float q[3],
                                              float out[4]) {
  float v1r[3], v2r[3], e13[3], e12[3], e02[3], e03[3], e01[3];
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
  float cx, cy, cz;
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
// (1,2)-(4,3) vertex order; rel_eps = 8 * FLT_EPSILON.
__device__ __forceinline__ void quad_weights(const float v[][3],
                                             const float q[3],
                                             float rel_eps, float out[4]) {
  float qv[3], b1[3], b2[3], b3[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    qv[d] = q[d] - v[0][d];
    b1[d] = v[1][d] - v[0][d];
    b2[d] = v[3][d] - v[0][d];
    b3[d] = ((v[0][d] - v[1][d]) - v[3][d]) + v[2][d];
  }
  const float qa = b2[0] * b3[1] - b2[1] * b3[0];
  const float qb = (b3[0] * qv[1] - b3[1] * qv[0]) -
                   (b1[0] * b2[1] - b1[1] * b2[0]);
  const float qc = b1[0] * qv[1] - b1[1] * qv[0];
  const float disc = qb * qb - 4.0f * (qa * qc);
  const float root = sqrtf(disc < 0.0f ? 0.0f : disc);

  const bool pos = qb >= 0.0f;
  const float qq = -0.5f * (qb + (pos ? root : -root));
  const bool tiny_qa = fabsf(qa) <= rel_eps * fabsf(qb);
  const bool linear = pos && tiny_qa;
  const float qa_safe = tiny_qa ? 1.0f : qa;
  const float qb_safe = !(fabsf(qb) > 0.0f) ? 1.0f : qb;
  const float qq_safe = (qq == 0.0f) ? 1.0f : qq;
  const float mu = linear ? (-qc) / qb_safe
                          : (pos ? qq / qa_safe : qc / qq_safe);

  float d3[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) d3[d] = b1[d] + mu * b3[d];
  const float a0 = fabsf(d3[0]), a1 = fabsf(d3[1]), a2 = fabsf(d3[2]);
  // First-occurrence maxloc over the 3 components (:628-632)
  const bool use0 = a0 >= a1;
  const float d01 = use0 ? d3[0] : d3[1];
  const float q01 = use0 ? qv[0] : qv[1];
  const float b01 = use0 ? b2[0] : b2[1];
  const bool use01 = fmaxf(a0, a1) >= a2;
  float dd = use01 ? d01 : d3[2];
  const float qd = use01 ? q01 : qv[2];
  const float bd = use01 ? b01 : b2[2];
  dd = (dd == 0.0f) ? 1.0f : dd;
  const float lam = (qd - bd * mu) / dd;

  const float il = 1.0f - lam;
  const float im = 1.0f - mu;
  out[0] = il * im;
  out[1] = lam * im;
  out[2] = lam * mu;
  out[3] = il * mu;
}

}  // namespace iu

// Double-float (compensated float32) arithmetic for the accurate-mode
// kernels: B5 (interp_acc.cu) and the df-plane branch of B2
// (cand_rows.cu).
//
// Bit for bit the same as ops/df32.py (which ports the JAX package's
// ops/df32.py): a value is hi + lo with |lo| <= ulp(hi)/2, about 48
// significant bits.  The error-free transforms are exact only if every
// sum and product rounds on its own, so the library is built with
// --fmad=false and without fast math; division and sqrtf stay
// IEEE-rounded (nvcc's defaults).  The one fused operation is the
// explicit __fmaf_rn of two_prod (below).  An edit here is an edit
// there.
#pragma once

namespace iu {

struct df {
  float hi, lo;
};

__device__ __forceinline__ df df_make(float hi, float lo) {
  df r;
  r.hi = hi;
  r.lo = lo;
  return r;
}

__device__ __forceinline__ df two_sum(float a, float b) {
  const float s = a + b;
  const float bb = s - a;
  return df_make(s, (a - (s - bb)) + (b - bb));
}

__device__ __forceinline__ df quick_two_sum(float a, float b) {
  const float s = a + b;
  return df_make(s, b - (s - a));
}

// Error-free a * b: p = fl(a * b) and e = a * b - p.  The rounding
// error of a float32 product is itself a float32 (as long as nothing
// underflows), so one exact fused multiply-add returns it: 2 instructions
// where Dekker's split product takes 13.  The plain versions (ops/df32.py)
// and the JAX package keep Dekker's form: split each operand by a
// mantissa mask (the low 12 of 24 bits), so every partial product is
// exact, and sum the partial products minus p.  That sum is the same
// exact error, so both forms give the same bits as long as no partial
// product underflows below 2^-126 (tests/test_torch_fma_form.py holds
// the plain versions against the FMA form).  B2-df's probe
// (cand_rows.cu) shares this header, and so this product.
__device__ __forceinline__ df two_prod(float a, float b) {
  const float p = a * b;
  return df_make(p, __fmaf_rn(a, b, -p));
}

__device__ __forceinline__ df df_add(df x, df y) {
  df s = two_sum(x.hi, y.hi);
  const df t = two_sum(x.lo, y.lo);
  s = quick_two_sum(s.hi, s.lo + t.hi);
  return quick_two_sum(s.hi, s.lo + t.lo);
}

__device__ __forceinline__ df df_neg(df x) { return df_make(-x.hi, -x.lo); }

__device__ __forceinline__ df df_sub(df x, df y) { return df_add(x, df_neg(y)); }

__device__ __forceinline__ df df_mul(df x, df y) {
  const df p = two_prod(x.hi, y.hi);
  return quick_two_sum(p.hi, p.lo + (x.hi * y.lo + x.lo * y.hi));
}

__device__ __forceinline__ df df_div(df x, df y) {
  const float q1 = x.hi / y.hi;
  const df r = df_sub(x, df_mul(df_make(q1, 0.0f), y));
  const float q2 = (r.hi + r.lo) / (y.hi + y.lo);
  return quick_two_sum(q1, q2);
}

__device__ __forceinline__ df df_sqrt(df x) {
  const float s1 = sqrtf(x.hi);
  const bool pos = s1 > 0.0f;
  const float safe = pos ? s1 : 1.0f;
  const df r = df_sub(x, df_mul(df_make(s1, 0.0f), df_make(s1, 0.0f)));
  const float s2 = pos ? (r.hi + r.lo) / (2.0f * safe) : 0.0f;
  return quick_two_sum(s1, s2);
}

// df * exact float32 constant
__device__ __forceinline__ df df_scale(df x, float c) {
  return df_mul(x, df_make(c, 0.0f));
}

// the comparison proxy of ops/wkern.py's DF trait
__device__ __forceinline__ float df_val(df x) { return x.hi + x.lo; }

// 1 where c else a (guards divisions by vanishing values)
__device__ __forceinline__ df df_safe_one(bool c, df a) {
  return c ? df_make(1.0f, 0.0f) : a;
}

}  // namespace iu

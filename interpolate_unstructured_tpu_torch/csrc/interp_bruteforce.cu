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
// What bounds it on an H100: arithmetic.  B x C x nf plane evaluations
// (1M queries x 750 tets x 4 faces = 3e9, 5 flops each) against a few
// bytes of input and output per query.  The design therefore keeps the
// planes on chip and the loop dense: one thread per query, the face
// planes of a tile of cells staged in shared memory (every thread of a
// block reads the same plane, a broadcast), and the running best under
// strict > in ascending cell order, which is jnp.argmax's
// first-occurrence tie-break.  Only the winner's payload (vertices,
// volume, vertex values) is read, once per query, from global memory,
// where the whole table of at most a few hundred KB stays in L2.  The
// TPU's one-hot MXU gather and its transposed (3, B) layout are not
// carried over: queries are (B, 3) and values (B, V).
//
// Plain PyTorch version: ops/interp_kernel.py:interpolate_bruteforce_plain,
// whose rounding order this kernel follows (built with --fmad=false).

#include <cuda_runtime.h>

#include "wkern.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileCells = 128;

// cell_type: 0 triangle, 1 quad, 2 tetra.  nf == npc (3 or 4).
template <int NPC, int CT>
__global__ void interp_bruteforce_kernel(
    const float* __restrict__ planes,   // (C, NPC, 4): nx ny nz d
    const float* __restrict__ payload,  // (C, NPC*3 + 1 + NPC*V)
    const float* __restrict__ r,        // (B, 3)
    int n_queries, int n_cells, int n_vars, float eps,
    float* __restrict__ vals,           // (B, V)
    int* __restrict__ ic,               // (B,)
    unsigned char* __restrict__ found)  // (B,)
{
  __shared__ float s_planes[kTileCells * NPC * 4];

  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = q < n_queries;
  float rx = 0.0f, ry = 0.0f, rz = 0.0f;
  if (live) {
    rx = r[3 * q + 0];
    ry = r[3 * q + 1];
    rz = r[3 * q + 2];
  }

  float best_m = 0.0f;
  int best = -1;
  for (int c0 = 0; c0 < n_cells; c0 += kTileCells) {
    const int nc = min(kTileCells, n_cells - c0);
    __syncthreads();
    for (int i = threadIdx.x; i < nc * NPC * 4; i += blockDim.x) {
      s_planes[i] = planes[(size_t)c0 * NPC * 4 + i];
    }
    __syncthreads();
    if (live) {
      for (int c = 0; c < nc; ++c) {
        const float* p = s_planes + c * NPC * 4;
        float m = p[3] - ((p[0] * rx + p[1] * ry) + p[2] * rz);
#pragma unroll
        for (int f = 1; f < NPC; ++f) {
          const float* pf = p + 4 * f;
          const float mf = pf[3] - ((pf[0] * rx + pf[1] * ry) + pf[2] * rz);
          m = mf < m ? mf : m;
        }
        if (best < 0 || m > best_m) {
          best_m = m;
          best = c0 + c;
        }
      }
    }
  }
  if (!live) return;

  const bool is_found = best_m >= -eps;
  const int stride = NPC * 3 + 1 + NPC * n_vars;
  const float* g = payload + (size_t)best * stride;
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
    const float inv = 0.5f / g[9];
#pragma unroll
    for (int k = 0; k < 3; ++k) w[k] = a2[k] * inv;
  } else if constexpr (CT == 2) {
    float t[4];
    iu::tetra_triples(v, qr, t);
    const float inv = 1.0f / (6.0f * g[12]);
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = t[k] * inv;
  } else {
    float wq[4];
    iu::quad_weights(v, qr, 8.0f * 1.1920928955078125e-07f, wq);
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = wq[k];
  }

  const float* data = g + NPC * 3 + 1;
  for (int iv = 0; iv < n_vars; ++iv) {
    float acc = w[0] * data[iv];
#pragma unroll
    for (int k = 1; k < NPC; ++k) acc = acc + w[k] * data[k * n_vars + iv];
    vals[(size_t)q * n_vars + iv] = acc;
  }
  ic[q] = is_found ? best : -1;
  found[q] = is_found ? 1 : 0;
}

template <int NPC, int CT>
void launch(const float* planes, const float* payload, const float* r,
            int n_queries, int n_cells, int n_vars, float eps, float* vals,
            int* ic, unsigned char* found, cudaStream_t stream) {
  const int blocks = (n_queries + kThreads - 1) / kThreads;
  interp_bruteforce_kernel<NPC, CT><<<blocks, kThreads, 0, stream>>>(
      planes, payload, r, n_queries, n_cells, n_vars, eps, vals, ic, found);
}

}  // namespace

// Plain C entry point (bound with ctypes).  Returns the cudaError_t of
// the launch; cell_type 0 triangle, 1 quad, 2 tetra.
extern "C" int iu_interp_bruteforce(const float* planes, const float* payload,
                                    const float* r, int n_queries,
                                    int n_cells, int cell_type, int n_vars,
                                    float eps, float* vals, int* ic,
                                    unsigned char* found, void* stream) {
  if (n_queries <= 0) return (int)cudaSuccess;
  if (n_cells <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cell_type) {
    case 0:
      launch<3, 0>(planes, payload, r, n_queries, n_cells, n_vars, eps, vals,
                   ic, found, s);
      break;
    case 1:
      launch<4, 1>(planes, payload, r, n_queries, n_cells, n_vars, eps, vals,
                   ic, found, s);
      break;
    case 2:
      launch<4, 2>(planes, payload, r, n_queries, n_cells, n_vars, eps, vals,
                   ic, found, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* iu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Designs of kernel E1 (interpolation at known cells) that
// tools/e1_sweep.py times against the one the port keeps, on tetrahedra
// with one variable.  Built by the sweep alone into its own library;
// the port never loads it.
//
//   variant 0  the port's kernel (csrc/interp_icell.cu, included below)
//              at Q queries a thread and THREADS threads a block, Q in
//              {1, 2, 4}, THREADS in {128, 256};
//   variant 1  (a) the port's first design: the cell's vertices and
//              volume from the geometry segment of its 512-byte walk row
//              (column nf*5), then the vertex ids and data;
//   variant 2  (c) the vertices from the cell's cell_points row (48 B a
//              tet in float32, read as 16-byte vectors), the volume from
//              cell_volume, the vertex ids for the data;
//   variant 3  (d) the port's reading order with plain loads (ld.global)
//              in place of ld.global.nc for every table;
//   variant 4  (e) the port's reading order with each vertex's three
//              coordinates in one 8-byte (16-byte in double) and one
//              4-byte (8-byte) load, by the parity of its id;
//   variant 5  (f) the port's reading order with the streams marked as
//              such: the queries and cell ids read with ld.global.cs and
//              the values written with st.global.cs (evict first), so
//              that they leave the tables their L2 lines.
//
// Every variant computes the same weights in the same order (wkern.cuh,
// --fmad=false), so each is torch.equal to interpolate_at_icell_plain.

#include "../interpolate_unstructured_tpu_torch/csrc/interp_icell.cu"

namespace {

constexpr int kAltThreads = 256;

template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
};
template <>
struct Pair<double> {
  using type = double2;
};

template <bool NC, typename X>
__device__ __forceinline__ X ld(const X* p) {
  if constexpr (NC) {
    return __ldg(p);
  } else {
    return *p;
  }
}

// (a) the port's first kernel E1, tetra only: geo points at walk row 0's
// column nf*5, rows W elements apart.
template <typename T>
__global__ void __launch_bounds__(kAltThreads)
    walk_row_kernel(const __grid_constant__ IcellArgs<T> a, const T* geo,
                    int W) {
  constexpr int NPC = 4;
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= a.n_queries) return;
  int c = __ldg(a.ic + q);
  c = c < 0 ? 0 : (c >= a.n_cells ? a.n_cells - 1 : c);
  const T* rq = a.r + 3 * (size_t)q;
  const T qr[3] = {__ldg(rq), __ldg(rq + 1), __ldg(rq + 2)};
  const T* g = geo + (size_t)c * W;
  T v[NPC][3];
#pragma unroll
  for (int k = 0; k < NPC; ++k) {
#pragma unroll
    for (int d = 0; d < 3; ++d) v[k][d] = __ldg(g + 3 * k + d);
  }
  T w[NPC];
  T t[4];
  iu::tetra_triples(v, qr, t);
  const T inv = T(1) / (T(6) * __ldg(g + NPC * 3));
#pragma unroll
  for (int k = 0; k < 4; ++k) w[k] = t[k] * inv;
  size_t row[NPC];
#pragma unroll
  for (int k = 0; k < NPC; ++k) {
    row[k] = (size_t)__ldg(a.cells + (size_t)c * NPC + k) * a.pd_stride;
  }
  T* out = a.vals + (size_t)q * a.out_stride;
  for (int iv = 0; iv < a.vars.n; ++iv) {
    const T* pd = a.point_data + a.vars.s[iv];
    T acc = w[0] * __ldg(pd + row[0]);
#pragma unroll
    for (int k = 1; k < NPC; ++k) acc = acc + w[k] * __ldg(pd + row[k]);
    out[iv] = acc;
  }
}

// Variants 2-5, tetra only, one query a thread.  GEO 2: vertices from
// the cell_points rows at geo (12 values a cell); GEO 3: from points,
// one load a coordinate; GEO 4: from points, a pair and a single.  NC:
// ld.global.nc (else plain loads).  CS: the queries, cell ids and values
// with the evict-first hints ld.global.cs / st.global.cs.
template <int GEO, bool NC, bool CS, typename T>
__global__ void __launch_bounds__(kAltThreads)
    alt_kernel(const __grid_constant__ IcellArgs<T> a, const T* geo) {
  constexpr int NPC = 4;
  using P2 = typename Pair<T>::type;
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= a.n_queries) return;
  int c = CS ? __ldcs(a.ic + q) : ld<NC>(a.ic + q);
  c = c < 0 ? 0 : (c >= a.n_cells ? a.n_cells - 1 : c);
  const int4 ids = ld<NC>(reinterpret_cast<const int4*>(a.cells) + c);
  const int id[NPC] = {ids.x, ids.y, ids.z, ids.w};
  const T vol = ld<NC>(a.cell_volume + c);
  const T* rq = a.r + 3 * (size_t)q;
  T qr[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) qr[d] = CS ? __ldcs(rq + d) : ld<NC>(rq + d);
  T v[NPC][3];
  if constexpr (GEO == 2) {
    // a tet's 12 values are 48 B (96 B in double): 16-byte vectors
    T flat[12];
    if constexpr (sizeof(T) == 4) {
      const float4* row4 =
          reinterpret_cast<const float4*>(geo + (size_t)c * 12);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float4 x = ld<NC>(row4 + i);
        flat[4 * i] = x.x;
        flat[4 * i + 1] = x.y;
        flat[4 * i + 2] = x.z;
        flat[4 * i + 3] = x.w;
      }
    } else {
      const P2* row = reinterpret_cast<const P2*>(geo + (size_t)c * 12);
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const P2 x = ld<NC>(row + i);
        flat[2 * i] = x.x;
        flat[2 * i + 1] = x.y;
      }
    }
#pragma unroll
    for (int k = 0; k < NPC; ++k) {
#pragma unroll
      for (int d = 0; d < 3; ++d) v[k][d] = flat[3 * k + d];
    }
  } else if constexpr (GEO == 3) {
#pragma unroll
    for (int k = 0; k < NPC; ++k) {
      const T* p = a.points + 3 * (size_t)id[k];
#pragma unroll
      for (int d = 0; d < 3; ++d) v[k][d] = ld<NC>(p + d);
    }
  } else {
#pragma unroll
    for (int k = 0; k < NPC; ++k) {
      // an even id's row starts on a pair boundary: (x, y) then z; an
      // odd one's ends on it: x then (y, z)
      const bool odd = id[k] & 1;
      const T* p = a.points + 3 * (size_t)id[k];
      const P2 two = ld<NC>(reinterpret_cast<const P2*>(p + (odd ? 1 : 0)));
      const T one = ld<NC>(p + (odd ? 0 : 2));
      v[k][0] = odd ? one : two.x;
      v[k][1] = odd ? two.x : two.y;
      v[k][2] = odd ? two.y : one;
    }
  }
  T w[NPC];
  T t[4];
  iu::tetra_triples(v, qr, t);
  const T inv = T(1) / (T(6) * vol);
#pragma unroll
  for (int k = 0; k < 4; ++k) w[k] = t[k] * inv;
  T* out = a.vals + (size_t)q * a.out_stride;
  for (int iv = 0; iv < a.vars.n; ++iv) {
    const T* pd = a.point_data + a.vars.s[iv];
    T acc = w[0] * ld<NC>(pd + (size_t)id[0] * a.pd_stride);
#pragma unroll
    for (int k = 1; k < NPC; ++k) {
      acc = acc + w[k] * ld<NC>(pd + (size_t)id[k] * a.pd_stride);
    }
    if constexpr (CS) {
      __stcs(out + iv, acc);
    } else {
      out[iv] = acc;
    }
  }
}

template <int Q, int THREADS, typename T>
void launch_kept(const IcellArgs<T>& a, cudaStream_t s) {
  const int blocks = (a.n_queries + THREADS * Q - 1) / (THREADS * Q);
  icell_kernel<4, 2, Q, THREADS, T><<<blocks, THREADS, 0, s>>>(a);
}

template <typename T>
int sweep(int variant, int q, int threads, const T* points, const int* cells,
          const T* cell_volume, const T* geo, int W, int n_cells,
          const T* point_data, int pd_stride, int slot, const T* r,
          const int* ic, int n_queries, T* vals, void* stream) {
  if (n_queries <= 0) return (int)cudaSuccess;
  IcellArgs<T> a;
  int code = icell_args(points, cells, cell_volume, n_cells, point_data,
                        pd_stride, &slot, 1, r, ic, n_queries, vals, 1, &a);
  if (code != (int)cudaSuccess) return code;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (n_queries + kAltThreads - 1) / kAltThreads;
  switch (variant) {
    case 0: {
      const int key = q * 1000 + threads;
      if (key == 1128) launch_kept<1, 128, T>(a, s);
      else if (key == 1256) launch_kept<1, 256, T>(a, s);
      else if (key == 2128) launch_kept<2, 128, T>(a, s);
      else if (key == 2256) launch_kept<2, 256, T>(a, s);
      else if (key == 4128) launch_kept<4, 128, T>(a, s);
      else if (key == 4256) launch_kept<4, 256, T>(a, s);
      else return (int)cudaErrorInvalidValue;
      break;
    }
    case 1:
      walk_row_kernel<T><<<blocks, kAltThreads, 0, s>>>(a, geo, W);
      break;
    case 2:
      alt_kernel<2, true, false, T><<<blocks, kAltThreads, 0, s>>>(a, geo);
      break;
    case 3:
      alt_kernel<3, false, false, T><<<blocks, kAltThreads, 0, s>>>(a, geo);
      break;
    case 4:
      alt_kernel<4, true, false, T><<<blocks, kAltThreads, 0, s>>>(a, geo);
      break;
    case 5:
      alt_kernel<3, true, true, T><<<blocks, kAltThreads, 0, s>>>(a, geo);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// One launch of variant `variant` on tetrahedra, one variable (`slot`),
// output (B, 1).  geo: walk row 0's column nf*5 (variant 1, rows W
// elements apart) or cell_points (variant 2, 16-byte aligned); q and
// threads: variant 0's queries a thread and threads a block.
extern "C" int e1_sweep(int variant, int q, int threads, const float* points,
                        const int* cells, const float* cell_volume,
                        const float* geo, int W, int n_cells,
                        const float* point_data, int pd_stride, int slot,
                        const float* r, const int* ic, int n_queries,
                        float* vals, void* stream) {
  return sweep<float>(variant, q, threads, points, cells, cell_volume, geo, W,
                      n_cells, point_data, pd_stride, slot, r, ic, n_queries,
                      vals, stream);
}

extern "C" int e1_sweep_f64(int variant, int q, int threads,
                            const double* points, const int* cells,
                            const double* cell_volume, const double* geo,
                            int W, int n_cells, const double* point_data,
                            int pd_stride, int slot, const double* r,
                            const int* ic, int n_queries, double* vals,
                            void* stream) {
  return sweep<double>(variant, q, threads, points, cells, cell_volume, geo,
                       W, n_cells, point_data, pd_stride, slot, r, ic,
                       n_queries, vals, stream);
}

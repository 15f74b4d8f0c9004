// Uniform-bin arithmetic shared by the kernels that locate a query's bin
// themselves: the seed bins of get_cell's walk (csrc/walk.cu) and the
// candidate bins of the bin-ordered probe (csrc/cand_rows.cu).  Each
// step is one operation in the grid's own type T (float, or double for
// a float64 grid), in the order of its plain PyTorch version
// (ops/geometry.py:bin_ijk, bin_flat and cand_bin_center_cols); build
// with --fmad=false.
#pragma once

namespace iu {

__device__ __forceinline__ float floor_t(float x) { return floorf(x); }
__device__ __forceinline__ double floor_t(double x) { return floor(x); }

// Bin coordinate of x on an axis of n bins: floor((x - rmin) * inv_h),
// clamped to [0, n - 1] (a NaN coordinate lands in bin 0).
template <typename T>
__device__ __forceinline__ int bin_coord(T x, T rmin, T inv_h, int n) {
  T t = floor_t((x - rmin) * inv_h);
  if (!(t >= T(0))) t = T(0);
  if (t > (T)(n - 1)) t = (T)(n - 1);
  return (int)t;
}

// Bin grid: origin and inverse bin sizes ((3,) on the device, in the
// grid's type) and the bin counts per axis; flat index
// (i * ny + j) * nz + k.
template <typename T>
struct BinGrid {
  const T* rmin;
  const T* inv_h;
  int nx, ny, nz;
};

template <typename T>
__device__ __forceinline__ void bin_ijk(const BinGrid<T>& g, T x, T y, T z,
                                        int& i, int& j, int& k) {
  i = bin_coord(x, g.rmin[0], g.inv_h[0], g.nx);
  j = bin_coord(y, g.rmin[1], g.inv_h[1], g.ny);
  k = bin_coord(z, g.rmin[2], g.inv_h[2], g.nz);
}

template <typename T>
__device__ __forceinline__ int bin_flat(const BinGrid<T>& g, int i, int j,
                                        int k) {
  return (i * g.ny + j) * g.nz + k;
}

// Center of bin coordinate i on axis d: rmin + (i + 0.5) * h with
// h = 1 / inv_h (an inactive axis, inv_h == 0, anchors at rmin).
template <typename T>
__device__ __forceinline__ T bin_center(const BinGrid<T>& g, int d, int i) {
  const T ih = g.inv_h[d];
  const T h = ih > T(0) ? T(1) / ih : T(0);
  return g.rmin[d] + ((T)i + T(0.5)) * h;
}

}  // namespace iu

// Uniform-bin arithmetic shared by the kernels that locate a query's bin
// themselves: the seed bins of get_cell's walk (csrc/walk.cu) and the
// candidate bins of the bin-ordered probe (csrc/cand_rows.cu).  Each
// step is one float32 operation in the order of its plain PyTorch
// version (ops/geometry.py:bin_ijk, bin_flat and cand_bin_center_cols);
// build with --fmad=false.
#pragma once

namespace iu {

// Bin coordinate of x on an axis of n bins: floor((x - rmin) * inv_h),
// clamped to [0, n - 1] (a NaN coordinate lands in bin 0).
__device__ __forceinline__ int bin_coord(float x, float rmin, float inv_h,
                                         int n) {
  float t = floorf((x - rmin) * inv_h);
  if (!(t >= 0.0f)) t = 0.0f;
  if (t > (float)(n - 1)) t = (float)(n - 1);
  return (int)t;
}

// Bin grid: origin and inverse bin sizes ((3,) float32 on the device)
// and the bin counts per axis; flat index (i * ny + j) * nz + k.
struct BinGrid {
  const float* rmin;
  const float* inv_h;
  int nx, ny, nz;
};

__device__ __forceinline__ void bin_ijk(const BinGrid& g, float x, float y,
                                        float z, int& i, int& j, int& k) {
  i = bin_coord(x, g.rmin[0], g.inv_h[0], g.nx);
  j = bin_coord(y, g.rmin[1], g.inv_h[1], g.ny);
  k = bin_coord(z, g.rmin[2], g.inv_h[2], g.nz);
}

__device__ __forceinline__ int bin_flat(const BinGrid& g, int i, int j,
                                        int k) {
  return (i * g.ny + j) * g.nz + k;
}

// Center of bin coordinate i on axis d: rmin + (i + 0.5) * h with
// h = 1 / inv_h (an inactive axis, inv_h == 0, anchors at rmin).
__device__ __forceinline__ float bin_center(const BinGrid& g, int d, int i) {
  const float ih = g.inv_h[d];
  const float h = ih > 0.0f ? 1.0f / ih : 0.0f;
  return g.rmin[d] + ((float)i + 0.5f) * h;
}

}  // namespace iu

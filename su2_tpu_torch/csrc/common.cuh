// Shared device helpers of the su2_tpu_torch kernels (T1-T4).
//
// One spline evaluator serves every kernel: the equispaced-grid bin lookup
// klo = clamp(int((clip(T) - t0)/dt) + 1, 1, nt - 1) of the reference's
// GetSpline (spline.cpp:66-74), with the tables read straight from global
// memory (they are a few hundred knots per species and stay in L1/L2).
// The arithmetic follows the plain torch version term by term:
// a*y[k-1] + b*y[k] + ((a^3 - a)*y2[k-1] + (b^3 - b)*y2[k]) * dt^2 / 6.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define SU2K_MAXS 16   // species
#define SU2K_MAXD 3    // space dimensions
#define SU2K_MAXR 8    // reactions

namespace su2k {

// Knot grid of the shared temperature tables; hsq = dt*dt is formed on the
// host in double, as the plain torch version does.
template <typename T>
struct Grid {
  T t0, dt, tmax, hsq;
  int nt;
};

template <typename T>
struct Bin {
  int klo;
  T a, b, a3, b3;
};

template <typename T>
__device__ __forceinline__ Bin<T> spline_bin(const Grid<T>& g, T t) {
  Bin<T> r;
  T tc = t < g.t0 ? g.t0 : (t > g.tmax ? g.tmax : t);
  int k = (int)((tc - g.t0) / g.dt) + 1;
  k = k < 1 ? 1 : (k > g.nt - 1 ? g.nt - 1 : k);
  T xk = g.t0 + (T)k * g.dt;
  r.klo = k;
  r.a = (xk - tc) / g.dt;
  r.b = (tc - (xk - g.dt)) / g.dt;
  r.a3 = r.a * r.a * r.a - r.a;
  r.b3 = r.b * r.b * r.b - r.b;
  return r;
}

// value of the spline of one table row (y, y2 point at the row start)
template <typename T>
__device__ __forceinline__ T spline_at(const Grid<T>& g, const Bin<T>& bn,
                                       const T* __restrict__ y,
                                       const T* __restrict__ y2) {
  int k = bn.klo;
  return bn.a * y[k - 1] + bn.b * y[k]
       + (bn.a3 * y2[k - 1] + bn.b3 * y2[k]) * g.hsq / (T)6;
}

template <typename T>
__device__ __forceinline__ T clip_y(T y) { return y < (T)0 ? (T)1e-30 : y; }

}  // namespace su2k

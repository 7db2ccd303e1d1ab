// K9: the TOTAL_CONDITIONS inlet temperature.  Per marker vertex it roots
//   f(T) = h_mix(T) + 0.5 vb(T)^2 - h_tot,
//   vb(T) = (riemann - 2 sqrt(gamma R T) / (gamma - 1)) / alpha,
// by a secant from T_tot (at most sec_iters steps, converged when
// |dT| < max(sec_tol, 4 eps |T_new|), keeping the last iterate) with a
// bisection fallback on [T_min, T_tot] (at most bis_iters steps, converged
// when |f| < bis_tol).  h_mix is the one combined spline table
// y = sum_s (Y_s / M_s) h_s of the marker's fixed composition, evaluated
// with the shared spline arithmetic of common.cuh.
//
// Replaces su2_tpu/pallas/inlet_tc.py:74 _solve_call (called from
// solvers/euler.py:266-281).  The TPU kernel runs the batch as lanes of
// one block and freezes converged lanes until the whole batch is done;
// here every vertex is a thread with its own exit, which gives each
// vertex the same result.  Built with -fmad=false (kernels.py), so the
// arithmetic is the plain version's operation for operation.
//
// Bound on the H100: the launch.  A marker has tens to hundreds of
// vertices (48 at 9,072 nodes, 377 at 565,500); the bytes and operations
// are a few microseconds' worth at most.  Design: one thread per vertex,
// the table (a few KB) read through L1.
#include <cfloat>

#include "common.cuh"

namespace su2k {

struct TCConsts {
  double rgas, htot, ttot, tmin, sec_tol, bis_tol;
  int sec_iters, bis_iters;
};

template <typename T>
__global__ void inlet_tc_kernel(int nv, TCConsts c, Grid<T> g,
                                const T* __restrict__ riemann,
                                const T* __restrict__ gamma,
                                const T* __restrict__ alpha,
                                const T* __restrict__ y,
                                const T* __restrict__ y2,
                                T* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nv) return;
  const T rm = riemann[i], ga = gamma[i], al = alpha[i];
  const T gm1 = ga - (T)1;
  const T rgas = (T)c.rgas, htot = (T)c.htot;
  const T eps4 = (T)4 * (sizeof(T) == 8 ? (T)DBL_EPSILON : (T)FLT_EPSILON);
  auto f_of = [&](T t) {
    T cb = sqrt(ga * rgas * t);
    T vb = (rm - (T)2 * cb / gm1) / al;
    return spline_at(g, spline_bin(g, t), y, y2) + (T)0.5 * vb * vb - htot;
  };
  T t = (T)c.ttot;
  T t_old = t + (T)1;
  T f_old = f_of(t_old);
  for (int it = 0; it < c.sec_iters; ++it) {
    T fv = f_of(t);
    T df = fv - f_old;
    T safe = df == (T)0 ? (T)1 : df;
    T t_new = t - fv * (t - t_old) / safe;
    T lim = eps4 * fabs(t_new);
    lim = lim > (T)c.sec_tol ? lim : (T)c.sec_tol;
    if (fabs(t_new - t) < lim) {
      out[i] = t;
      return;
    }
    t_old = t;
    f_old = fv;
    t = t_new;
  }
  T ta = (T)c.tmin, tb = (T)c.ttot;
  T tm = (T)0.5 * (ta + tb);
  for (int it = 0; it < c.bis_iters; ++it) {
    T tmid = (T)0.5 * (ta + tb);
    T fv = f_of(tmid);
    tm = tmid;
    if (fabs(fv) < (T)c.bis_tol) break;
    if (fv > (T)0) ta = tmid;
    else tb = tmid;
  }
  out[i] = tm;
}

template <typename T>
int launch_inlet_tc(int nv, const TCConsts& c, int nt, double t0, double dt,
                    const void* riemann, const void* gamma,
                    const void* alpha, const void* y, const void* y2,
                    void* out, void* stream) {
  Grid<T> g{(T)t0, (T)dt, (T)(t0 + (nt - 1) * dt), (T)(dt * dt), nt};
  int threads = 128;
  int blocks = (nv + threads - 1) / threads;
  if (blocks > 0)
    inlet_tc_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        nv, c, g, (const T*)riemann, (const T*)gamma, (const T*)alpha,
        (const T*)y, (const T*)y2, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace su2k

extern "C" int su2k_inlet_tc(int is_f64, int nv, int nt, double t0, double dt,
                             double rgas, double htot, double ttot,
                             double tmin, int sec_iters, double sec_tol,
                             int bis_iters, double bis_tol,
                             const void* riemann, const void* gamma,
                             const void* alpha, const void* y,
                             const void* y2, void* out, void* stream) {
  if (nt < 2 || sec_iters < 0 || bis_iters < 0)
    return (int)cudaErrorInvalidValue;
  su2k::TCConsts c{rgas, htot, ttot, tmin, sec_tol, bis_tol, sec_iters,
                   bis_iters};
  if (is_f64)
    return su2k::launch_inlet_tc<double>(nv, c, nt, t0, dt, riemann, gamma,
                                         alpha, y, y2, out, stream);
  return su2k::launch_inlet_tc<float>(nv, c, nt, t0, dt, riemann, gamma,
                                      alpha, y, y2, out, stream);
}

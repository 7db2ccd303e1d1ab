// T2: per-node preprocessing pass — Cons2Prim with the secant/bisection
// temperature solve, clipping and non-physical flags, dT/dU, dP/dU, Wilke
// viscosity, Wasilewska conductivity and mole fractions
// (variable_direct_reactive.cpp:325-561, :786-849,
// reacting_model_library.cpp:634-696).  The lite variant (turbulence
// phase) returns gamma - 1 instead of dT/dU, dP/dU and skips kappa.
//
// Replaces su2_tpu/pallas/node_state.py:183 cons2prim_fused (entry
// node_state :545).  The TPU kernel's one-hot MXU table contractions and
// its bf16 three-level table split are TPU workarounds and are not
// carried over: the spline knots are gathered from global memory.  The
// TPU kernel exits the secant per tile; here each thread exits its own
// secant, which gives the same per-node result.  The bisection runs
// TSolveParams.bisect_iters rounds, as the plain version does.
//
// Bound on the H100: bytes, by roofline.  A node reads nVar + 2 values and
// writes ~3 nVar + 2 S + 4 (~600 B in f64) against ~1.5 kFLOP (2-8
// enthalpy-spline evaluations in the secant, O(S^2) Wilke terms), under
// the card's ~10 FLOP/B f64 ridge.  At 9,072 nodes the launch has fewer
// blocks than the card has SMs, so latency, not either roof, sets the time.
// Design: one thread per node, node-major (N, nVar) in and out (each
// thread reads and writes its own rows), species arrays in registers /
// local memory for S <= 16, tables read through L1.
#include "common.cuh"

namespace su2k {

struct TSolve {
  double tmin, tmax, secant_tol, bisect_tol;
  int secant_iters, bisect_iters;
};

// table buffer rows, each nt long: h[S] h2[S] cp[S] cp2[S] mu[S] mu2[S]
// ka[S] ka2[S]; constant buffer: mm[S] ri[S] c_mass[S*S] c_den[S*S]
template <typename T>
struct Tabs {
  const T* tab;
  const T* cst;
  int ns;
  __device__ const T* row(int fam, int s, int nt) const {
    return tab + ((size_t)fam * ns + s) * nt;
  }
};

template <typename T>
__device__ T h_mix(const Grid<T>& g, const Tabs<T>& tb, const T* ysc,
                   const T* mm, T t) {
  Bin<T> bn = spline_bin(g, t);
  T acc = (T)0;
  for (int s = 0; s < tb.ns; ++s)
    acc += ysc[s] * (spline_at(g, bn, tb.row(0, s, g.nt),
                               tb.row(1, s, g.nt)) / mm[s]);
  return acc;
}

template <typename T, bool LITE>
__global__ void node_state_kernel(
    int n, int nd, int ns, Grid<T> g, TSolve tp, T eps4,
    const T* __restrict__ u, const T* __restrict__ t_guess,
    const T* __restrict__ tke, Tabs<T> tb, T* __restrict__ u_out,
    T* __restrict__ v_out, uint8_t* __restrict__ nonphys_out,
    T* __restrict__ dtdu_out, T* __restrict__ dpdu_out,
    T* __restrict__ gm1_out, T* __restrict__ mu_out,
    T* __restrict__ kappa_out, T* __restrict__ xs_out) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const T EPS = (T)1e-16;
  const int nvar = ns + nd + 2, nprim = ns + nd + 5;
  const int RHOE = 1 + nd, RHOS = 2 + nd;
  const T* mm = tb.cst;
  const T* ri = tb.cst + ns;
  const T* c_mass = tb.cst + 2 * ns;
  const T* c_den = c_mass + ns * ns;
  const T* up = u + (size_t)p * nvar;

  T rho_s[SU2K_MAXS], ys[SU2K_MAXS], ysc[SU2K_MAXS];
  bool nonphys = false;
  for (int s = 0; s < ns; ++s) {
    T r = up[RHOS + s];
    nonphys |= r < (T)0;
    rho_s[s] = r < (T)0 ? (T)1.0e-30 : r;
  }
  T rho = up[0];
  nonphys |= rho < EPS;
  rho = rho < EPS ? EPS : rho;
  T ysum = (T)0;
  for (int s = 0; s < ns; ++s) {
    ys[s] = rho_s[s] / rho;
    ysum += ys[s];
  }
  nonphys |= fabs(ysum - (T)1) > (T)0.1;
  T vel[SU2K_MAXD];
  T sqvel = (T)0;
  for (int d = 0; d < nd; ++d) {
    vel[d] = up[1 + d] / rho;
    sqvel += vel[d] * vel[d];
  }
  T rho_e = up[RHOE];
  if (tke != nullptr) rho_e = rho_e - rho * tke[p];
  T rgas = (T)0;
  for (int s = 0; s < ns; ++s) {
    ysc[s] = clip_y(ys[s]);
    rgas += ysc[s] * ri[s];
  }
  T c1 = (-rho_e + (T)0.5 * rho * sqvel) / (rho * rgas);
  T c2 = (T)1 / rgas;

  // secant seeded by the previous temperature (:398-432)
  T t = t_guess[p];
  T t_old = t + (T)1;
  T h_old = h_mix(g, tb, ysc, mm, t_old);
  bool done = false;
  for (int it = 0; it < tp.secant_iters && !done; ++it) {
    T f = t - c1 - c2 * h_mix(g, tb, ysc, mm, t);
    T f_old = t_old - c1 - c2 * h_old;
    T df = f - f_old;
    T t_new = df == (T)0 ? t : t - f * (t - t_old) / df;
    t_new = t_new < (T)-1.0e8 ? (T)-1.0e8 : (t_new > (T)1.0e8 ? (T)1.0e8
                                                                : t_new);
    T tol = eps4 * fabs(t_new);
    tol = tol < (T)tp.secant_tol ? (T)tp.secant_tol : tol;
    bool conv = fabs(t_new - t) < tol;
    h_old = (t - c1 - f) / c2;
    t_old = t;
    if (!conv) t = t_new;
    done = conv;
  }
  if (!done) {
    // bisection fallback on [Tmin, Tmax] (:433-502)
    T ta = (T)tp.tmin, tbb = (T)tp.tmax;
    T tbis = (T)0.5 * (ta + tbb);
    for (int it = 0; it < tp.bisect_iters; ++it) {
      T tm = (T)0.5 * (ta + tbb);
      T f = tm - c1 - c2 * h_mix(g, tb, ysc, mm, tm);
      tbis = tm;
      if (fabs(f) < (T)tp.bisect_tol || (tbb - ta) < eps4 * fabs(tm)) break;
      if (f > (T)0) ta = tm; else tbb = tm;
    }
    t = tbis;
  }
  nonphys |= (t < (T)tp.tmin) || (t > (T)tp.tmax);
  t = t < (T)tp.tmin ? (T)tp.tmin : (t > (T)tp.tmax ? (T)tp.tmax : t);
  T press = rho * rgas * t;
  nonphys |= press < EPS;
  press = press < EPS ? EPS : press;

  Bin<T> bn = spline_bin(g, t);
  T cp = (T)0;
  T e_s[SU2K_MAXS];
  for (int s = 0; s < ns; ++s) {
    cp += ysc[s] * (spline_at(g, bn, tb.row(2, s, g.nt), tb.row(3, s, g.nt))
                    / mm[s]);
    if (!LITE)
      e_s[s] = spline_at(g, bn, tb.row(0, s, g.nt), tb.row(1, s, g.nt))
               / mm[s] - ri[s] * t;
  }
  T gamma = cp / (cp - rgas);
  T sound = sqrt(gamma * press / rho);
  nonphys |= sound < EPS;
  sound = sound < EPS ? EPS : sound;
  T htot = (up[RHOE] + press) / rho;

  T* vp = v_out + (size_t)p * nprim;
  vp[0] = t;
  for (int d = 0; d < nd; ++d) vp[1 + d] = vel[d];
  vp[nd + 1] = press;
  vp[nd + 2] = rho;
  vp[nd + 3] = htot;
  vp[nd + 4] = sound;
  for (int s = 0; s < ns; ++s) vp[nd + 5 + s] = ys[s];
  T* uo = u_out + (size_t)p * nvar;
  uo[0] = rho;
  for (int k = 1; k < RHOS; ++k) uo[k] = up[k];
  for (int s = 0; s < ns; ++s) uo[RHOS + s] = rho_s[s];
  nonphys_out[p] = nonphys ? 1 : 0;

  if (LITE) {
    gm1_out[p] = gamma - (T)1;
  } else {
    T rho_cv = rho * (cp - rgas);
    T* a = dtdu_out + (size_t)p * nvar;
    a[0] = (T)0.5 * sqvel / rho_cv;
    for (int d = 0; d < nd; ++d) a[1 + d] = -vel[d] / rho_cv;
    a[RHOE] = (T)1 / rho_cv;
    for (int s = 0; s < ns; ++s) a[RHOS + s] = -e_s[s] / rho_cv;
    T* b = dpdu_out + (size_t)p * nvar;
    b[0] = (gamma - (T)1) * (T)0.5 * sqvel;
    for (int d = 0; d < nd; ++d) b[1 + d] = ((T)1 - gamma) * vel[d];
    b[RHOE] = gamma - (T)1;
    for (int s = 0; s < ns; ++s)
      b[RHOS + s] = ri[s] * t - (gamma - (T)1) * e_s[s];
  }

  // Wilke mixture viscosity (ComputeEta :634-663) and the Wasilewska-type
  // conductivity (ComputeLambda :670-696)
  T mu_s[SU2K_MAXS], sq[SU2K_MAXS], yom[SU2K_MAXS];
  for (int s = 0; s < ns; ++s) {
    mu_s[s] = spline_at(g, bn, tb.row(4, s, g.nt), tb.row(5, s, g.nt));
    sq[s] = sqrt(mu_s[s]);
    yom[s] = ysc[s] / mm[s];
  }
  T mu = (T)0, kappa = (T)0;
  for (int i = 0; i < ns; ++i) {
    T phi = (T)0, phik = (T)0;
    for (int j = 0; j < ns; ++j) {
      T num = (T)1 + sq[i] / sq[j] * c_mass[i * ns + j];
      T pair = num * num * c_den[i * ns + j];
      phi += pair * yom[j];
      if (!LITE && j != i) phik += (T)1.065 * pair * yom[j];
    }
    mu += mu_s[i] * yom[i] / phi;
    if (!LITE) {
      T ka = spline_at(g, bn, tb.row(6, i, g.nt), tb.row(7, i, g.nt));
      kappa += ka * yom[i] / (phik + yom[i]);
    }
  }
  mu_out[p] = mu;
  if (!LITE) kappa_out[p] = kappa;
  T ysum_c = (T)0, xsum = (T)0;
  for (int s = 0; s < ns; ++s) {
    ysum_c += ysc[s];
    xsum += yom[s];
  }
  T* xp = xs_out + (size_t)p * ns;
  for (int s = 0; s < ns; ++s) xp[s] = yom[s] * (ysum_c / xsum);
}

template <typename T>
int launch_node_state(int lite, int n, int nd, int ns, int nt, double t0,
                      double dt, TSolve tp, const void* u,
                      const void* t_guess, const void* tke, const void* tab,
                      const void* cst, void* u_out, void* v_out,
                      void* nonphys, void* dtdu, void* dpdu, void* gm1,
                      void* mu, void* kappa, void* xs, void* stream) {
  Grid<T> g{(T)t0, (T)dt, (T)(t0 + (nt - 1) * dt), (T)(dt * dt), nt};
  Tabs<T> tb{(const T*)tab, (const T*)cst, ns};
  T eps4 = (T)4 * (sizeof(T) == 8 ? (T)2.220446049250313e-16
                                  : (T)1.1920929e-07);
  int threads = 128;
  int blocks = (n + threads - 1) / threads;
  if (blocks == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (lite)
    node_state_kernel<T, true><<<blocks, threads, 0, st>>>(
        n, nd, ns, g, tp, eps4, (const T*)u, (const T*)t_guess,
        (const T*)tke, tb, (T*)u_out, (T*)v_out, (uint8_t*)nonphys, nullptr,
        nullptr, (T*)gm1, (T*)mu, nullptr, (T*)xs);
  else
    node_state_kernel<T, false><<<blocks, threads, 0, st>>>(
        n, nd, ns, g, tp, eps4, (const T*)u, (const T*)t_guess,
        (const T*)tke, tb, (T*)u_out, (T*)v_out, (uint8_t*)nonphys,
        (T*)dtdu, (T*)dpdu, nullptr, (T*)mu, (T*)kappa, (T*)xs);
  return (int)cudaGetLastError();
}

}  // namespace su2k

extern "C" int su2k_node_state(int is_f64, int lite, int n, int nd, int ns,
                               int nt, double t0, double dt, double tmin,
                               double tmax, int secant_iters,
                               double secant_tol, int bisect_iters,
                               double bisect_tol, const void* u,
                               const void* t_guess, const void* tke,
                               const void* tab, const void* cst, void* u_out,
                               void* v_out, void* nonphys, void* dtdu,
                               void* dpdu, void* gm1, void* mu, void* kappa,
                               void* xs, void* stream) {
  if (ns > SU2K_MAXS || nd > SU2K_MAXD) return (int)cudaErrorInvalidValue;
  su2k::TSolve tp{tmin, tmax, secant_tol, bisect_tol, secant_iters,
                  bisect_iters};
  if (is_f64)
    return su2k::launch_node_state<double>(
        lite, n, nd, ns, nt, t0, dt, tp, u, t_guess, tke, tab, cst, u_out,
        v_out, nonphys, dtdu, dpdu, gm1, mu, kappa, xs, stream);
  return su2k::launch_node_state<float>(
      lite, n, nd, ns, nt, t0, dt, tp, u, t_guess, tke, tab, cst, u_out,
      v_out, nonphys, dtdu, dpdu, gm1, mu, kappa, xs, stream);
}

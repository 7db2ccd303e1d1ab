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
// the card's ~10 FLOP/B f64 ridge.  Measured, it runs at ~6x that bound
// at 565,500 nodes and at ~0.06 ms a launch at 9,072 (one wave),
// little of it in the T solve; the same source built with approximate
// division and square root takes ~40 % of that time at 9,072 and 40-80 %
// at 565,500 (f32, PERF.md §6): the IEEE divisions (~250 a node) on each
// thread's dependent chain set most of it.
//
// Design: one thread per node.
// - The species count is a template constant (SU2K_NODE_STATE_BY_NS: the
//   9-species combustion chemistry and the 3-species air of the flat
//   plate), so every species array (rho_s, Y, clipped Y, e_s, mu_s,
//   sqrt(mu_s), Y/M) is indexed only in unrolled loops and stays in
//   registers; the velocity loops run unrolled to SU2K_MAXD under a
//   d < nd guard for the same reason.  With the count known only at run
//   time those arrays lived in local memory.  Every other count up to
//   SU2K_MAXS runs the run-time instance (NS = 0) of the same body, its
//   arrays all declared at kernel scope.
// - Each output row (v, u, dT/dU, dP/dU, X) is written by its thread into
//   a staging row in shared memory (odd stride: no bank conflicts) and
//   stored by the block as one contiguous span, so every store of a warp
//   is coalesced (a thread storing its own rows wrote one partial sector
//   per thread and value).  One staging row per thread, reused for each
//   output in turn: shared memory is taken from the L1 that caches the
//   spline tables, and staging the u rows and two outputs at once (three
//   rows per thread) ran no faster than the former kernel at 565,500
//   nodes.  The u rows are read in place (through L1: a row's values
//   share its sectors).
// - Blocks of SU2K_NS_THREADS = 128 threads (64 timed slower at 565,500
//   nodes on the H100, PERF.md §6).
// - The spline tables are read from global memory (L1/L2: a few hundred
//   knots per species); the per-node numerics (secant and its exit,
//   bisection, clipping, flags, summation orders) are those of the plain
//   version.
#include "common.cuh"

namespace su2k {

// the species counts T2 is compiled for (kernels.NODE_STATE_SPECIES): the
// 9-species combustion chemistry and the 3-species air of the flat plate;
// every other count up to SU2K_MAXS runs the run-time instance (NS = 0)
#define SU2K_NODE_STATE_BY_NS(X) X(9) X(3)
#define SU2K_NS_THREADS 128   // threads per block

struct TSolve {
  double tmin, tmax, secant_tol, bisect_tol;
  int secant_iters, bisect_iters;
  int clip;   // CLIPPING_TEMPRATURE: T within [0.95, 1.05] t_guess
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

template <typename T, int NS>
__device__ __forceinline__ T h_mix(const Grid<T>& g, const Tabs<T>& tb,
                                   int ns, const T* ysc,
                                   const T* __restrict__ mm, T t) {
  Bin<T> bn = spline_bin(g, t);
  T acc = (T)0;
  for_n<NS>(ns, [&](int s) {
    acc += ysc[s] * (spline_at(g, bn, tb.row(0, s, g.nt),
                               tb.row(1, s, g.nt)) / mm[s]);
  });
  return acc;
}

// the staging rows st (stride ws) into the rows [p0, p0 + cnt) of out
// (width w): one contiguous span, consecutive threads on consecutive
// addresses
template <typename T>
__device__ __forceinline__ void store_rows(const T* st, int ws, int w,
                                           T* __restrict__ out, int p0,
                                           int cnt) {
  T* d = out + (size_t)p0 * w;
  for (int e = threadIdx.x; e < cnt * w; e += blockDim.x) {
    const int r = e / w;
    d[e] = st[r * ws + (e - r * w)];
  }
}

// shared memory of a block: one staging row per thread
template <typename T>
size_t node_state_smem(int nd, int ns) {
  return (size_t)SU2K_NS_THREADS * ((ns + nd + 5) | 1) * sizeof(T);
}

// Every thread of the block runs to the end (the staging barriers); a
// thread past the last node computes its block's first node again and
// stores nothing.
template <typename T, int NS, bool LITE>
__global__ void __launch_bounds__(SU2K_NS_THREADS)
node_state_kernel(
    int n, int nd, int ns_rt, Grid<T> g, TSolve tp, T eps4,
    const T* __restrict__ u, const T* __restrict__ t_guess,
    const T* __restrict__ tke, Tabs<T> tb, T* __restrict__ u_out,
    T* __restrict__ v_out, uint8_t* __restrict__ nonphys_out,
    T* __restrict__ dtdu_out, T* __restrict__ dpdu_out,
    T* __restrict__ gm1_out, T* __restrict__ mu_out,
    T* __restrict__ kappa_out, T* __restrict__ xs_out) {
  constexpr int SA = NS > 0 ? NS : SU2K_MAXS;
  extern __shared__ __align__(16) unsigned char ns_smem[];
  const int ns = NS > 0 ? NS : ns_rt;
  const T EPS = (T)1e-16;
  const int nvar = ns + nd + 2, nprim = ns + nd + 5;
  const int RHOE = 1 + nd, RHOS = 2 + nd;
  const int ws = nprim | 1;                     // odd stride
  const int p0 = blockIdx.x * blockDim.x;
  const int cnt = min((int)blockDim.x, n - p0);
  const bool act = (int)threadIdx.x < cnt;
  const int p = p0 + (act ? (int)threadIdx.x : 0);
  T* st = reinterpret_cast<T*>(ns_smem);
  T* oa = st + (size_t)threadIdx.x * ws;        // this thread's row
  const T* mm = tb.cst;
  const T* ri = tb.cst + ns;
  const T* c_mass = tb.cst + 2 * ns;
  const T* c_den = c_mass + ns * ns;
  T rho_s[SA], ys[SA], ysc[SA], e_s[SA], mu_s[SA], sq[SA], yom[SA];
  T vel[SU2K_MAXD];

  const T* up = u + (size_t)p * nvar;

  bool nonphys = false;
  for_n<NS>(ns, [&](int s) {
    T r = up[RHOS + s];
    nonphys |= r < (T)0;
    rho_s[s] = r < (T)0 ? (T)1.0e-30 : r;
  });
  T rho = up[0];
  nonphys |= rho < EPS;
  rho = rho < EPS ? EPS : rho;
  T ysum = (T)0;
  for_n<NS>(ns, [&](int s) {
    ys[s] = rho_s[s] / rho;
    ysum += ys[s];
  });
  nonphys |= fabs(ysum - (T)1) > (T)0.1;
  T sqvel = (T)0;
#pragma unroll
  for (int d = 0; d < SU2K_MAXD; ++d) {
    vel[d] = (T)0;
    if (d < nd) {
      vel[d] = up[1 + d] / rho;
      sqvel += vel[d] * vel[d];
    }
  }
  T rho_e = up[RHOE];
  if (tke != nullptr) rho_e = rho_e - rho * tke[p];
  T rgas = (T)0;
  for_n<NS>(ns, [&](int s) {
    ysc[s] = clip_y(ys[s]);
    rgas += ysc[s] * ri[s];
  });
  // the v row's mass fractions, staged before the secant
  for_n<NS>(ns, [&](int s) { oa[nd + 5 + s] = ys[s]; });
  T c1 = (-rho_e + (T)0.5 * rho * sqvel) / (rho * rgas);
  T c2 = (T)1 / rgas;

  // secant seeded by the previous temperature (:398-432)
  T t = t_guess[p];
  T t_old = t + (T)1;
  T h_old = h_mix<T, NS>(g, tb, ns, ysc, mm, t_old);
  bool done = false;
  for (int it = 0; it < tp.secant_iters && !done; ++it) {
    T f = t - c1 - c2 * h_mix<T, NS>(g, tb, ns, ysc, mm, t);
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
      T f = tm - c1 - c2 * h_mix<T, NS>(g, tb, ns, ysc, mm, tm);
      tbis = tm;
      if (fabs(f) < (T)tp.bisect_tol || (tbb - ta) < eps4 * fabs(tm)) break;
      if (f > (T)0) ta = tm; else tbb = tm;
    }
    t = tbis;
  }
  if (tp.clip) {
    // CLIPPING_TEMPRATURE (:505-506): the plain version's clamp to
    // [0.95, 1.05] t_guess, before the bounds' clip
    const T lo = (T)0.95 * t_guess[p], hi = (T)1.05 * t_guess[p];
    t = t < lo ? lo : t;
    t = t > hi ? hi : t;
  }
  nonphys |= (t < (T)tp.tmin) || (t > (T)tp.tmax);
  t = t < (T)tp.tmin ? (T)tp.tmin : (t > (T)tp.tmax ? (T)tp.tmax : t);
  T press = rho * rgas * t;
  nonphys |= press < EPS;
  press = press < EPS ? EPS : press;

  Bin<T> bn = spline_bin(g, t);
  T cp = (T)0;
  for_n<NS>(ns, [&](int s) {
    cp += ysc[s] * (spline_at(g, bn, tb.row(2, s, g.nt), tb.row(3, s, g.nt))
                    / mm[s]);
    if (!LITE)
      e_s[s] = spline_at(g, bn, tb.row(0, s, g.nt), tb.row(1, s, g.nt))
               / mm[s] - ri[s] * t;
  });
  T gamma = cp / (cp - rgas);
  T sound = sqrt(gamma * press / rho);
  nonphys |= sound < EPS;
  sound = sound < EPS ? EPS : sound;
  T htot = (up[RHOE] + press) / rho;

  oa[0] = t;
#pragma unroll
  for (int d = 0; d < SU2K_MAXD; ++d)
    if (d < nd) oa[1 + d] = vel[d];
  oa[nd + 1] = press;
  oa[nd + 2] = rho;
  oa[nd + 3] = htot;
  oa[nd + 4] = sound;
  __syncthreads();
  store_rows(st, ws, nprim, v_out, p0, cnt);
  __syncthreads();
  oa[0] = rho;
  for (int k = 1; k < RHOS; ++k) oa[k] = up[k];
  for_n<NS>(ns, [&](int s) { oa[RHOS + s] = rho_s[s]; });
  __syncthreads();
  store_rows(st, ws, nvar, u_out, p0, cnt);
  if (act) nonphys_out[p] = nonphys ? 1 : 0;
  __syncthreads();

  if (LITE) {
    if (act) gm1_out[p] = gamma - (T)1;
  } else {
    T rho_cv = rho * (cp - rgas);
    oa[0] = (T)0.5 * sqvel / rho_cv;
#pragma unroll
    for (int d = 0; d < SU2K_MAXD; ++d)
      if (d < nd) oa[1 + d] = -vel[d] / rho_cv;
    oa[RHOE] = (T)1 / rho_cv;
    for_n<NS>(ns, [&](int s) { oa[RHOS + s] = -e_s[s] / rho_cv; });
    __syncthreads();
    store_rows(st, ws, nvar, dtdu_out, p0, cnt);
    __syncthreads();
    oa[0] = (gamma - (T)1) * (T)0.5 * sqvel;
#pragma unroll
    for (int d = 0; d < SU2K_MAXD; ++d)
      if (d < nd) oa[1 + d] = ((T)1 - gamma) * vel[d];
    oa[RHOE] = gamma - (T)1;
    for_n<NS>(ns, [&](int s) {
      oa[RHOS + s] = ri[s] * t - (gamma - (T)1) * e_s[s];
    });
    __syncthreads();
    store_rows(st, ws, nvar, dpdu_out, p0, cnt);
    __syncthreads();
  }

  // Wilke mixture viscosity (ComputeEta :634-663) and the Wasilewska-type
  // conductivity (ComputeLambda :670-696)
  for_n<NS>(ns, [&](int s) {
    mu_s[s] = spline_at(g, bn, tb.row(4, s, g.nt), tb.row(5, s, g.nt));
    sq[s] = sqrt(mu_s[s]);
    yom[s] = ysc[s] / mm[s];
  });
  T mu = (T)0, kappa = (T)0;
  for_n<NS>(ns, [&](int i) {
    T phi = (T)0, phik = (T)0;
    for_n<NS>(ns, [&](int j) {
      T num = (T)1 + sq[i] / sq[j] * c_mass[i * ns + j];
      T pair = num * num * c_den[i * ns + j];
      phi += pair * yom[j];
      if (!LITE && j != i) phik += (T)1.065 * pair * yom[j];
    });
    mu += mu_s[i] * yom[i] / phi;
    if (!LITE) {
      T ka = spline_at(g, bn, tb.row(6, i, g.nt), tb.row(7, i, g.nt));
      kappa += ka * yom[i] / (phik + yom[i]);
    }
  });
  if (act) {
    mu_out[p] = mu;
    if (!LITE) kappa_out[p] = kappa;
  }
  T ysum_c = (T)0, xsum = (T)0;
  for_n<NS>(ns, [&](int s) {
    ysum_c += ysc[s];
    xsum += yom[s];
  });
  for_n<NS>(ns, [&](int s) { oa[s] = yom[s] * (ysum_c / xsum); });
  __syncthreads();
  store_rows(st, ws, ns, xs_out, p0, cnt);
}

template <typename T, int NS>
int launch_node_state(int lite, int n, int nd, int ns,
                      const Grid<T>& g, const TSolve& tp, const void* u,
                      const void* t_guess, const void* tke, const void* tab,
                      const void* cst, void* u_out, void* v_out,
                      void* nonphys, void* dtdu, void* dpdu, void* gm1,
                      void* mu, void* kappa, void* xs, cudaStream_t st) {
  Tabs<T> tb{(const T*)tab, (const T*)cst, ns};
  T eps4 = (T)4 * (sizeof(T) == 8 ? (T)2.220446049250313e-16
                                  : (T)1.1920929e-07);
  const int threads = SU2K_NS_THREADS;
  const int blocks = (n + threads - 1) / threads;
  const size_t smem = node_state_smem<T>(nd, ns);
  const void* kern = lite ? (const void*)node_state_kernel<T, NS, true>
                          : (const void*)node_state_kernel<T, NS, false>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (lite)
    node_state_kernel<T, NS, true><<<blocks, threads, smem, st>>>(
        n, nd, ns, g, tp, eps4, (const T*)u, (const T*)t_guess,
        (const T*)tke, tb, (T*)u_out, (T*)v_out, (uint8_t*)nonphys, nullptr,
        nullptr, (T*)gm1, (T*)mu, nullptr, (T*)xs);
  else
    node_state_kernel<T, NS, false><<<blocks, threads, smem, st>>>(
        n, nd, ns, g, tp, eps4, (const T*)u, (const T*)t_guess,
        (const T*)tke, tb, (T*)u_out, (T*)v_out, (uint8_t*)nonphys,
        (T*)dtdu, (T*)dpdu, nullptr, (T*)mu, (T*)kappa, (T*)xs);
  return (int)cudaGetLastError();
}

template <typename T>
int node_state_by_ns(int lite, int n, int nd, int ns, int nt,
                     double t0, double dt, const TSolve& tp, const void* u,
                     const void* t_guess, const void* tke, const void* tab,
                     const void* cst, void* u_out, void* v_out,
                     void* nonphys, void* dtdu, void* dpdu, void* gm1,
                     void* mu, void* kappa, void* xs, cudaStream_t st) {
  Grid<T> g{(T)t0, (T)dt, (T)(t0 + (nt - 1) * dt), (T)(dt * dt), nt};
#define SU2K_NS_CASE(NS_)                                                   \
  if (ns == NS_)                                                            \
    return launch_node_state<T, NS_>(lite, n, nd, ns, g, tp, u,             \
                                     t_guess, tke, tab, cst, u_out, v_out,  \
                                     nonphys, dtdu, dpdu, gm1, mu, kappa,   \
                                     xs, st);
  SU2K_NODE_STATE_BY_NS(SU2K_NS_CASE)
#undef SU2K_NS_CASE
  return launch_node_state<T, 0>(lite, n, nd, ns, g, tp, u, t_guess,
                                 tke, tab, cst, u_out, v_out, nonphys, dtdu,
                                 dpdu, gm1, mu, kappa, xs, st);
}

}  // namespace su2k

extern "C" int su2k_node_state(int is_f64, int lite, int n, int nd, int ns,
                               int nt, double t0, double dt, double tmin,
                               double tmax, int secant_iters,
                               double secant_tol, int bisect_iters,
                               double bisect_tol, int clip_temp,
                               const void* u,
                               const void* t_guess, const void* tke,
                               const void* tab, const void* cst, void* u_out,
                               void* v_out, void* nonphys, void* dtdu,
                               void* dpdu, void* gm1, void* mu, void* kappa,
                               void* xs, void* stream) {
  if (ns < 1 || ns > SU2K_MAXS || nd < 1 || nd > SU2K_MAXD)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  su2k::TSolve tp{tmin, tmax, secant_tol, bisect_tol, secant_iters,
                  bisect_iters, clip_temp};
  cudaStream_t st = (cudaStream_t)stream;
  if (is_f64)
    return su2k::node_state_by_ns<double>(
        lite, n, nd, ns, nt, t0, dt, tp, u, t_guess, tke, tab, cst,
        u_out, v_out, nonphys, dtdu, dpdu, gm1, mu, kappa, xs, st);
  return su2k::node_state_by_ns<float>(
      lite, n, nd, ns, nt, t0, dt, tp, u, t_guess, tke, tab, cst,
      u_out, v_out, nonphys, dtdu, dpdu, gm1, mu, kappa, xs, st);
}

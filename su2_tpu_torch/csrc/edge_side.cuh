// The per-edge pipeline of the explicit interior edge flux, shared by
// kernel T3 (csrc/edge_flux.cu, one thread per family slot), kernel K8
// (csrc/edge_win.cu, T3's slot pass, then the sums per node) and kernel
// K13 (csrc/edge_list.cu, one thread per edge of an edge list), so all
// three run the same instructions.  Its species h/cp lookup and
// Stefan-Maxwell solve are also the viscous core of kernel K10
// (csrc/edge_implicit.cu, with the species count known at run time), and
// the implicit AUSM+-up face at its end (flux and both Jacobians) is shared
// by K10 and K11 (csrc/ausm_jac.cu).  For the edge (p, p + o_k) of family
// k: AUSM+-up convective flux (numerics_direct_reactive.cpp:53-383),
// viscous flux with Stefan-Maxwell diffusion and the SST closure
// (:385-1684, closure :656-889), species h/cp at the face-mean
// temperature, and the convective and viscous spectral radii of
// SetTime_Step (solver_direct_reactive.cpp:5057).  edge_side takes the
// edge's two endpoint columns, its area normal and its node-to-node
// vector; for the family slot (p, p + o_k) of T3 and K8, fam_slot reads
// them (the endpoint p + o_k wraps mod n, as torch.roll does; slots
// without an edge carry zero normals, so their flux and radii are zero).
//
// edge_side is compiled for fixed (dimension, species count) shapes
// (SU2K_EDGE_BY_SHAPE), so its S x (S+1) system and work vectors are
// registers.  With the counts known only at run time every one of them
// is a local-memory array (2,096 B of stack per thread in f32, 4,176 B
// in f64), and that traffic, not device memory, sets the time; every
// other shape (nd <= 3, S <= 16) runs that run-time instance of the same
// body (ND = NS = 0), so no mixture su2_tpu runs is refused.
#pragma once

#include "common.cuh"

namespace su2k {

#define SU2K_MAXK 8            // edge families
#define SU2K_MAXV (SU2K_MAXS + SU2K_MAXD + 2)   // conserved variables
#define SU2K_MAXG (1 + SU2K_MAXD + SU2K_MAXS)

struct EdgeConsts {
  double m_infty, pr_lam, pr_turb, le_turb, mm_sum;
  int nd, ns, kh;
  int off[SU2K_MAXK];
};

template <typename T>
__device__ __forceinline__ T harm(T a, T b) {
  return (T)2 / ((T)1 / a + (T)1 / b);
}

template <typename T>
__device__ __forceinline__ void split_mach(T m, T& mp, T& mm) {
  const T BETA = (T)0.125;
  bool sub = fabs(m) < (T)1;
  T q = (m * m - (T)1) * (m * m - (T)1);
  mp = sub ? (T)0.25 * ((m + (T)1) * (m + (T)1)) + BETA * q
           : (T)0.5 * (m + fabs(m));
  mm = sub ? (T)-0.25 * ((m - (T)1) * (m - (T)1)) - BETA * q
           : (T)0.5 * (m - fabs(m));
}

template <typename T>
__device__ __forceinline__ void press_polys(T m, T alpha, T& pp, T& pm) {
  bool sub = fabs(m) < (T)1;
  T safe = m == (T)0 ? (T)1 : m;
  T q = (m * m - (T)1) * (m * m - (T)1);
  pp = sub ? (T)0.25 * ((m + (T)1) * (m + (T)1)) * ((T)2 - m)
                 + alpha * m * q
           : (T)0.5 * ((T)1 + fabs(m) / safe);
  pm = sub ? (T)0.25 * ((m - (T)1) * (m - (T)1)) * ((T)2 + m)
                 - alpha * m * q
           : (T)0.5 * ((T)1 - fabs(m) / safe);
}
// Species h, cp [J/kg] at temperature t from the tables h[S] h2[S] cp[S]
// cp2[S] (each nt long); NS the species count if fixed at compile time,
// else 0 and ns.
template <int NS, typename T>
__device__ __forceinline__ void species_hcp(const Grid<T>& g,
                                            const T* __restrict__ tab,
                                            const T* __restrict__ mm, int ns,
                                            T t, T* hs, T* cps) {
  Bin<T> bn = spline_bin(g, t);
  if constexpr (NS > 0) ns = NS;
  for_n<NS>(ns, [&](int s) {
    hs[s] = spline_at(g, bn, tab + (size_t)s * g.nt,
                      tab + (size_t)(ns + s) * g.nt) / mm[s];
    cps[s] = spline_at(g, bn, tab + (size_t)(2 * ns + s) * g.nt,
                       tab + (size_t)(3 * ns + s) * g.nt) / mm[s];
  });
}

// Stefan-Maxwell diffusion fluxes: (Gamma + alpha y 1^T) Jd = -gxn
// (GetGamma, reacting_model_library.cpp:771-798, Solve_SM), Gamma from the
// separable Fuller form D_ab = gf / den[a, b], pivot-free Gauss-Jordan on
// the S x (S+1) system aug; Jd is left in aug[s * (S+1) + S].  NS as in
// species_hcp: with a fixed count every index of aug is a constant after
// unrolling, so the system lives in registers.
template <int NS, typename T>
__device__ __forceinline__ void stefan_maxwell(int ns,
                                               const T* __restrict__ mm,
                                               const T* __restrict__ den,
                                               const T* ysc, const T* xs,
                                               T rho, T gf, const T* gxn,
                                               T* aug) {
  if constexpr (NS > 0) ns = NS;
  constexpr int W = NS + 1;
  const int w = ns + 1;
  T sigma = (T)0, ym = (T)0;
  for_n<NS>(ns, [&](int s) {
    sigma += ysc[s];
    ym += ysc[s] / mm[s];
  });
  T mtot = (T)1 / ym;
  T prefg = sigma * mtot / (rho * gf);
  T den_min = den[0];
  for_n<(NS > 0 ? NS * NS - 1 : 0)>(ns * ns - 1, [&](int q) {
    den_min = den[q + 1] < den_min ? den[q + 1] : den_min;
  });
  T alpha_sm = den_min / (rho * gf);
  for_n<NS>(ns, [&](int a) {
    T sum_terms = (T)0;
    for_n<NS>(ns, [&](int b) {
      sum_terms += (a == b ? (T)0 : den[a * ns + b]) * xs[b];
    });
    T diag = prefg * sum_terms / mm[a];
    for_n<NS>(ns, [&](int b) {
      T gam = a == b ? diag
                     : -(prefg * xs[a]) * (den[a * ns + b] / mm[b]);
      aug[a * w + b] = gam + alpha_sm * ysc[a];
    });
    aug[a * w + ns] = -gxn[a];
  });
  for_n<NS>(ns, [&](int col) {
    T piv = aug[col * w + col];
    T safe = piv == (T)0 ? (T)1 : piv;
    for_n<(NS > 0 ? W : 0)>(w, [&](int b) { aug[col * w + b] /= safe; });
    for_n<NS>(ns, [&](int a) {
      if (a == col) return;
      T fac = aug[a * w + col];
      for_n<(NS > 0 ? W : 0)>(w, [&](int b) {
        aug[a * w + b] -= fac * aug[col * w + b];
      });
    });
  });
}

// c.off[k] by selects over an unrolled loop: a run-time index into the
// kernel's argument struct would copy the whole struct to local memory
// (C: EdgeConsts, or K10's ImpConsts)
template <typename C>
__device__ __forceinline__ int fam_offset(const C& c, int k) {
  int o = c.off[0];
#pragma unroll
  for (int kk = 1; kk < SU2K_MAXK; ++kk) o = k == kk ? c.off[kk] : o;
  return o;
}

// The family slot (p, p + o_k) of T3 and K8: its j endpoint (mod n), and
// its area normal and node-to-node vector from fam_normal/fam_evec
// (Kh, n, nd) into nm, ev (nd = ND, or c.nd where ND = 0).
template <int ND, typename T>
__device__ __forceinline__ int fam_slot(int n, const EdgeConsts& c,
                                        const T* __restrict__ fam_normal,
                                        const T* __restrict__ fam_evec,
                                        int k, int p, T* nm, T* ev) {
  const int nd = ND > 0 ? ND : c.nd;
  for_n<ND>(nd, [&](int d) {
    nm[d] = fam_normal[((size_t)k * n + p) * nd + d];
    ev[d] = fam_evec[((size_t)k * n + p) * nd + d];
  });
  int j = p + fam_offset(c, k);
  return j >= n ? j - n : j;
}

// f: the feature-major stack (R, n), the edge's endpoints its columns i and
// j; nm_in, ev_in: its area normal and node-to-node vector (nd); table rows
// (each nt long): h[S] h2[S] cp[S] cp2[S]; cst: mm[S] den[S*S].  Writes
// flux = conv - visc (nVar = S + nd + 2) into fo and the two radii.  ND and
// NS are compile-time constants (SU2K_EDGE_BY_SHAPE): every loop below has
// a constant trip count and is unrolled, so every per-edge array, the
// S x (S+1) system included, is indexed by constants and lives in
// registers.  ND = NS = 0 is the run-time instance (c.nd, c.ns, at most
// SU2K_MAXD and SU2K_MAXS): the same operations in the same order, the
// arrays at their bounds and in local memory, for every other shape.
template <int ND, int NS, typename T>
__device__ __forceinline__ void edge_side(int n, const EdgeConsts& c,
                                          const Grid<T>& g,
                                          const T* __restrict__ f, int i,
                                          int j, const T* nm_in,
                                          const T* ev_in,
                                          const T* __restrict__ tab,
                                          const T* __restrict__ cst, T* fo,
                                          T& lc_o, T& lv_o) {
  static_assert((ND > 0) == (NS > 0), "both counts fixed, or neither");
  constexpr bool FIXED = ND > 0;
  constexpr int MD = FIXED ? ND : SU2K_MAXD, MS = FIXED ? NS : SU2K_MAXS;
  constexpr int MPRIM = MS + MD + 5, MV = MS + MD + 2, MG = 1 + MD + MS;
  // trip counts for for_n: the count itself, or 0 (known at run time)
  constexpr int NPRIM = FIXED ? MPRIM : 0, NG = FIXED ? MG : 0;
  constexpr int NGD = FIXED ? MG * MD : 0;
  const int nd = FIXED ? ND : c.nd, ns = FIXED ? NS : c.ns;
  const int nprim = ns + nd + 5, ng = 1 + nd + ns;
  const int P_ = nd + 1, PRHO = nd + 2, H_ = nd + 3, A_ = nd + 4;
  const int YS = nd + 5;
  const int r_g = nprim, r_mu = r_g + ng * nd, r_ka = r_mu + 1;
  const int r_mut = r_ka + 1, r_tke = r_mut + 1, r_gk = r_tke + 1;
  const int r_gam = r_gk + nd, r_sk = r_gam + 1;
  const T tiny = sizeof(T) == 8 ? (T)1e-300 : (T)1e-30;
  const T* mm = cst;
  const T* den = cst + ns;

  auto fi = [&](int r) { return f[(size_t)r * n + i]; };
  auto fj = [&](int r) { return f[(size_t)r * n + j]; };

  T nm[MD], ev[MD];
  T area2 = (T)0;
  for_n<ND>(nd, [&](int d) {
    nm[d] = nm_in[d];
    ev[d] = ev_in[d];
    area2 += nm[d] * nm[d];
  });
  T area = sqrt(area2);

  T vi[MPRIM], vj[MPRIM];
  for_n<NPRIM>(nprim, [&](int r) {
    vi[r] = fi(r);
    vj[r] = fj(r);
  });

  // ------------------------------------------------------- AUSM+-up
  const T KP = (T)0.25, SIGMA = (T)1, KU = (T)0.75;
  T unit[MD];
  T asafe = area < tiny ? tiny : area;
  T proj_i = (T)0, proj_j = (T)0;
  for_n<ND>(nd, [&](int d) {
    unit[d] = nm[d] / asafe;
    proj_i += vi[1 + d] * unit[d];
    proj_j += vj[1 + d] * unit[d];
  });
  T rho_i = vi[PRHO], rho_j = vj[PRHO], p_i = vi[P_], p_j = vj[P_];
  T a_mean = (T)0.5 * (vi[A_] + vj[A_]);
  T m_l = proj_i / a_mean, m_r = proj_j / a_mean;
  T m_f2 = (T)0.5 * (m_l * m_l + m_r * m_r);
  T minf2 = (T)(c.m_infty * c.m_infty);
  T m_ref2 = m_f2 > minf2 ? m_f2 : minf2;
  m_ref2 = m_ref2 < (T)1 ? m_ref2 : (T)1;
  T m_ref = sqrt(m_ref2);
  T fa = m_ref * ((T)2 - m_ref);
  T alpha = (T)(3.0 / 16.0) * ((T)5 * fa * fa - (T)4);
  T m_lp, m_lm, m_rp, m_rm, p_lp, p_lm, p_rp, p_rm;
  split_mach(m_l, m_lp, m_lm);
  split_mach(m_r, m_rp, m_rm);
  press_polys(m_l, alpha, p_lp, p_lm);
  press_polys(m_r, alpha, p_rp, p_rm);
  T rho_mean = (T)0.5 * (rho_i + rho_j);
  T factor = (T)1 - SIGMA * m_f2;
  factor = factor > (T)0 ? factor : (T)0;
  T m12 = m_lp + m_rm - KP / fa * factor * (p_j - p_i)
                            / (rho_mean * a_mean * a_mean);
  T m_lf = (T)0.5 * (m12 + fabs(m12));
  T m_rf = (T)0.5 * (m12 - fabs(m12));
  T mass12 = a_mean * (m_lf * rho_i + m_rf * rho_j);
  T p_lf = p_lp * p_i + p_rm * p_j
         - KU * p_lp * p_rm * (rho_i + rho_j) * fa * a_mean
               * (proj_j - proj_i);
  T out[MV];
  {
    auto conv = [&](T phi_i, T phi_j) {
      return (T)0.5 * (mass12 * (phi_i + phi_j)
                       + fabs(mass12) * (phi_i - phi_j)) * area;
    };
    out[0] = conv((T)1, (T)1);
    for_n<ND>(nd, [&](int d) {
      out[1 + d] = conv(vi[1 + d], vj[1 + d]) + (p_lf * area) * unit[d];
    });
    out[1 + nd] = conv(vi[H_], vj[H_]);
    for_n<NS>(ns, [&](int s) {
      out[2 + nd + s] = conv(vi[YS + s], vj[YS + s]);
    });
  }

  // ------------------------------------------------------- viscous
  T mu = harm(fi(r_mu), fj(r_mu));
  T ktr = harm(fi(r_ka), fj(r_ka));
  T gf = harm((T)1.0e-7 * pow(vi[0], (T)1.75) / (vi[P_] / (T)101325.0),
              (T)1.0e-7 * pow(vj[0], (T)1.75) / (vj[P_] / (T)101325.0));
  T vel[MD];
  for_n<ND>(nd, [&](int d) { vel[d] = (T)0.5 * (vi[1 + d] + vj[1 + d]); });
  T rho = (T)0.5 * (rho_i + rho_j);
  T ysc[MS], xs[MS];
  {
    T ysum = (T)0, xsum = (T)0;
    for_n<NS>(ns, [&](int s) {
      ysc[s] = clip_y((T)0.5 * (vi[YS + s] + vj[YS + s]));
      xs[s] = ysc[s] / mm[s];
      ysum += ysc[s];
      xsum += xs[s];
    });
    for_n<NS>(ns, [&](int s) { xs[s] = xs[s] * (ysum / xsum); });
  }

  T gm[MG * MD];
  for_n<NGD>(ng * nd, [&](int q) {
    gm[q] = (T)0.5 * (fi(r_g + q) + fj(r_g + q));
  });
  {
    // edge-projection correction (CAvgGradReactive_Flow, :1507-1527)
    T dist2 = (T)0;
    for_n<ND>(nd, [&](int d) { dist2 += ev[d] * ev[d]; });
    dist2 = dist2 > tiny ? dist2 : tiny;
    T xi[MS], xj[MS];
    T si = (T)0, sxi = (T)0, sj = (T)0, sxj = (T)0;
    for_n<NS>(ns, [&](int s) {
      T yi = clip_y(vi[YS + s]), yj = clip_y(vj[YS + s]);
      xi[s] = yi / mm[s];
      xj[s] = yj / mm[s];
      si += yi; sxi += xi[s]; sj += yj; sxj += xj[s];
    });
    for_n<NG>(ng, [&](int q) {
      T diff;
      if (q == 0) diff = vj[0] - vi[0];
      else if (q <= nd) diff = vj[q] - vi[q];
      else {
        const int s = q - 1 - nd;
        diff = xj[s] * (sj / sxj) - xi[s] * (si / sxi);
      }
      T proj = gm[q * nd] * ev[0];
      for_n<(FIXED ? ND - 1 : 0)>(nd - 1, [&](int d1) {
        proj += gm[q * nd + d1 + 1] * ev[d1 + 1];
      });
      T cf = (proj - diff) / dist2;
      for_n<ND>(nd, [&](int d) { gm[q * nd + d] -= cf * ev[d]; });
    });
  }
  const T* g_t = gm;
  const T* g_vel = gm + nd;            // [a * nd + b]
  const T* g_xs = gm + (1 + nd) * nd;  // [s * nd + d]
  T div = g_vel[0];
  for_n<(FIXED ? ND - 1 : 0)>(nd - 1, [&](int d1) {
    div += g_vel[(d1 + 1) * nd + d1 + 1];
  });
  const T TWO3 = (T)(2.0 / 3.0);

  // Stefan-Maxwell: (Gamma + alpha y 1^T) Jd = -grad(X).N, Gauss-Jordan
  T gxn[MS];
  for_n<NS>(ns, [&](int s) {
    T acc = g_xs[s * nd] * nm[0];
    for_n<(FIXED ? ND - 1 : 0)>(nd - 1, [&](int d1) {
      acc += g_xs[s * nd + d1 + 1] * nm[d1 + 1];
    });
    gxn[s] = acc;
  });
  T aug[MS * (MS + 1)];
  const int w = ns + 1;
  stefan_maxwell<NS>(ns, mm, den, ysc, xs, rho, gf, gxn, aug);
  T e_heat = (T)0, jsum = (T)0;
  T hs[MS], cps[MS];
  species_hcp<NS>(g, tab, mm, ns, (T)0.5 * (vi[0] + vj[0]), hs, cps);
  for_n<NS>(ns, [&](int s) {
    T jd = aug[s * w + ns];
    e_heat -= hs[s] * jd;
    jsum += jd;
  });
  T mu_t = harm(fi(r_mut), fj(r_mut));
  T tke = (T)0.5 * (fi(r_tke) + fj(r_tke));
  T mom[MD];
  T e_tau = (T)0;
  for_n<ND>(nd, [&](int b) { mom[b] = (T)0; });
  for_n<ND>(nd, [&](int a) {
    for_n<ND>(nd, [&](int b) {
      T sym = g_vel[a * nd + b] + g_vel[b * nd + a];
      T tau = mu * sym - (a == b ? TWO3 * mu * div : (T)0);
      T taut = mu_t * sym
             - (a == b ? TWO3 * (mu_t * div + tke * rho) : (T)0);
      mom[b] += (tau + taut) * nm[a];
      e_tau += (tau + taut) * vel[b] * nm[a];
    });
  });
  T gtn = g_t[0] * nm[0];
  for_n<(FIXED ? ND - 1 : 0)>(nd - 1, [&](int d1) {
    gtn += g_t[d1 + 1] * nm[d1 + 1];
  });
  T e_cond = ktr * gtn;

  // molar -> mass gradient operator, rank-2 Woodbury solve (:855-880)
  T cmt = mu_t / (T)(c.pr_turb * c.le_turb);
  T gyn[MS];
  {
    T mms = (T)c.mm_sum;
    T sigx = (T)0;
    for_n<NS>(ns, [&](int s) { sigx += xs[s]; });
    T g11 = (T)1, g12 = (T)0, g21 = (T)0, g22 = (T)1;
    T du[MS], dw[MS], dinv[MS];
    for_n<NS>(ns, [&](int s) {
      dinv[s] = mm[s] / (mms * sigx);
      du[s] = dinv[s] * (mms * ysc[s] / mm[s]);
      dw[s] = dinv[s] * (-mms * xs[s]);
      g11 += du[s];
      g12 += dw[s];
      g21 += du[s] / mm[s];
      g22 += dw[s] / mm[s];
    });
    T det = g11 * g22 - g12 * g21;
    det = det == (T)0 ? (T)1 : det;
    for_n<NS>(ns, [&](int s) { gyn[s] = (T)0; });
    for_n<ND>(nd, [&](int d) {
      T c1 = (T)0, c2 = (T)0;
      for_n<NS>(ns, [&](int s) {
        T db = dinv[s] * g_xs[s * nd + d];
        c1 += db;
        c2 += db / mm[s];
      });
      T a1 = (g22 * c1 - g12 * c2) / det;
      T a2 = (g11 * c2 - g21 * c1) / det;
      for_n<NS>(ns, [&](int s) {
        T gxs = g_xs[s * nd + d];
        T gy = dinv[s] * gxs - du[s] * a1 - dw[s] * a2;
        gy = fabs(gxs) < (T)1e-8 ? (T)0 : gy;
        gyn[s] += gy * nm[d];
      });
    });
  }
  T hy = (T)0, cpy = (T)0;
  for_n<NS>(ns, [&](int s) {
    hy += hs[s] * ysc[s] * gyn[s];
    cpy += cps[s] * ysc[s];
  });
  e_heat += cmt * hy;
  e_cond += (mu_t / (T)c.pr_turb) * cpy * gtn;
  T gkn = (T)0;
  for_n<ND>(nd, [&](int d) {
    gkn += (T)0.5 * (fi(r_gk + d) + fj(r_gk + d)) * nm[d];
  });
  e_cond += (mu + mu_t / fi(r_sk)) * gkn;

  // flux = conv - visc
  fo[0] = out[0] - (-jsum);
  for_n<ND>(nd, [&](int d) { fo[1 + d] = out[1 + d] - mom[d]; });
  fo[1 + nd] = out[1 + nd] - (e_tau + e_cond + e_heat);
  for_n<NS>(ns, [&](int s) {
    fo[2 + nd + s] = out[2 + nd + s] - (-aug[s * w + ns] + cmt * gyn[s]);
  });

  // spectral radii (max_lambda_inv + viscous_lambda terms)
  T pr = (T)0;
  for_n<ND>(nd, [&](int d) { pr += (vi[1 + d] + vj[1 + d]) * nm[d]; });
  lc_o = (fabs((T)0.5 * pr) + a_mean) * area;
  T mean_mu = (T)0.5 * (fi(r_mu) + fj(r_mu));
  T mean_mut = (T)0.5 * (fi(r_mut) + fj(r_mut));
  T lam1 = (T)(4.0 / 3.0) * (mean_mu + mean_mut);
  T lam2 = ((T)1 + (T)(c.pr_lam / c.pr_turb) * (mean_mut / mean_mu))
         * (fi(r_gam) * mean_mu / (T)c.pr_lam);
  lv_o = (lam1 + lam2) * area * area / rho_mean;
}

// The (dimension, species count) shapes edge_side is compiled for in T3,
// K8 and K13 (kernels.EDGE_SHAPES): the 9-species combustion chemistry in
// 2D and 3D and the 3-species air in 2D and 3D; X(ND, NS) names one.
// Every other shape with 1 <= nd <= SU2K_MAXD and 1 <= ns <= SU2K_MAXS
// runs the run-time instance X(0, 0).
#define SU2K_EDGE_BY_SHAPE(X) X(2, 9) X(2, 3) X(3, 9) X(3, 3)

// whether the run-time instance takes the shape of c
__host__ __device__ inline bool edge_shape_ok(int nd, int ns) {
  return nd >= 1 && nd <= SU2K_MAXD && ns >= 1 && ns <= SU2K_MAXS;
}

// One thread per family slot (k, p): the slot's outputs, family-major:
// flux (Kh, NV, n), lc and lv (Kh, n).  T3 is this pass; K8 runs it as its
// first pass under a kernel name of its own, so a profile charges it to K8.
template <typename T, int ND, int NS>
__device__ __forceinline__ void edge_slot(int n, const EdgeConsts& c,
                                          const Grid<T>& g,
                                          const T* __restrict__ f,
                                          const T* __restrict__ fam_normal,
                                          const T* __restrict__ fam_evec,
                                          const T* __restrict__ tab,
                                          const T* __restrict__ cst,
                                          T* __restrict__ flux,
                                          T* __restrict__ lc,
                                          T* __restrict__ lv) {
  constexpr int MD = ND > 0 ? ND : SU2K_MAXD;
  constexpr int MV = ND > 0 ? NS + ND + 2 : SU2K_MAXV;
  const int nv = ND > 0 ? NS + ND + 2 : c.ns + c.nd + 2;
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)c.kh * n) return;
  const int k = (int)(idx / n);
  const int p = (int)(idx - (long long)k * n);
  T fo[MV], nm[MD], ev[MD];
  T lco, lvo;
  const int j = fam_slot<ND>(n, c, fam_normal, fam_evec, k, p, nm, ev);
  edge_side<ND, NS>(n, c, g, f, p, j, nm, ev, tab, cst, fo, lco, lvo);
  T* out = flux + (size_t)k * nv * n + p;
  for_n<(ND > 0 ? NS + ND + 2 : 0)>(nv, [&](int r) {
    out[(size_t)r * n] = fo[r];
  });
  lc[(size_t)k * n + p] = lco;
  lv[(size_t)k * n + p] = lvo;
}

#define SU2K_EDGE_SLOT_ARGS(T)                                              \
  int n, EdgeConsts c, Grid<T> g, const T* __restrict__ f,                  \
      const T* __restrict__ fam_normal, const T* __restrict__ fam_evec,     \
      const T* __restrict__ tab, const T* __restrict__ cst,                 \
      T* __restrict__ flux, T* __restrict__ lc, T* __restrict__ lv

template <typename T, int ND, int NS>
__global__ void edge_flux_kernel(SU2K_EDGE_SLOT_ARGS(T)) {
  edge_slot<T, ND, NS>(n, c, g, f, fam_normal, fam_evec, tab, cst, flux, lc,
                       lv);
}

template <typename T, int ND, int NS>
__global__ void edge_win_slot_kernel(SU2K_EDGE_SLOT_ARGS(T)) {
  edge_slot<T, ND, NS>(n, c, g, f, fam_normal, fam_evec, tab, cst, flux, lc,
                       lv);
}

// The slot pass at the shape of c: edge_flux_kernel (T3), or
// edge_win_slot_kernel (K8's first pass) when K8, at the compiled shape or
// else the run-time instance <T, 0, 0>; cudaErrorInvalidValue past the
// bounds of edge_shape_ok.
template <typename T, bool K8>
int launch_edge_slots(int n, const EdgeConsts& c, const Grid<T>& g,
                      const T* f, const T* nrm, const T* evec, const T* tab,
                      const T* cst, T* flux, T* lc, T* lv,
                      cudaStream_t stream) {
  const int threads = 128;
  const long long total = (long long)c.kh * n;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  if (!edge_shape_ok(c.nd, c.ns)) return (int)cudaErrorInvalidValue;
  if (total <= 0) return (int)cudaSuccess;
#define SU2K_SLOT_CASE(ND_, NS_)                                            \
  if (c.nd == ND_ && c.ns == NS_) {                                         \
    if constexpr (K8)                                                       \
      edge_win_slot_kernel<T, ND_, NS_><<<blocks, threads, 0, stream>>>(    \
          n, c, g, f, nrm, evec, tab, cst, flux, lc, lv);                   \
    else                                                                    \
      edge_flux_kernel<T, ND_, NS_><<<blocks, threads, 0, stream>>>(        \
          n, c, g, f, nrm, evec, tab, cst, flux, lc, lv);                   \
    return (int)cudaGetLastError();                                         \
  }
  SU2K_EDGE_BY_SHAPE(SU2K_SLOT_CASE)
#undef SU2K_SLOT_CASE
  if constexpr (K8)
    edge_win_slot_kernel<T, 0, 0><<<blocks, threads, 0, stream>>>(
        n, c, g, f, nrm, evec, tab, cst, flux, lc, lv);
  else
    edge_flux_kernel<T, 0, 0><<<blocks, threads, 0, stream>>>(
        n, c, g, f, nrm, evec, tab, cst, flux, lc, lv);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The implicit AUSM+-up face: flux and both Jacobians (ops/ausm_t.py
// ausm_flux_t and _jacobians), shared by K10 (csrc/edge_implicit.cu) and
// K11 (csrc/ausm_jac.cu), ND = 2.  The two 13 x 13 blocks are never held:
// ausm_face leaves the flux and four column vectors, and ausm_jac_entry
// forms any entry of either block from them.

template <typename T>
struct AusmFace {
  T a_mean, m_lf, m_rf, sp, sm;
};

// phi of the AUSM flux, row a: [1, u.., h, Y..] of primitives v
template <int ND, typename T>
__device__ __forceinline__ T ausm_phi(const T* v, int a) {
  return a == 0 ? (T)1
                : (a <= ND ? v[a] : (a == ND + 1 ? v[ND + 3] : v[a + 3]));
}

// vfi, vfj: face primitives [T, u.., P, rho, h, a, Y..]; s_i, s_j: their
// dP/dU rows (nvar); unit, area: the face's unit normal and area.  Writes
// the flux fo (nvar, times area) and the column vectors w_l, w_r (half the
// mass-flux derivatives, 0.5 (dM_pol - dM_ext), before the upwind signs)
// and pr_l, pr_r (the pressure-flux derivatives): both sides' (SIDES = 3),
// or side i's only (1: w_r, pr_r untouched) or side j's (2: w_l, pr_l), so
// a caller that stores one side's block at a time keeps one side's vectors.
template <int ND, typename T, int SIDES = 3>
__device__ __forceinline__ AusmFace<T> ausm_face(
    int nvar, double m_infty, const T* vfi, const T* vfj, const T* s_i,
    const T* s_j, const T* unit, T area, T* fo, T* w_l, T* w_r, T* pr_l,
    T* pr_r) {
  const int P_ = ND + 1, PRHO = ND + 2, A_ = ND + 4;
  const T KP = (T)0.25, SIGMA = (T)1, KU = (T)0.75, BETA = (T)0.125;
  T rho_i = vfi[PRHO], rho_j = vfj[PRHO], p_i = vfi[P_], p_j = vfj[P_];
  T proj_i = vfi[1] * unit[0], proj_j = vfj[1] * unit[0];
#pragma unroll
  for (int d = 1; d < ND; ++d) {
    proj_i = proj_i + vfi[1 + d] * unit[d];
    proj_j = proj_j + vfj[1 + d] * unit[d];
  }
  T a_mean = (T)0.5 * (vfi[A_] + vfj[A_]);
  T m_l = proj_i / a_mean, m_r = proj_j / a_mean;
  T m_f2 = (T)0.5 * (m_l * m_l + m_r * m_r);
  T minf2 = (T)(m_infty * m_infty);
  T m_ref2 = m_f2 > minf2 ? m_f2 : minf2;
  m_ref2 = m_ref2 < (T)1 ? m_ref2 : (T)1;
  T m_ref = sqrt(m_ref2);
  T fa = m_ref * ((T)2 - m_ref);
  T alpha = (T)(3.0 / 16.0) * ((T)5 * fa * fa - (T)4);
  T m_lp, m_lm, m_rp, m_rm, p_lp, p_lm, p_rp, p_rm;
  split_mach(m_l, m_lp, m_lm);
  split_mach(m_r, m_rp, m_rm);
  press_polys(m_l, alpha, p_lp, p_lm);
  press_polys(m_r, alpha, p_rp, p_rm);
  T rho_mean = (T)0.5 * (rho_i + rho_j);
  T factor = (T)1 - SIGMA * m_f2;
  factor = factor > (T)0 ? factor : (T)0;
  T dp = p_j - p_i;
  T m12 = m_lp + m_rm - KP / fa * factor * dp
                            / (rho_mean * a_mean * a_mean);
  T m_lf = (T)0.5 * (m12 + fabs(m12));
  T m_rf = (T)0.5 * (m12 - fabs(m12));
  T mass12 = a_mean * (m_lf * rho_i + m_rf * rho_j);
  T p_lf = p_lp * p_i + p_rm * p_j
         - KU * p_lp * p_rm * (rho_i + rho_j) * fa * a_mean
               * (proj_j - proj_i);
#pragma unroll
  for (int a = 0; a < nvar; ++a) {
    T pi_ = ausm_phi<ND>(vfi, a), pj_ = ausm_phi<ND>(vfj, a);
    fo[a] = (T)0.5 * (mass12 * (pi_ + pj_) + fabs(mass12) * (pi_ - pj_))
          * area;
  }
#pragma unroll
  for (int d = 0; d < ND; ++d)
    fo[1 + d] = fo[1 + d] + (p_lf * area) * unit[d];

  bool sub_l = fabs(m_l) < (T)1, sub_r = fabs(m_r) < (T)1;
  T safe_ml = m_l == (T)0 ? (T)1 : m_l;
  T safe_mr = m_r == (T)0 ? (T)1 : m_r;
  T pol_l = sub_l ? (T)0.5 * (m_l + (T)1)
                        + (T)4 * BETA * m_l * (m_l * m_l - (T)1)
                  : (T)0.5 * ((T)1 + fabs(m_l) / safe_ml);
  T pol_r = sub_r ? (T)0.5 * ((T)1 - m_r)
                        + (T)4 * BETA * m_r * ((T)1 - m_r * m_r)
                  : (T)0.5 * ((T)1 - fabs(m_r) / safe_mr);
  T m_f = sqrt(m_f2);
  bool at_ref = m_f2 == m_ref2;
  T safe_mf = m_f == (T)0 ? (T)1 : m_f;
  T sc_l = m_l * ((T)1 - m_f) / safe_mf;
  T sc_r = m_r * ((T)1 - m_f) / safe_mf;
  T fpos = factor > (T)0 ? (T)1 : (T)0;
  T c0 = KP / (a_mean * a_mean * fa * fa * rho_mean * rho_mean);
  T c1 = KP / (a_mean * a_mean * fa * rho_mean * rho_mean) * (T)0.5
       * factor * dp;
  T el_l = fpos * SIGMA * m_l * dp * fa * rho_mean;
  T el_r = fpos * SIGMA * m_r * (p_i - p_j) * fa * rho_mean;
  T es_ = factor * fa * rho_mean;
  T ec_ = factor * dp * rho_mean;
  T sign_m12 = m12 == (T)0 ? (T)0 : fabs(m12) / m12;
  T ml2 = m_l * m_l - (T)1, mr2 = m_r * m_r - (T)1;
  T pp_l = (T)0.25 * (m_l + (T)1)
         * ((T)3 * ((T)1 - m_l)
            + (T)4 * alpha * ((T)5 * m_l * m_l - (T)1) * (m_l - (T)1));
  T pp_r = (T)0.25 * (m_r - (T)1)
         * ((T)3 * ((T)1 + m_r)
            + (T)4 * alpha * ((T)1 - (T)5 * m_r * m_r) * (m_r + (T)1));
  T ps_l = (T)(15.0 / 8.0) * m_l * (ml2 * ml2);
  T ps_r = (T)(15.0 / 8.0) * m_r * (mr2 * mr2);
  T rho_sum = rho_i + rho_j;
  T dproj = proj_j - proj_i;
  T kl = KU * p_rm * a_mean, kr = KU * p_lp * a_mean;
  T x1 = rho_sum * fa * dproj;
  T xl = p_lp * rho_sum * dproj, xr = p_rm * rho_sum * dproj;
  T pr_l0 = KU * p_rm * a_mean * p_lp * fa
          * (dproj + rho_sum * proj_i / rho_i);
  T pr_r0 = KU * p_lp * a_mean * p_rm * fa
          * (dproj - rho_sum * proj_j / rho_j);
  T pv_l = -(KU * p_rm * a_mean * p_lp * fa * rho_sum / rho_i);
  T pv_r = KU * p_lp * a_mean * p_rm * fa * rho_sum / rho_j;
#pragma unroll
  for (int b = 0; b < nvar; ++b) {
    T mld = b == 0 ? -m_l / rho_i
                   : (b <= ND ? unit[b - 1] / (rho_i * a_mean) : (T)0);
    T mrd = b == 0 ? -m_r / rho_j
                   : (b <= ND ? unit[b - 1] / (rho_j * a_mean) : (T)0);
    T mpl = mld * pol_l, mpr = mrd * pol_r;
    T scl = at_ref ? mld * sc_l : (T)0;
    T scr = at_ref ? mrd * sc_r : (T)0;
    T mel = -c0 * (el_l * mld + es_ * s_i[b] + ec_ * scl);
    T mer = c0 * (el_r * mrd + es_ * s_j[b] - ec_ * scr);
    if (b == 0) {
      mel = mel + -c1;
      mer = mer + -c1;
    }
    if constexpr ((SIDES & 1) != 0) w_l[b] = (T)0.5 * (mpl - mel);
    if constexpr ((SIDES & 2) != 0) w_r[b] = (T)0.5 * (mpr - mer);
    T ppl = sub_l ? pp_l * mld + ps_l * scl : (T)0;
    T ppr = sub_r ? pp_r * mrd - ps_r * scr : (T)0;
    T pel = kl * (x1 * ppl + xl * scl);
    T per = kr * (x1 * ppr + xr * scr);
    if (b == 0) {
      pel = pel + pr_l0;
      per = per + pr_r0;
    } else if (b <= ND) {
      pel = pel + pv_l * unit[b - 1];
      per = per + pv_r * unit[b - 1];
    }
    if constexpr ((SIDES & 1) != 0) pr_l[b] = p_lp * s_i[b] + p_i * ppl - pel;
    if constexpr ((SIDES & 2) != 0) pr_r[b] = p_rm * s_j[b] + p_j * ppr - per;
  }
  return AusmFace<T>{a_mean, m_lf, m_rf, (T)1 + sign_m12, (T)1 - sign_m12};
}

// Entry (a, b) of side i's (side_j false: w = w_l, pr = pr_l, sv = s_i) or
// side j's Jacobian block, before the factor area; rpi, rpj = rho phi(a)
// of the two face states.
template <int ND, typename T>
__device__ __forceinline__ T ausm_jac_entry(const AusmFace<T>& f,
                                            bool side_j, int a, int b, T rpi,
                                            T rpj, const T* w, const T* pr,
                                            const T* sv, const T* unit) {
  T mlf = f.a_mean * (side_j ? f.m_rf : f.m_lf);
  T cj = f.a_mean * (rpi * (w[b] * f.sp) + rpj * (w[b] * f.sm));
  if (a == b) cj = cj + mlf;
  if (a == ND + 1) cj = cj + mlf * sv[b];
  if (a >= 1 && a <= ND) cj = cj + unit[a - 1] * pr[b];
  return cj;
}

}  // namespace su2k

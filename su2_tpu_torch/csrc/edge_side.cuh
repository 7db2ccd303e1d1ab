// The per-edge pipeline of the explicit interior edge flux, shared by
// kernel T3 (csrc/edge_flux.cu, one thread per family slot) and kernel K8
// (csrc/edge_win.cu, the same edges summed per node), so both run the same
// instructions.  Its species h/cp lookup and Stefan-Maxwell solve are also
// the viscous core of kernel K10 (csrc/edge_implicit.cu).  For the edge (p, p + o_k) of family k: AUSM+-up convective
// flux (numerics_direct_reactive.cpp:53-383), viscous flux with
// Stefan-Maxwell diffusion and the SST closure (:385-1684, closure
// :656-889), species h/cp at the face-mean temperature, and the convective
// and viscous spectral radii of SetTime_Step (solver_direct_reactive.cpp
// :5057).  The endpoint p + o_k wraps mod n, as torch.roll does; slots
// without an edge carry zero normals, so their flux and radii are zero.
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
// cp2[S] (each nt long).
template <typename T>
__device__ __forceinline__ void species_hcp(const Grid<T>& g,
                                            const T* __restrict__ tab,
                                            const T* __restrict__ mm, int ns,
                                            T t, T* hs, T* cps) {
  Bin<T> bn = spline_bin(g, t);
  for (int s = 0; s < ns; ++s) {
    hs[s] = spline_at(g, bn, tab + (size_t)s * g.nt,
                      tab + (size_t)(ns + s) * g.nt) / mm[s];
    cps[s] = spline_at(g, bn, tab + (size_t)(2 * ns + s) * g.nt,
                       tab + (size_t)(3 * ns + s) * g.nt) / mm[s];
  }
}

// Stefan-Maxwell diffusion fluxes: (Gamma + alpha y 1^T) Jd = -gxn
// (GetGamma, reacting_model_library.cpp:771-798, Solve_SM), Gamma from the
// separable Fuller form D_ab = gf / den[a, b], pivot-free Gauss-Jordan on
// the S x (S+1) system aug; Jd is left in aug[s * (S+1) + S].
template <typename T>
__device__ __forceinline__ void stefan_maxwell(int ns,
                                               const T* __restrict__ mm,
                                               const T* __restrict__ den,
                                               const T* ysc, const T* xs,
                                               T rho, T gf, const T* gxn,
                                               T* aug) {
  const int w = ns + 1;
  T sigma = (T)0, ym = (T)0;
  for (int s = 0; s < ns; ++s) {
    sigma += ysc[s];
    ym += ysc[s] / mm[s];
  }
  T mtot = (T)1 / ym;
  T prefg = sigma * mtot / (rho * gf);
  T den_min = den[0];
  for (int q = 1; q < ns * ns; ++q) den_min = den[q] < den_min ? den[q]
                                                               : den_min;
  T alpha_sm = den_min / (rho * gf);
  for (int a = 0; a < ns; ++a) {
    T sum_terms = (T)0;
    for (int b = 0; b < ns; ++b)
      sum_terms += (a == b ? (T)0 : den[a * ns + b]) * xs[b];
    T diag = prefg * sum_terms / mm[a];
    for (int b = 0; b < ns; ++b) {
      T gam = a == b ? diag
                     : -(prefg * xs[a]) * (den[a * ns + b] / mm[b]);
      aug[a * w + b] = gam + alpha_sm * ysc[a];
    }
    aug[a * w + ns] = -gxn[a];
  }
  for (int col = 0; col < ns; ++col) {
    T piv = aug[col * w + col];
    T safe = piv == (T)0 ? (T)1 : piv;
    for (int b = 0; b < w; ++b) aug[col * w + b] /= safe;
    for (int a = 0; a < ns; ++a) {
      if (a == col) continue;
      T fac = aug[a * w + col];
      for (int b = 0; b < w; ++b) aug[a * w + b] -= fac * aug[col * w + b];
    }
  }
}

// f: the feature-major stack (R, n); fam_normal/fam_evec (Kh, n, d); table
// rows (each nt long): h[S] h2[S] cp[S] cp2[S]; cst: mm[S] den[S*S].
// Writes flux = conv - visc (nVar) into fo and the two radii.
template <typename T>
__device__ __forceinline__ void edge_side(int n, const EdgeConsts& c,
                                          const Grid<T>& g,
                                          const T* __restrict__ f,
                                          const T* __restrict__ fam_normal,
                                          const T* __restrict__ fam_evec,
                                          const T* __restrict__ tab,
                                          const T* __restrict__ cst, int k,
                                          int p, T* fo, T& lc_o, T& lv_o) {
  int j = p + c.off[k];
  if (j >= n) j -= n;
  const int nd = c.nd, ns = c.ns;
  const int nprim = ns + nd + 5;
  const int P_ = nd + 1, PRHO = nd + 2, H_ = nd + 3, A_ = nd + 4, YS = nd + 5;
  const int ng = 1 + nd + ns;
  const int r_g = nprim, r_mu = r_g + ng * nd, r_ka = r_mu + 1;
  const int r_mut = r_ka + 1, r_tke = r_mut + 1, r_gk = r_tke + 1;
  const int r_gam = r_gk + nd, r_sk = r_gam + 1;
  const T tiny = sizeof(T) == 8 ? (T)1e-300 : (T)1e-30;
  const T* mm = cst;
  const T* den = cst + ns;

  auto fi = [&](int r) { return f[(size_t)r * n + p]; };
  auto fj = [&](int r) { return f[(size_t)r * n + j]; };

  T nm[SU2K_MAXD], ev[SU2K_MAXD];
  T area2 = (T)0;
  for (int d = 0; d < nd; ++d) {
    nm[d] = fam_normal[((size_t)k * n + p) * nd + d];
    ev[d] = fam_evec[((size_t)k * n + p) * nd + d];
    area2 += nm[d] * nm[d];
  }
  T area = sqrt(area2);

  T vi[SU2K_MAXS + SU2K_MAXD + 5], vj[SU2K_MAXS + SU2K_MAXD + 5];
  for (int r = 0; r < nprim; ++r) {
    vi[r] = fi(r);
    vj[r] = fj(r);
  }

  // ------------------------------------------------------- AUSM+-up
  const T KP = (T)0.25, SIGMA = (T)1, KU = (T)0.75;
  T unit[SU2K_MAXD];
  T asafe = area < tiny ? tiny : area;
  T proj_i = (T)0, proj_j = (T)0;
  for (int d = 0; d < nd; ++d) {
    unit[d] = nm[d] / asafe;
    proj_i += vi[1 + d] * unit[d];
    proj_j += vj[1 + d] * unit[d];
  }
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
  T out[SU2K_MAXS + SU2K_MAXD + 2];
  {
    auto conv = [&](T phi_i, T phi_j) {
      return (T)0.5 * (mass12 * (phi_i + phi_j)
                       + fabs(mass12) * (phi_i - phi_j)) * area;
    };
    out[0] = conv((T)1, (T)1);
    for (int d = 0; d < nd; ++d)
      out[1 + d] = conv(vi[1 + d], vj[1 + d]) + (p_lf * area) * unit[d];
    out[1 + nd] = conv(vi[H_], vj[H_]);
    for (int s = 0; s < ns; ++s)
      out[2 + nd + s] = conv(vi[YS + s], vj[YS + s]);
  }

  // ------------------------------------------------------- viscous
  T mu = harm(fi(r_mu), fj(r_mu));
  T ktr = harm(fi(r_ka), fj(r_ka));
  T gf = harm((T)1.0e-7 * pow(vi[0], (T)1.75) / (vi[P_] / (T)101325.0),
              (T)1.0e-7 * pow(vj[0], (T)1.75) / (vj[P_] / (T)101325.0));
  T vel[SU2K_MAXD];
  for (int d = 0; d < nd; ++d) vel[d] = (T)0.5 * (vi[1 + d] + vj[1 + d]);
  T rho = (T)0.5 * (rho_i + rho_j);
  T ysc[SU2K_MAXS], xs[SU2K_MAXS];
  {
    T ysum = (T)0, xsum = (T)0;
    for (int s = 0; s < ns; ++s) {
      ysc[s] = clip_y((T)0.5 * (vi[YS + s] + vj[YS + s]));
      xs[s] = ysc[s] / mm[s];
      ysum += ysc[s];
      xsum += xs[s];
    }
    for (int s = 0; s < ns; ++s) xs[s] = xs[s] * (ysum / xsum);
  }

  T gm[SU2K_MAXG * SU2K_MAXD];
  for (int q = 0; q < ng * nd; ++q)
    gm[q] = (T)0.5 * (fi(r_g + q) + fj(r_g + q));
  {
    // edge-projection correction (CAvgGradReactive_Flow, :1507-1527)
    T dist2 = (T)0;
    for (int d = 0; d < nd; ++d) dist2 += ev[d] * ev[d];
    dist2 = dist2 > tiny ? dist2 : tiny;
    T xi[SU2K_MAXS], xj[SU2K_MAXS];
    T si = (T)0, sxi = (T)0, sj = (T)0, sxj = (T)0;
    for (int s = 0; s < ns; ++s) {
      T yi = clip_y(vi[YS + s]), yj = clip_y(vj[YS + s]);
      xi[s] = yi / mm[s];
      xj[s] = yj / mm[s];
      si += yi; sxi += xi[s]; sj += yj; sxj += xj[s];
    }
    for (int q = 0; q < ng; ++q) {
      T diff;
      if (q == 0) diff = vj[0] - vi[0];
      else if (q <= nd) diff = vj[q] - vi[q];
      else {
        int s = q - 1 - nd;
        diff = xj[s] * (sj / sxj) - xi[s] * (si / sxi);
      }
      T proj = gm[q * nd] * ev[0];
      for (int d = 1; d < nd; ++d) proj += gm[q * nd + d] * ev[d];
      T cf = (proj - diff) / dist2;
      for (int d = 0; d < nd; ++d) gm[q * nd + d] -= cf * ev[d];
    }
  }
  const T* g_t = gm;
  const T* g_vel = gm + nd;            // [a * nd + b]
  const T* g_xs = gm + (1 + nd) * nd;  // [s * nd + d]
  T div = g_vel[0];
  for (int d = 1; d < nd; ++d) div += g_vel[d * nd + d];
  const T TWO3 = (T)(2.0 / 3.0);

  // Stefan-Maxwell: (Gamma + alpha y 1^T) Jd = -grad(X).N, Gauss-Jordan
  T gxn[SU2K_MAXS];
  for (int s = 0; s < ns; ++s) {
    T acc = g_xs[s * nd] * nm[0];
    for (int d = 1; d < nd; ++d) acc += g_xs[s * nd + d] * nm[d];
    gxn[s] = acc;
  }
  T aug[SU2K_MAXS * (SU2K_MAXS + 1)];
  const int w = ns + 1;
  stefan_maxwell(ns, mm, den, ysc, xs, rho, gf, gxn, aug);
  T e_heat = (T)0, jsum = (T)0;
  T hs[SU2K_MAXS], cps[SU2K_MAXS];
  species_hcp(g, tab, mm, ns, (T)0.5 * (vi[0] + vj[0]), hs, cps);
  for (int s = 0; s < ns; ++s) {
    T jd = aug[s * w + ns];
    e_heat -= hs[s] * jd;
    jsum += jd;
  }
  T mu_t = harm(fi(r_mut), fj(r_mut));
  T tke = (T)0.5 * (fi(r_tke) + fj(r_tke));
  T mom[SU2K_MAXD];
  T e_tau = (T)0;
  for (int b = 0; b < nd; ++b) mom[b] = (T)0;
  for (int a = 0; a < nd; ++a)
    for (int b = 0; b < nd; ++b) {
      T sym = g_vel[a * nd + b] + g_vel[b * nd + a];
      T tau = mu * sym - (a == b ? TWO3 * mu * div : (T)0);
      T taut = mu_t * sym
             - (a == b ? TWO3 * (mu_t * div + tke * rho) : (T)0);
      mom[b] += (tau + taut) * nm[a];
      e_tau += (tau + taut) * vel[b] * nm[a];
    }
  T gtn = g_t[0] * nm[0];
  for (int d = 1; d < nd; ++d) gtn += g_t[d] * nm[d];
  T e_cond = ktr * gtn;

  // molar -> mass gradient operator, rank-2 Woodbury solve (:855-880)
  T cmt = mu_t / (T)(c.pr_turb * c.le_turb);
  T gyn[SU2K_MAXS];
  {
    T mms = (T)c.mm_sum;
    T sigx = (T)0;
    for (int s = 0; s < ns; ++s) sigx += xs[s];
    T g11 = (T)1, g12 = (T)0, g21 = (T)0, g22 = (T)1;
    T du[SU2K_MAXS], dw[SU2K_MAXS], dinv[SU2K_MAXS];
    for (int s = 0; s < ns; ++s) {
      dinv[s] = mm[s] / (mms * sigx);
      du[s] = dinv[s] * (mms * ysc[s] / mm[s]);
      dw[s] = dinv[s] * (-mms * xs[s]);
      g11 += du[s];
      g12 += dw[s];
      g21 += du[s] / mm[s];
      g22 += dw[s] / mm[s];
    }
    T det = g11 * g22 - g12 * g21;
    det = det == (T)0 ? (T)1 : det;
    for (int s = 0; s < ns; ++s) gyn[s] = (T)0;
    for (int d = 0; d < nd; ++d) {
      T c1 = (T)0, c2 = (T)0;
      for (int s = 0; s < ns; ++s) {
        T db = dinv[s] * g_xs[s * nd + d];
        c1 += db;
        c2 += db / mm[s];
      }
      T a1 = (g22 * c1 - g12 * c2) / det;
      T a2 = (g11 * c2 - g21 * c1) / det;
      for (int s = 0; s < ns; ++s) {
        T gxs = g_xs[s * nd + d];
        T gy = dinv[s] * gxs - du[s] * a1 - dw[s] * a2;
        gy = fabs(gxs) < (T)1e-8 ? (T)0 : gy;
        gyn[s] += gy * nm[d];
      }
    }
  }
  T hy = (T)0, cpy = (T)0;
  for (int s = 0; s < ns; ++s) {
    hy += hs[s] * ysc[s] * gyn[s];
    cpy += cps[s] * ysc[s];
  }
  e_heat += cmt * hy;
  e_cond += (mu_t / (T)c.pr_turb) * cpy * gtn;
  T gkn = (T)0;
  for (int d = 0; d < nd; ++d)
    gkn += (T)0.5 * (fi(r_gk + d) + fj(r_gk + d)) * nm[d];
  e_cond += (mu + mu_t / fi(r_sk)) * gkn;

  // flux = conv - visc
  fo[0] = out[0] - (-jsum);
  for (int d = 0; d < nd; ++d) fo[1 + d] = out[1 + d] - mom[d];
  fo[1 + nd] = out[1 + nd] - (e_tau + e_cond + e_heat);
  for (int s = 0; s < ns; ++s)
    fo[2 + nd + s] = out[2 + nd + s] - (-aug[s * w + ns] + cmt * gyn[s]);

  // spectral radii (max_lambda_inv + viscous_lambda terms)
  T pr = (T)0;
  for (int d = 0; d < nd; ++d) pr += (vi[1 + d] + vj[1 + d]) * nm[d];
  lc_o = (fabs((T)0.5 * pr) + a_mean) * area;
  T mean_mu = (T)0.5 * (fi(r_mu) + fj(r_mu));
  T mean_mut = (T)0.5 * (fi(r_mut) + fj(r_mut));
  T lam1 = (T)(4.0 / 3.0) * (mean_mu + mean_mut);
  T lam2 = ((T)1 + (T)(c.pr_lam / c.pr_turb) * (mean_mut / mean_mu))
         * (fi(r_gam) * mean_mu / (T)c.pr_lam);
  lv_o = (lam1 + lam2) * area * area / rho_mean;
}

}  // namespace su2k

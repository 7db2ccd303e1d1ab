// K10: interior edge terms of the implicit reactive RANS system.  Per edge
// (p, p + o_k) of each stencil family k: the face states (MUSCL with or
// without the limiter, h/a/dP/dU re-evaluated from the species tables at
// the face temperature; first order: the node states), the AUSM+-up flux
// and both its Jacobians on them (numerics_direct_reactive.cpp:53-383), and
// the viscous flux with Stefan-Maxwell diffusion and the SST closure and
// both its approximate Jacobians on the node states (:385-1684,
// SetLaminarViscousProjJacs :1200-1409, SST_Reactive_JacobianClosure
// :891-1097), 2D.  Writes flux = conv - visc (Kh, nVar, N) and the blocks
// j_i, j_j = conv_jac - visc_jac (Kh, nVar^2, N), row a*nVar + b, lanes =
// slot p, so the stores of a warp coalesce.
//
// Replaces su2_tpu/pallas/edge_fused.py:721 fused_edge_implicit_pallas
// (via fused_implicit_family_terms :868).  The TPU kernel takes f_j as a
// host-side roll of the stack and runs one launch per family; here one
// launch covers every family, each thread reading columns p and p + o_k
// of the stack itself.  The arithmetic follows the plain version
// (ops/edge_implicit.py edge_implicit_plain) operation by operation,
// including the effective diffusion's sum_{k!=s} x_k in place of 1 - x_s
// (ops/viscous_t.py).
//
// Bound on the H100: bytes, by roofline: an edge reads 2 x 79 stack values
// and writes 13 + 2 x 169 (~2.1 KB in f32) against ~12 kFLOP.  Design:
// one thread per (family, slot); the two 169-entry Jacobian blocks never
// sit in registers: the per-column vectors of the AUSM Jacobians (mass and
// pressure parts, 6 x nVar) and the sparse viscous dF/dV (a dense energy
// row, the momentum and the species blocks) are kept, and each output row
// of j_i and j_j is formed from them and stored at once.  The S x (S+1)
// Stefan-Maxwell system and the work vectors live in local memory, which
// sets the time (the ptxas summary in chip_smoke.py reports the spills).
// Pad slots carry zero normals, so every output there is exactly zero.
#include "edge_side.cuh"

namespace su2k {

constexpr int IMP_ND = 2;

struct ImpConsts {
  double m_infty, pr_turb, le_turb, mm_sum;
  int ns, kh;
  int off[SU2K_MAXK];
};

// one side's face state vf (nPrim) and its dP/dU row s (nVar) from the
// stack column f (stride n); dxs = +-0.5 (side i: +, side j: -)
template <typename T, bool MUSCL, bool LIMITER>
__device__ __forceinline__ void face_state(const ImpConsts& c,
                                           const Grid<T>& g,
                                           const T* __restrict__ f, int n,
                                           int col, const T* ev, T dxs,
                                           const T* __restrict__ tab,
                                           const T* __restrict__ mm,
                                           const T* __restrict__ ri, T* vf,
                                           T* s) {
  const int ns = c.ns, nd = IMP_ND;
  const int nprim = ns + nd + 5, nvar = ns + nd + 2;
  const int P_ = nd + 1, PRHO = nd + 2, A_ = nd + 4, YS = nd + 5;
  const int ng = 2 + nd + ns;
  const int r_g = nprim, r_lim = r_g + ng * nd;
  const int r_dpdu = r_lim + (2 + nd) + 5 + nd + nvar;
  auto at = [&](int r) { return f[(size_t)r * n + col]; };
  for (int r = 0; r < nprim; ++r) vf[r] = at(r);
  if (!MUSCL) {
    for (int r = 0; r < nvar; ++r) s[r] = at(r_dpdu + r);
    return;
  }
  const T EPS = (T)1e-16;
  T dx[IMP_ND];
  for (int d = 0; d < nd; ++d) dx[d] = dxs * ev[d];
  T qr[2 + IMP_ND];
  for (int q = 0; q < 2 + nd; ++q) {
    // [T, u, v, P]: stack rows 0, 1, 2 and P_ = 3
    T proj = at(r_g + q * nd) * dx[0];
    for (int d = 1; d < nd; ++d) proj = proj + at(r_g + q * nd + d) * dx[d];
    if (LIMITER) proj = proj * at(r_lim + q);
    qr[q] = vf[q] + proj;
  }
  T t_r = qr[0], p_r = qr[1 + nd];
  bool bad = (t_r <= EPS) || (p_r <= EPS);
  T t_face = bad ? vf[0] : t_r;
  T hs[SU2K_MAXS], cps[SU2K_MAXS];
  species_hcp(g, tab, mm, ns, t_face, hs, cps);
  T rgas = (T)0, hmix = (T)0, cpmix = (T)0;
  for (int k = 0; k < ns; ++k) {
    T y = clip_y(vf[YS + k]);
    rgas = k ? rgas + y * ri[k] : y * ri[k];
    hmix = k ? hmix + y * hs[k] : y * hs[k];
    cpmix = k ? cpmix + y * cps[k] : y * cps[k];
  }
  T ke = qr[1] * qr[1];
  for (int d = 1; d < nd; ++d) ke = ke + qr[1 + d] * qr[1 + d];
  hmix = hmix + (T)0.5 * ke;
  T gamma_r = cpmix / (cpmix - rgas);
  T rho_r = p_r / (rgas * t_r);
  T a_r = sqrt(fabs(gamma_r * p_r / rho_r));
  if (!bad) {
    vf[0] = t_r;
    for (int d = 0; d < nd; ++d) vf[1 + d] = qr[1 + d];
    vf[P_] = p_r;
    vf[PRHO] = rho_r;
    vf[nd + 3] = hmix;
    vf[A_] = a_r;
  }
  // dP/dU of the face state (euler.ghost_dpdu, gamma = a^2 rho / P)
  T gam = vf[A_] * vf[A_] * vf[PRHO] / vf[P_];
  T vel2 = vf[1] * vf[1];
  for (int d = 1; d < nd; ++d) vel2 = vel2 + vf[1 + d] * vf[1 + d];
  s[0] = (gam - (T)1) * (T)0.5 * vel2;
  for (int d = 0; d < nd; ++d) s[1 + d] = ((T)1 - gam) * vf[1 + d];
  s[1 + nd] = gam - (T)1;
  for (int k = 0; k < ns; ++k) {
    T e_s = hs[k] - ri[k] * t_face;
    s[2 + nd + k] = ri[k] * t_face - (gam - (T)1) * e_s;
  }
}

// mole fractions of mass fractions y (clipped), x_s = (y_s/M_s) (sum y /
// sum y/M)
template <typename T>
__device__ __forceinline__ void molar(int ns, const T* __restrict__ mm,
                                      const T* y, T* x) {
  T ysum = (T)0, xsum = (T)0;
  for (int s = 0; s < ns; ++s) {
    T yc = clip_y(y[s]);
    x[s] = yc / mm[s];
    ysum += yc;
    xsum += x[s];
  }
  T r = ysum / xsum;
  for (int s = 0; s < ns; ++s) x[s] = x[s] * r;
}

template <typename T, bool MUSCL, bool LIMITER>
__global__ void __launch_bounds__(128)
edge_implicit_kernel(int n, ImpConsts c, Grid<T> g, const T* __restrict__ f,
                     const T* __restrict__ fam_normal,
                     const T* __restrict__ fam_evec,
                     const T* __restrict__ tab, const T* __restrict__ cst,
                     T* __restrict__ flux, T* __restrict__ ji,
                     T* __restrict__ jj) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)c.kh * n) return;
  const int k = (int)(idx / n);
  const int p = (int)(idx - (long long)k * n);
  int q_ = p + c.off[k];
  if (q_ >= n) q_ -= n;
  const int jcol = q_;
  const int ns = c.ns, nd = IMP_ND;
  const int nprim = ns + nd + 5, nvar = ns + nd + 2;
  const int P_ = nd + 1, PRHO = nd + 2, H_ = nd + 3, A_ = nd + 4;
  const int YS = nd + 5;
  const int RHOE = nd + 1, RHOS = nd + 2;
  const int ng = 2 + nd + ns;
  const int r_g = nprim, r_lim = r_g + ng * nd, r_mu = r_lim + 2 + nd;
  const int r_ka = r_mu + 1, r_mut = r_ka + 1, r_tke = r_mut + 1;
  const int r_gk = r_tke + 1, r_sk = r_gk + nd, r_dtdu = r_sk + 1;
  const T tiny = sizeof(T) == 8 ? (T)1e-300 : (T)1e-30;
  const T* mm = cst;
  const T* den = cst + ns;
  const T* ri = cst + ns + ns * ns;
  auto fi = [&](int r) { return f[(size_t)r * n + p]; };
  auto fj = [&](int r) { return f[(size_t)r * n + jcol]; };

  T nm[IMP_ND], ev[IMP_ND];
  for (int d = 0; d < nd; ++d) {
    nm[d] = fam_normal[((size_t)k * n + p) * nd + d];
    ev[d] = fam_evec[((size_t)k * n + p) * nd + d];
  }
  T area = sqrt(nm[0] * nm[0] + nm[1] * nm[1]);
  T area_s = area > tiny ? area : tiny;
  T unit[IMP_ND];
  for (int d = 0; d < nd; ++d) unit[d] = nm[d] / area_s;

  // ------------------------------------------------ AUSM+-up on the faces
  const T KP = (T)0.25, SIGMA = (T)1, KU = (T)0.75, BETA = (T)0.125;
  T vfi[SU2K_MAXS + 7], vfj[SU2K_MAXS + 7];
  T s_i[SU2K_MAXV], s_j[SU2K_MAXV];
  face_state<T, MUSCL, LIMITER>(c, g, f, n, p, ev, (T)0.5, tab, mm, ri, vfi,
                                s_i);
  face_state<T, MUSCL, LIMITER>(c, g, f, n, jcol, ev, (T)-0.5, tab, mm, ri,
                                vfj, s_j);
  T rho_i = vfi[PRHO], rho_j = vfj[PRHO], p_i = vfi[P_], p_j = vfj[P_];
  T proj_i = vfi[1] * unit[0] + vfi[2] * unit[1];
  T proj_j = vfj[1] * unit[0] + vfj[2] * unit[1];
  T a_mean = (T)0.5 * (vfi[A_] + vfj[A_]);
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
  T dp = p_j - p_i;
  T m12 = m_lp + m_rm - KP / fa * factor * dp
                            / (rho_mean * a_mean * a_mean);
  T m_lf = (T)0.5 * (m12 + fabs(m12));
  T m_rf = (T)0.5 * (m12 - fabs(m12));
  T mass12 = a_mean * (m_lf * rho_i + m_rf * rho_j);
  T p_lf = p_lp * p_i + p_rm * p_j
         - KU * p_lp * p_rm * (rho_i + rho_j) * fa * a_mean
               * (proj_j - proj_i);
  auto phi = [&](const T* v, int a) {
    return a == 0 ? (T)1 : (a <= nd ? v[a] : (a == RHOE ? v[H_]
                                                       : v[YS + a - RHOS]));
  };
  T fo[SU2K_MAXV];
  for (int a = 0; a < nvar; ++a) {
    T pi_ = phi(vfi, a), pj_ = phi(vfj, a);
    fo[a] = (T)0.5 * (mass12 * (pi_ + pj_) + fabs(mass12) * (pi_ - pj_))
          * area;
  }
  for (int d = 0; d < nd; ++d) fo[1 + d] = fo[1 + d] + (p_lf * area) * unit[d];

  // Jacobian column vectors (ops/ausm_t._jacobians)
  T mpld[SU2K_MAXV], mmld[SU2K_MAXV], mprd[SU2K_MAXV], mmrd[SU2K_MAXV];
  T prld[SU2K_MAXV], prrd[SU2K_MAXV];
  {
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
    T sp = (T)1 + sign_m12, sm = (T)1 - sign_m12;
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
    for (int b = 0; b < nvar; ++b) {
      T mld = b == 0 ? -m_l / rho_i
                     : (b <= nd ? unit[b - 1] / (rho_i * a_mean) : (T)0);
      T mrd = b == 0 ? -m_r / rho_j
                     : (b <= nd ? unit[b - 1] / (rho_j * a_mean) : (T)0);
      T mpl = mld * pol_l, mpr = mrd * pol_r;
      T scl = at_ref ? mld * sc_l : (T)0;
      T scr = at_ref ? mrd * sc_r : (T)0;
      T mel = -c0 * (el_l * mld + es_ * s_i[b] + ec_ * scl);
      T mer = c0 * (el_r * mrd + es_ * s_j[b] - ec_ * scr);
      if (b == 0) {
        mel = mel + -c1;
        mer = mer + -c1;
      }
      mpld[b] = (T)0.5 * (mpl - mel) * sp;
      mmld[b] = (T)0.5 * (mpl - mel) * sm;
      mprd[b] = (T)0.5 * (mpr - mer) * sp;
      mmrd[b] = (T)0.5 * (mpr - mer) * sm;
      T ppl = sub_l ? pp_l * mld + ps_l * scl : (T)0;
      T ppr = sub_r ? pp_r * mrd - ps_r * scr : (T)0;
      T pel = kl * (x1 * ppl + xl * scl);
      T per = kr * (x1 * ppr + xr * scr);
      if (b == 0) {
        pel = pel + pr_l0;
        per = per + pr_r0;
      } else if (b <= nd) {
        pel = pel + pv_l * unit[b - 1];
        per = per + pv_r * unit[b - 1];
      }
      prld[b] = p_lp * s_i[b] + p_i * ppl - pel;
      prrd[b] = p_rm * s_j[b] + p_j * ppr - per;
    }
  }

  // ------------------------------------------------ viscous (node states)
  T vi[SU2K_MAXS + 7], vj[SU2K_MAXS + 7];
  for (int r = 0; r < nprim; ++r) {
    vi[r] = fi(r);
    vj[r] = fj(r);
  }
  T mu = harm(fi(r_mu), fj(r_mu));
  T ktr = harm(fi(r_ka), fj(r_ka));
  T f_i = (T)1.0e-7 * pow(vi[0], (T)1.75) / (vi[P_] / (T)101325.0);
  T f_j = (T)1.0e-7 * pow(vj[0], (T)1.75) / (vj[P_] / (T)101325.0);
  T gf = harm(f_i, f_j);
  T vel[IMP_ND];
  for (int d = 0; d < nd; ++d) vel[d] = (T)0.5 * (vi[1 + d] + vj[1 + d]);
  T rho = (T)0.5 * (vi[PRHO] + vj[PRHO]);
  T ysc[SU2K_MAXS], xs[SU2K_MAXS], xs_i[SU2K_MAXS], xs_j[SU2K_MAXS];
  {
    T ym[SU2K_MAXS];
    for (int s = 0; s < ns; ++s) {
      ym[s] = (T)0.5 * (vi[YS + s] + vj[YS + s]);
      ysc[s] = clip_y(ym[s]);
    }
    molar(ns, mm, ym, xs);
    molar(ns, mm, vi + YS, xs_i);
    molar(ns, mm, vj + YS, xs_j);
  }
  // mean gradients of [T, u, v, X..] (the pressure row 1 + nd dropped),
  // corrected along the edge (CAvgGradReactive_Flow, :1507-1527)
  const int gv = 1 + nd + ns;
  T gm[SU2K_MAXG * IMP_ND];
  T dist2 = ev[0] * ev[0] + ev[1] * ev[1];
  dist2 = dist2 > tiny ? dist2 : tiny;
  for (int q = 0; q < gv; ++q) {
    int qs = q <= nd ? q : q + 1;
    T gq[IMP_ND];
    for (int d = 0; d < nd; ++d)
      gq[d] = (T)0.5 * (fi(r_g + qs * nd + d) + fj(r_g + qs * nd + d));
    T diff = q == 0 ? vj[0] - vi[0]
                    : (q <= nd ? vj[q] - vi[q]
                               : xs_j[q - 1 - nd] - xs_i[q - 1 - nd]);
    T proj = gq[0] * ev[0] + gq[1] * ev[1];
    T cf = (proj - diff) / dist2;
    for (int d = 0; d < nd; ++d) gm[q * nd + d] = gq[d] - cf * ev[d];
  }
  const T* g_t = gm;
  const T* g_vel = gm + nd;            // [a * nd + b]
  const T* g_xs = gm + (1 + nd) * nd;  // [s * nd + d]
  T div = g_vel[0] + g_vel[nd + 1];
  const T TWO3 = (T)(2.0 / 3.0);
  T gxn[SU2K_MAXS];
  for (int s = 0; s < ns; ++s)
    gxn[s] = g_xs[s * nd] * nm[0] + g_xs[s * nd + 1] * nm[1];
  T jd[SU2K_MAXS];
  {
    T aug[SU2K_MAXS * (SU2K_MAXS + 1)];
    stefan_maxwell(ns, mm, den, ysc, xs, rho, gf, gxn, aug);
    for (int s = 0; s < ns; ++s) jd[s] = aug[s * (ns + 1) + ns];
  }
  T hs[SU2K_MAXS], cps[SU2K_MAXS];
  species_hcp(g, tab, mm, ns, (T)0.5 * (vi[0] + vj[0]), hs, cps);
  T e_heat = (T)0, jsum = (T)0;
  for (int s = 0; s < ns; ++s) {
    e_heat -= hs[s] * jd[s];
    jsum += jd[s];
  }
  T mu_t = harm(fi(r_mut), fj(r_mut));
  T tke = (T)0.5 * (fi(r_tke) + fj(r_tke));
  T mom[IMP_ND] = {(T)0, (T)0};
  T e_tau = (T)0;
  for (int a = 0; a < nd; ++a)
    for (int b = 0; b < nd; ++b) {
      T sym = g_vel[a * nd + b] + g_vel[b * nd + a];
      T tau = mu * sym - (a == b ? TWO3 * mu * div : (T)0);
      T taut = mu_t * sym
             - (a == b ? TWO3 * (mu_t * div + tke * rho) : (T)0);
      mom[b] += (tau + taut) * nm[a];
      e_tau += (tau + taut) * vel[b] * nm[a];
    }
  T gtn = g_t[0] * nm[0] + g_t[1] * nm[1];
  T e_cond = ktr * gtn;
  // molar -> mass gradient operator, rank-2 Woodbury solve (:855-880)
  T cmt = mu_t / (T)(c.pr_turb * c.le_turb);
  T gy[SU2K_MAXS * IMP_ND], gyn[SU2K_MAXS];
  {
    T mms = (T)c.mm_sum;
    T sigx = (T)0;
    for (int s = 0; s < ns; ++s) sigx += xs[s];
    T g11 = (T)0, g12 = (T)0, g21 = (T)0, g22 = (T)0;
    T du[SU2K_MAXS], dw[SU2K_MAXS], dinv[SU2K_MAXS];
    for (int s = 0; s < ns; ++s) {
      dinv[s] = mm[s] / (mms * sigx);
      du[s] = dinv[s] * (mms * ysc[s] / mm[s]);
      dw[s] = dinv[s] * (-mms * xs[s]);
      g11 += du[s];
      g12 += dw[s];
      g21 += (T)1 / mm[s] * du[s];
      g22 += (T)1 / mm[s] * dw[s];
    }
    g11 = (T)1 + g11;
    g22 = (T)1 + g22;
    T det = g11 * g22 - g12 * g21;
    det = det == (T)0 ? (T)1 : det;
    for (int d = 0; d < nd; ++d) {
      T c1 = (T)0, c2 = (T)0;
      T db[SU2K_MAXS];
      for (int s = 0; s < ns; ++s) {
        db[s] = dinv[s] * g_xs[s * nd + d];
        c1 += db[s];
        c2 += (T)1 / mm[s] * db[s];
      }
      T a1 = (g22 * c1 - g12 * c2) / det;
      T a2 = (g11 * c2 - g21 * c1) / det;
      for (int s = 0; s < ns; ++s) {
        T v = db[s] - du[s] * a1 - dw[s] * a2;
        gy[s * nd + d] = fabs(g_xs[s * nd + d]) < (T)1e-8 ? (T)0 : v;
      }
    }
    for (int s = 0; s < ns; ++s)
      gyn[s] = gy[s * nd] * nm[0] + gy[s * nd + 1] * nm[1];
  }
  T hy = (T)0, cpy = (T)0;
  for (int s = 0; s < ns; ++s) {
    hy += hs[s] * ysc[s] * gyn[s];
    cpy += cps[s] * ysc[s];
  }
  e_heat += cmt * hy;
  e_cond += (mu_t / (T)c.pr_turb) * cpy * gtn;
  T gkn = (T)0.5 * (fi(r_gk) + fj(r_gk)) * nm[0]
        + (T)0.5 * (fi(r_gk + 1) + fj(r_gk + 1)) * nm[1];
  e_cond += (mu + mu_t / fi(r_sk)) * gkn;
  T vfl[SU2K_MAXV];
  vfl[0] = -jsum;
  for (int d = 0; d < nd; ++d) vfl[1 + d] = mom[d];
  vfl[RHOE] = e_tau + e_cond + e_heat;
  for (int s = 0; s < ns; ++s) vfl[RHOS + s] = -jd[s] + cmt * gyn[s];

  T* fout = flux + (size_t)k * nvar * n + p;
  for (int a = 0; a < nvar; ++a) fout[(size_t)a * n] = fo[a] - vfl[a];

  // ---------------------------------- viscous Jacobian, dF/dV (sparse)
  T dist = sqrt(dist2);
  T ds[SU2K_MAXS];
  for (int s = 0; s < ns; ++s) {
    T dsd = (T)0;
    for (int side = 0; side < 2; ++side) {
      const T* xx = side ? xs_j : xs_i;
      T fside = side ? f_j : f_i;
      T q = (T)0, rest = (T)0;
      for (int kk = 0; kk < ns; ++kk) {
        if (kk == s) continue;
        q += den[s * ns + kk] * xx[kk];
        rest += xx[kk];
      }
      T d_ = fside * rest / (q == (T)0 ? (T)1 : q);
      d_ = (q == (T)0 || !isfinite(d_)) ? (T)0 : d_;
      dsd = side ? dsd + d_ : d_;
    }
    ds[s] = (T)0.5 * dsd;
  }
  T tot_mass = (T)0, tot_i = (T)0, tot_j = (T)0, sig_i = (T)0, sig_j = (T)0;
  T smx_i = (T)0, smx_j = (T)0, smg = (T)0;
  for (int s = 0; s < ns; ++s) {
    tot_mass += mm[s] * xs[s];
    tot_i += mm[s] * xs_i[s];
    tot_j += mm[s] * xs_j[s];
    sig_i += xs_i[s];
    sig_j += xs_j[s];
    T mds = mm[s] * ds[s];
    smx_i += mds * xs_i[s];
    smx_j += mds * xs_j[s];
    smg += mds * (gxn[s] / area_s);
  }
  T rvi = vi[PRHO], rvj = vj[PRHO];
  // dJ/dr (reference :1260-1293): dj[s][k] = sgn (t12[s] + y_s t3[k])
  // (+ sgn (-ds_s ck) + extra on the diagonal)
  T c_i = rho / (tot_mass * dist * sig_i * rvi);
  T c_j = rho / (tot_mass * dist * sig_j * rvj);
  T ck_i = rho * tot_i * sig_i / (dist * tot_mass * rvi);
  T ck_j = rho * tot_j * sig_j / (dist * tot_mass * rvj);
  T ex_i = (T)0.5 * rho / (tot_mass * rvi) * smg;
  T ex_j = (T)0.5 * rho / (tot_mass * rvj) * smg;
  auto djdr = [&](int side, int s, int kk) {
    const T* xx = side ? xs_j : xs_i;
    T cc = side ? c_j : c_i, ck = side ? ck_j : ck_i;
    T smx = side ? smx_j : smx_i, sgn = side ? (T)1 : (T)-1;
    T t12 = -(mm[s] * ds[s]) * xx[s] * cc + ysc[s] * (smx * cc);
    T v = sgn * (t12 + ysc[s] * (ds[kk] * ck));
    if (kk == s) v = v + sgn * (-ds[s] * ck) + (side ? ex_j : ex_i);
    return v;
  };
  T theta = unit[0] * unit[0] + unit[1] * unit[1];
  T M[IMP_ND][IMP_ND], piv[IMP_ND];
  for (int d = 0; d < nd; ++d)
    for (int e = 0; e < nd; ++e)
      M[d][e] = d == e ? theta + unit[d] * unit[d] / (T)3
                       : unit[d] * unit[e] / (T)3;
  for (int d = 0; d < nd; ++d) piv[d] = vel[0] * M[d][0] + vel[1] * M[d][1];
  T coef = mu / dist * area, coef_t = mu_t / dist * area;
  T jd_cp = (T)0;
  for (int s = 0; s < ns; ++s) jd_cp += jd[s] * cps[s];
  jd_cp = (T)-0.5 * jd_cp;
  T aux_c = (T)0;
  for (int s = 0; s < ns; ++s)
    aux_c += cps[s] * ysc[s] * (gy[s * nd] * unit[0] + gy[s * nd + 1]
                                * unit[1]);
  T com = cmt * aux_c * area;
  T ce = cmt / dist * area * theta;
  T e_ee = ktr * theta / dist * area;
  T add_ee = mu_t / (T)c.pr_turb * cpy * theta / dist * area;

  // per side: the energy row of dF/dV and the density row (species
  // columns); the species block is djdr itself
  T erow[2][SU2K_MAXV], rrow[2][SU2K_MAXS];
  for (int side = 0; side < 2; ++side) {
    T sg = side ? (T)1 : (T)-1;
    T* er = erow[side];
    for (int d = 0; d < nd; ++d) {
      T hm = (T)0.5 * vfl[1 + d];
      er[1 + d] = (side ? coef * piv[d] : -(coef * piv[d]))
                + (side ? coef_t * piv[d] : -(coef_t * piv[d])) + hm;
    }
    er[RHOE] = (side ? e_ee : -e_ee) + jd_cp + (side ? add_ee : -add_ee)
             + com;
    for (int kk = 0; kk < ns; ++kk) {
      T col_rho = (T)0, col_e = (T)0;
      for (int s = 0; s < ns; ++s) {
        T val = -djdr(side, s, kk) * area;
        col_rho = s ? col_rho + val : val;
        col_e = s ? col_e + val * hs[s] : val * hs[s];
      }
      rrow[side][kk] = col_rho;
      T rs = side ? rvj : rvi;
      er[RHOS + kk] = col_e + sg * ce * hs[kk] * ysc[kk] / rs;
    }
  }

  // ---------------- output rows: j = conv_jac - dF/dV . dV/dU, per side
  for (int side = 0; side < 2; ++side) {
    const T* vr = side ? vj : vi;
    T rl = vr[PRHO];
    T* jout = (side ? jj : ji) + (size_t)k * nvar * nvar * n + p;
    const T* sv = side ? s_j : s_i;       // face dP/dU
    const T* mp = side ? mprd : mpld;
    const T* mq = side ? mmrd : mmld;
    const T* pr = side ? prrd : prld;
    T mlf = a_mean * (side ? m_rf : m_lf);
    T sdt[SU2K_MAXV];
    for (int b = 0; b < nvar; ++b)
      sdt[b] = side ? fj(r_dtdu + b) : fi(r_dtdu + b);
    T sg = side ? (T)1 : (T)-1;
    for (int a = 0; a < nvar; ++a) {
      T rpi = rho_i * phi(vfi, a), rpj = rho_j * phi(vfj, a);
      // this row of dF/dV . dV/dU
      T vjr[SU2K_MAXV];
      if (a == 0) {
        for (int b = 0; b < RHOS; ++b) vjr[b] = (T)0;
        for (int kk = 0; kk < ns; ++kk) vjr[RHOS + kk] = rrow[side][kk];
      } else if (a <= nd) {
        T g0 = sg * (coef * M[a - 1][0]) + sg * (coef_t * M[a - 1][0]);
        T g1 = sg * (coef * M[a - 1][1]) + sg * (coef_t * M[a - 1][1]);
        vjr[0] = -g0 * vr[1] / rl + -g1 * vr[2] / rl;
        vjr[1] = g0 / rl;
        vjr[2] = g1 / rl;
        for (int b = RHOE; b < nvar; ++b) vjr[b] = (T)0;
      } else if (a == RHOE) {
        const T* er = erow[side];
        T ge = er[RHOE];
        vjr[0] = -er[1] * vr[1] / rl + -er[2] * vr[2] / rl + ge * sdt[0];
        for (int d = 0; d < nd; ++d)
          vjr[1 + d] = er[1 + d] / rl + ge * sdt[1 + d];
        vjr[RHOE] = ge * sdt[RHOE];
        for (int kk = 0; kk < ns; ++kk)
          vjr[RHOS + kk] = er[RHOS + kk] + ge * sdt[RHOS + kk];
      } else {
        int s = a - RHOS;
        for (int b = 0; b < RHOS; ++b) vjr[b] = (T)0;
        for (int kk = 0; kk < ns; ++kk)
          vjr[RHOS + kk] = -djdr(side, s, kk) * area;
      }
      for (int b = 0; b < nvar; ++b) {
        T cj = a_mean * (rpi * mp[b] + rpj * mq[b]);
        if (a == b) cj = cj + mlf;
        if (a == RHOE) cj = cj + mlf * sv[b];
        if (a >= 1 && a <= nd) cj = cj + unit[a - 1] * pr[b];
        jout[(size_t)(a * nvar + b) * n] = cj * area - vjr[b];
      }
    }
  }
}

template <typename T, bool MUSCL, bool LIMITER>
int launch_variant(int n, const ImpConsts& c, const Grid<T>& g,
                   const void* f, const void* nrm, const void* evec,
                   const void* tab, const void* cst, void* flux, void* ji,
                   void* jj, void* stream) {
  const int threads = 128;
  long long total = (long long)c.kh * n;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 0)
    edge_implicit_kernel<T, MUSCL, LIMITER>
        <<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
            n, c, g, (const T*)f, (const T*)nrm, (const T*)evec,
            (const T*)tab, (const T*)cst, (T*)flux, (T*)ji, (T*)jj);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_edge_implicit(int n, const ImpConsts& c, int nt, double t0,
                         double dt, int muscl, int limiter, const void* f,
                         const void* nrm, const void* evec, const void* tab,
                         const void* cst, void* flux, void* ji, void* jj,
                         void* stream) {
  Grid<T> g{(T)t0, (T)dt, (T)(t0 + (nt - 1) * dt), (T)(dt * dt), nt};
  if (!muscl)
    return launch_variant<T, false, false>(n, c, g, f, nrm, evec, tab, cst,
                                           flux, ji, jj, stream);
  if (!limiter)
    return launch_variant<T, true, false>(n, c, g, f, nrm, evec, tab, cst,
                                          flux, ji, jj, stream);
  return launch_variant<T, true, true>(n, c, g, f, nrm, evec, tab, cst, flux,
                                      ji, jj, stream);
}

}  // namespace su2k

extern "C" int su2k_edge_implicit(int is_f64, int n, int nd, int ns, int kh,
                                  const int* offsets, int nt, double t0,
                                  double dt, double m_infty, double pr_turb,
                                  double le_turb, double mm_sum, int muscl,
                                  int limiter, const void* f,
                                  const void* nrm, const void* evec,
                                  const void* tab, const void* cst,
                                  void* flux, void* ji, void* jj,
                                  void* stream) {
  if (nd != su2k::IMP_ND || ns > SU2K_MAXS || kh > SU2K_MAXK
      || (limiter && !muscl))
    return (int)cudaErrorInvalidValue;
  su2k::ImpConsts c{m_infty, pr_turb, le_turb, mm_sum, ns, kh, {0}};
  for (int k = 0; k < kh; ++k) {
    if (offsets[k] <= 0 || offsets[k] >= n) return (int)cudaErrorInvalidValue;
    c.off[k] = offsets[k];
  }
  if (is_f64)
    return su2k::launch_edge_implicit<double>(n, c, nt, t0, dt, muscl,
                                              limiter, f, nrm, evec, tab,
                                              cst, flux, ji, jj, stream);
  return su2k::launch_edge_implicit<float>(n, c, nt, t0, dt, muscl, limiter,
                                           f, nrm, evec, tab, cst, flux, ji,
                                           jj, stream);
}

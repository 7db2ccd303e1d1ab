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
// (ops/edge_implicit.py edge_implicit_plain) operation by operation (the
// AUSM+-up face, flux and Jacobian columns, is edge_side.cuh's ausm_face,
// which K11 runs too),
// including the effective diffusion's sum_{k!=s} x_k in place of 1 - x_s
// (ops/viscous_t.py).
//
// Bound on the H100: bytes, by roofline: an edge reads 2 x 79 stack values
// and writes 13 + 2 x 169 (~2.1 KB in f32) against ~12 kFLOP.  Design:
// one thread per (family, slot); the two 169-entry Jacobian blocks never
// sit in registers: the per-column vectors of the AUSM Jacobians (mass and
// pressure parts, 6 x nVar) and the sparse viscous dF/dV (a dense energy
// row, the momentum and the species blocks) are kept, and each output row
// of j_i and j_j is formed from them and stored at once.  The species
// count is a template constant (SU2K_IMPLICIT_BY_NS: the 9-species case
// and the 3-species flat plate), so every loop over it unrolls and the
// S x (S+1) Stefan-Maxwell system and the work vectors are registers; with
// the count known only at run time they all sat in local memory (807 LDL
// and 502 STL in f32) and that traffic set the time.  Every other count
// runs the run-time instance (NS = 0) of the same body.  Live ranges: the
// viscous part runs first, so only its flux, the sparse dF/dV and a few
// mean-state scalars outlive the Stefan-Maxwell solve; then the face
// states are formed, and each side's AUSM column vectors and dF/dV rows
// just before that side's output rows are stored.  Pad slots carry zero
// normals, so every output there is exactly zero.
#include "edge_side.cuh"

namespace su2k {

constexpr int IMP_ND = 2;

// the species counts K10 is compiled for (kernels.IMPLICIT_SPECIES): the
// 9-species combustion chemistry and the 3-species air of the flat plate;
// every other count up to SU2K_MAXS runs the run-time instance (NS = 0)
#define SU2K_IMPLICIT_BY_NS(X) X(9) X(3)

struct ImpConsts {
  double m_infty, pr_turb, le_turb, mm_sum;
  int ns, kh;
  int off[SU2K_MAXK];
};

// one side's face state vf (nPrim) and its dP/dU row s (nVar) from the
// stack column f (stride n); dxs = +-0.5 (side i: +, side j: -); NS the
// species count, or 0 and c.ns; hs, cps: the caller's scratch (S each)
template <typename T, int NS, bool MUSCL, bool LIMITER>
__device__ __forceinline__ void face_state(const ImpConsts& c,
                                           const Grid<T>& g,
                                           const T* __restrict__ f, int n,
                                           int col, const T* ev, T dxs,
                                           const T* __restrict__ tab,
                                           const T* __restrict__ mm,
                                           const T* __restrict__ ri, T* vf,
                                           T* s, T* hs, T* cps) {
  constexpr int NPRIM = NS > 0 ? NS + IMP_ND + 5 : 0;
  constexpr int NV = NS > 0 ? NS + IMP_ND + 2 : 0;
  const int ns = NS > 0 ? NS : c.ns, nd = IMP_ND;
  const int nprim = ns + nd + 5, nvar = ns + nd + 2;
  const int P_ = nd + 1, PRHO = nd + 2, A_ = nd + 4, YS = nd + 5;
  const int ng = 2 + nd + ns;
  const int r_g = nprim, r_lim = r_g + ng * nd;
  const int r_dpdu = r_lim + (2 + nd) + 5 + nd + nvar;
  auto at = [&](int r) { return f[(size_t)r * n + col]; };
  for_n<NPRIM>(nprim, [&](int r) { vf[r] = at(r); });
  if (!MUSCL) {
    for_n<NV>(nvar, [&](int r) { s[r] = at(r_dpdu + r); });
    return;
  }
  const T EPS = (T)1e-16;
  T dx[IMP_ND];
#pragma unroll
  for (int d = 0; d < nd; ++d) dx[d] = dxs * ev[d];
  T qr[2 + IMP_ND];
#pragma unroll
  for (int q = 0; q < 2 + nd; ++q) {
    // [T, u, v, P]: stack rows 0, 1, 2 and P_ = 3
    T proj = at(r_g + q * nd) * dx[0];
#pragma unroll
    for (int d = 1; d < nd; ++d) proj = proj + at(r_g + q * nd + d) * dx[d];
    if (LIMITER) proj = proj * at(r_lim + q);
    qr[q] = vf[q] + proj;
  }
  T t_r = qr[0], p_r = qr[1 + nd];
  bool bad = (t_r <= EPS) || (p_r <= EPS);
  T t_face = bad ? vf[0] : t_r;
  species_hcp<NS>(g, tab, mm, ns, t_face, hs, cps);
  T rgas = (T)0, hmix = (T)0, cpmix = (T)0;
  for_n<NS>(ns, [&](int k) {
    T y = clip_y(vf[YS + k]);
    rgas = k ? rgas + y * ri[k] : y * ri[k];
    hmix = k ? hmix + y * hs[k] : y * hs[k];
    cpmix = k ? cpmix + y * cps[k] : y * cps[k];
  });
  T ke = qr[1] * qr[1];
#pragma unroll
  for (int d = 1; d < nd; ++d) ke = ke + qr[1 + d] * qr[1 + d];
  hmix = hmix + (T)0.5 * ke;
  T gamma_r = cpmix / (cpmix - rgas);
  T rho_r = p_r / (rgas * t_r);
  T a_r = sqrt(fabs(gamma_r * p_r / rho_r));
  if (!bad) {
    vf[0] = t_r;
#pragma unroll
    for (int d = 0; d < nd; ++d) vf[1 + d] = qr[1 + d];
    vf[P_] = p_r;
    vf[PRHO] = rho_r;
    vf[nd + 3] = hmix;
    vf[A_] = a_r;
  }
  // dP/dU of the face state (euler.ghost_dpdu, gamma = a^2 rho / P)
  T gam = vf[A_] * vf[A_] * vf[PRHO] / vf[P_];
  T vel2 = vf[1] * vf[1];
#pragma unroll
  for (int d = 1; d < nd; ++d) vel2 = vel2 + vf[1 + d] * vf[1 + d];
  s[0] = (gam - (T)1) * (T)0.5 * vel2;
#pragma unroll
  for (int d = 0; d < nd; ++d) s[1 + d] = ((T)1 - gam) * vf[1 + d];
  s[1 + nd] = gam - (T)1;
  for_n<NS>(ns, [&](int k) {
    T e_s = hs[k] - ri[k] * t_face;
    s[2 + nd + k] = ri[k] * t_face - (gam - (T)1) * e_s;
  });
}

// mole fractions of mass fractions y (clipped), x_s = (y_s/M_s) (sum y /
// sum y/M)
template <int NS, typename T>
__device__ __forceinline__ void molar(int ns, const T* __restrict__ mm,
                                      const T* y, T* x) {
  T ysum = (T)0, xsum = (T)0;
  for_n<NS>(ns, [&](int s) {
    T yc = clip_y(y[s]);
    x[s] = yc / mm[s];
    ysum += yc;
    xsum += x[s];
  });
  T r = ysum / xsum;
  for_n<NS>(ns, [&](int s) { x[s] = x[s] * r; });
}

template <typename T, int NS, bool MUSCL, bool LIMITER>
__global__ void __launch_bounds__(128)
edge_implicit_kernel(int n, ImpConsts c, Grid<T> g, const T* __restrict__ f,
                     const T* __restrict__ fam_normal,
                     const T* __restrict__ fam_evec,
                     const T* __restrict__ tab, const T* __restrict__ cst,
                     T* __restrict__ flux, T* __restrict__ ji,
                     T* __restrict__ jj) {
  // array extents (the count, or its bound SU2K_MAXS at NS = 0) and the
  // trip counts of for_n (the count, or 0: known at run time)
  constexpr int MS = NS > 0 ? NS : SU2K_MAXS;
  constexpr int MPRIM = MS + IMP_ND + 5, MV = MS + IMP_ND + 2;
  constexpr int NPRIM = NS > 0 ? MPRIM : 0, NV = NS > 0 ? MV : 0;
  constexpr int NGV = NS > 0 ? 1 + IMP_ND + NS : 0;
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)c.kh * n) return;
  const int k = (int)(idx / n);
  const int p = (int)(idx - (long long)k * n);
  int q_ = p + fam_offset(c, k);
  if (q_ >= n) q_ -= n;
  const int jcol = q_;
  const int ns = NS > 0 ? NS : c.ns, nd = IMP_ND;
  const int nprim = ns + nd + 5, nvar = ns + nd + 2;
  const int P_ = nd + 1, PRHO = nd + 2;
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
#pragma unroll
  for (int d = 0; d < nd; ++d) {
    nm[d] = fam_normal[((size_t)k * n + p) * nd + d];
    ev[d] = fam_evec[((size_t)k * n + p) * nd + d];
  }
  T area = sqrt(nm[0] * nm[0] + nm[1] * nm[1]);
  T area_s = area > tiny ? area : tiny;
  T unit[IMP_ND];
#pragma unroll
  for (int d = 0; d < nd; ++d) unit[d] = nm[d] / area_s;

  // ------------------------------------------------ viscous (node states)
  T vi[MPRIM], vj[MPRIM];
  for_n<NPRIM>(nprim, [&](int r) {
    vi[r] = fi(r);
    vj[r] = fj(r);
  });
  T mu = harm(fi(r_mu), fj(r_mu));
  T ktr = harm(fi(r_ka), fj(r_ka));
  T f_i = (T)1.0e-7 * pow(vi[0], (T)1.75) / (vi[P_] / (T)101325.0);
  T f_j = (T)1.0e-7 * pow(vj[0], (T)1.75) / (vj[P_] / (T)101325.0);
  T gf = harm(f_i, f_j);
  T vel[IMP_ND];
#pragma unroll
  for (int d = 0; d < nd; ++d) vel[d] = (T)0.5 * (vi[1 + d] + vj[1 + d]);
  T rho = (T)0.5 * (vi[PRHO] + vj[PRHO]);
  // Every work array is declared at kernel scope, none in an inner block:
  // with block-scoped arrays the run-time instance (NS = 0, the arrays in
  // local memory) came out wrong on the card (the AUSM flux and side i's
  // pressure columns) while its CPU build was exact; they are registers
  // in the compiled instances either way.
  T ysc[MS], xs[MS], xs_i[MS], xs_j[MS], ym[MS];
  T aug[MS * (MS + 1)], du[MS], dw[MS], dinv[MS], db[MS];
  for_n<NS>(ns, [&](int s) {
    ym[s] = (T)0.5 * (vi[YS + s] + vj[YS + s]);
    ysc[s] = clip_y(ym[s]);
  });
  molar<NS>(ns, mm, ym, xs);
  molar<NS>(ns, mm, vi + YS, xs_i);
  molar<NS>(ns, mm, vj + YS, xs_j);
  // mean gradients of [T, u, v, X..] (the pressure row 1 + nd dropped),
  // corrected along the edge (CAvgGradReactive_Flow, :1507-1527)
  const int gv = 1 + nd + ns;
  T gm[(1 + IMP_ND + MS) * IMP_ND];
  T dist2 = ev[0] * ev[0] + ev[1] * ev[1];
  dist2 = dist2 > tiny ? dist2 : tiny;
  for_n<NGV>(gv, [&](int q) {
    int qs = q <= nd ? q : q + 1;
    T gq[IMP_ND];
#pragma unroll
    for (int d = 0; d < nd; ++d)
      gq[d] = (T)0.5 * (fi(r_g + qs * nd + d) + fj(r_g + qs * nd + d));
    T diff = q == 0 ? vj[0] - vi[0]
                    : (q <= nd ? vj[q] - vi[q]
                               : xs_j[q - 1 - nd] - xs_i[q - 1 - nd]);
    T proj = gq[0] * ev[0] + gq[1] * ev[1];
    T cf = (proj - diff) / dist2;
#pragma unroll
    for (int d = 0; d < nd; ++d) gm[q * nd + d] = gq[d] - cf * ev[d];
  });
  const T* g_t = gm;
  const T* g_vel = gm + nd;            // [a * nd + b]
  const T* g_xs = gm + (1 + nd) * nd;  // [s * nd + d]
  T div = g_vel[0] + g_vel[nd + 1];
  const T TWO3 = (T)(2.0 / 3.0);
  T gxn[MS];
  for_n<NS>(ns, [&](int s) {
    gxn[s] = g_xs[s * nd] * nm[0] + g_xs[s * nd + 1] * nm[1];
  });
  T jd[MS];
  stefan_maxwell<NS>(ns, mm, den, ysc, xs, rho, gf, gxn, aug);
  for_n<NS>(ns, [&](int s) { jd[s] = aug[s * (ns + 1) + ns]; });
  T hs[MS], cps[MS];
  species_hcp<NS>(g, tab, mm, ns, (T)0.5 * (vi[0] + vj[0]), hs, cps);
  T e_heat = (T)0, jsum = (T)0;
  for_n<NS>(ns, [&](int s) {
    e_heat -= hs[s] * jd[s];
    jsum += jd[s];
  });
  T mu_t = harm(fi(r_mut), fj(r_mut));
  T tke = (T)0.5 * (fi(r_tke) + fj(r_tke));
  T mom[IMP_ND] = {(T)0, (T)0};
  T e_tau = (T)0;
#pragma unroll
  for (int a = 0; a < nd; ++a)
#pragma unroll
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
  T gy[MS * IMP_ND], gyn[MS];
  {
    T mms = (T)c.mm_sum;
    T sigx = (T)0;
    for_n<NS>(ns, [&](int s) { sigx += xs[s]; });
    T g11 = (T)0, g12 = (T)0, g21 = (T)0, g22 = (T)0;
    for_n<NS>(ns, [&](int s) {
      dinv[s] = mm[s] / (mms * sigx);
      du[s] = dinv[s] * (mms * ysc[s] / mm[s]);
      dw[s] = dinv[s] * (-mms * xs[s]);
      g11 += du[s];
      g12 += dw[s];
      g21 += (T)1 / mm[s] * du[s];
      g22 += (T)1 / mm[s] * dw[s];
    });
    g11 = (T)1 + g11;
    g22 = (T)1 + g22;
    T det = g11 * g22 - g12 * g21;
    det = det == (T)0 ? (T)1 : det;
#pragma unroll
    for (int d = 0; d < nd; ++d) {
      T c1 = (T)0, c2 = (T)0;
      for_n<NS>(ns, [&](int s) {
        db[s] = dinv[s] * g_xs[s * nd + d];
        c1 += db[s];
        c2 += (T)1 / mm[s] * db[s];
      });
      T a1 = (g22 * c1 - g12 * c2) / det;
      T a2 = (g11 * c2 - g21 * c1) / det;
      for_n<NS>(ns, [&](int s) {
        T v = db[s] - du[s] * a1 - dw[s] * a2;
        gy[s * nd + d] = fabs(g_xs[s * nd + d]) < (T)1e-8 ? (T)0 : v;
      });
    }
    for_n<NS>(ns, [&](int s) {
      gyn[s] = gy[s * nd] * nm[0] + gy[s * nd + 1] * nm[1];
    });
  }
  T hy = (T)0, cpy = (T)0;
  for_n<NS>(ns, [&](int s) {
    hy += hs[s] * ysc[s] * gyn[s];
    cpy += cps[s] * ysc[s];
  });
  e_heat += cmt * hy;
  e_cond += (mu_t / (T)c.pr_turb) * cpy * gtn;
  T gkn = (T)0.5 * (fi(r_gk) + fj(r_gk)) * nm[0]
        + (T)0.5 * (fi(r_gk + 1) + fj(r_gk + 1)) * nm[1];
  e_cond += (mu + mu_t / fi(r_sk)) * gkn;
  T vfl[MV];
  vfl[0] = -jsum;
#pragma unroll
  for (int d = 0; d < nd; ++d) vfl[1 + d] = mom[d];
  vfl[RHOE] = e_tau + e_cond + e_heat;
  for_n<NS>(ns, [&](int s) { vfl[RHOS + s] = -jd[s] + cmt * gyn[s]; });

  // ---------------------------------- viscous Jacobian, dF/dV (sparse)
  T dist = sqrt(dist2);
  T ds[MS];
  for_n<NS>(ns, [&](int s) {
    T dsd = (T)0;
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      const T* xx = side ? xs_j : xs_i;
      T fside = side ? f_j : f_i;
      T q = (T)0, rest = (T)0;
      for_n<NS>(ns, [&](int kk) {
        if (kk == s) return;
        q += den[s * ns + kk] * xx[kk];
        rest += xx[kk];
      });
      T d_ = fside * rest / (q == (T)0 ? (T)1 : q);
      d_ = (q == (T)0 || !isfinite(d_)) ? (T)0 : d_;
      dsd = side ? dsd + d_ : d_;
    }
    ds[s] = (T)0.5 * dsd;
  });
  T tot_mass = (T)0, tot_i = (T)0, tot_j = (T)0, sig_i = (T)0, sig_j = (T)0;
  T smx_i = (T)0, smx_j = (T)0, smg = (T)0;
  for_n<NS>(ns, [&](int s) {
    tot_mass += mm[s] * xs[s];
    tot_i += mm[s] * xs_i[s];
    tot_j += mm[s] * xs_j[s];
    sig_i += xs_i[s];
    sig_j += xs_j[s];
    T mds = mm[s] * ds[s];
    smx_i += mds * xs_i[s];
    smx_j += mds * xs_j[s];
    smg += mds * (gxn[s] / area_s);
  });
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
#pragma unroll
  for (int d = 0; d < nd; ++d)
#pragma unroll
    for (int e = 0; e < nd; ++e)
      M[d][e] = d == e ? theta + unit[d] * unit[d] / (T)3
                       : unit[d] * unit[e] / (T)3;
#pragma unroll
  for (int d = 0; d < nd; ++d) piv[d] = vel[0] * M[d][0] + vel[1] * M[d][1];
  T coef = mu / dist * area, coef_t = mu_t / dist * area;
  T jd_cp = (T)0;
  for_n<NS>(ns, [&](int s) { jd_cp += jd[s] * cps[s]; });
  jd_cp = (T)-0.5 * jd_cp;
  T aux_c = (T)0;
  for_n<NS>(ns, [&](int s) {
    aux_c += cps[s] * ysc[s] * (gy[s * nd] * unit[0] + gy[s * nd + 1]
                                * unit[1]);
  });
  T com = cmt * aux_c * area;
  T ce = cmt / dist * area * theta;
  T e_ee = ktr * theta / dist * area;
  T add_ee = mu_t / (T)c.pr_turb * cpy * theta / dist * area;

  // ------------------------------------------------ AUSM+-up on the faces
  T vfi[MPRIM], vfj[MPRIM];
  T s_i[MV], s_j[MV], fhs[MS], fcps[MS];
  face_state<T, NS, MUSCL, LIMITER>(c, g, f, n, p, ev, (T)0.5, tab, mm, ri,
                                    vfi, s_i, fhs, fcps);
  face_state<T, NS, MUSCL, LIMITER>(c, g, f, n, jcol, ev, (T)-0.5, tab, mm,
                                    ri, vfj, s_j, fhs, fcps);
  const T rho_i = vfi[PRHO], rho_j = vfj[PRHO];

  // ---------------- output rows: j = conv_jac - dF/dV . dV/dU, per side.
  // A side's AUSM column vectors (edge_side.cuh ausm_face) and its energy
  // and density rows of dF/dV are formed just before its rows, so the
  // other side's are not live meanwhile.
  T fo[MV], w[MV], pr[MV], er[MV], rr[MS], sdt[MV], vjr[MV];
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    AusmFace<T> af;
    {
      if (side == 0) {
        af = ausm_face<IMP_ND, T, 1>(nvar, c.m_infty, vfi, vfj, s_i, s_j,
                                     unit, area, fo, w, nullptr, pr,
                                     nullptr);
        T* fout = flux + (size_t)k * nvar * n + p;
        for_n<NV>(nvar, [&](int a) {
          fout[(size_t)a * n] = fo[a] - vfl[a];
        });
      } else {
        af = ausm_face<IMP_ND, T, 2>(nvar, c.m_infty, vfi, vfj, s_i, s_j,
                                     unit, area, fo, nullptr, w, nullptr,
                                     pr);
      }
    }
    // the energy row of dF/dV and the density row (species columns); the
    // species block is djdr itself
    T sg = side ? (T)1 : (T)-1;
#pragma unroll
    for (int d = 0; d < nd; ++d) {
      T hm = (T)0.5 * vfl[1 + d];
      er[1 + d] = (side ? coef * piv[d] : -(coef * piv[d]))
                + (side ? coef_t * piv[d] : -(coef_t * piv[d])) + hm;
    }
    er[RHOE] = (side ? e_ee : -e_ee) + jd_cp + (side ? add_ee : -add_ee)
             + com;
    for_n<NS>(ns, [&](int kk) {
      T col_rho = (T)0, col_e = (T)0;
      for_n<NS>(ns, [&](int s) {
        T val = -djdr(side, s, kk) * area;
        col_rho = s ? col_rho + val : val;
        col_e = s ? col_e + val * hs[s] : val * hs[s];
      });
      rr[kk] = col_rho;
      T rs = side ? rvj : rvi;
      er[RHOS + kk] = col_e + sg * ce * hs[kk] * ysc[kk] / rs;
    });

    const T* vr = side ? vj : vi;
    T rl = vr[PRHO];
    T* jout = (side ? jj : ji) + (size_t)k * nvar * nvar * n + p;
    const T* sv = side ? s_j : s_i;       // face dP/dU
    for_n<NV>(nvar, [&](int b) {
      sdt[b] = side ? fj(r_dtdu + b) : fi(r_dtdu + b);
    });
    for_n<NV>(nvar, [&](int a) {
      T rpi = rho_i * ausm_phi<IMP_ND>(vfi, a);
      T rpj = rho_j * ausm_phi<IMP_ND>(vfj, a);
      // this row of dF/dV . dV/dU
      if (a == 0) {
#pragma unroll
        for (int b = 0; b < RHOS; ++b) vjr[b] = (T)0;
        for_n<NS>(ns, [&](int kk) { vjr[RHOS + kk] = rr[kk]; });
      } else if (a <= nd) {
        T g0 = sg * (coef * M[a - 1][0]) + sg * (coef_t * M[a - 1][0]);
        T g1 = sg * (coef * M[a - 1][1]) + sg * (coef_t * M[a - 1][1]);
        vjr[0] = -g0 * vr[1] / rl + -g1 * vr[2] / rl;
        vjr[1] = g0 / rl;
        vjr[2] = g1 / rl;
        for_n<NV>(nvar, [&](int b) {
          if (b >= RHOE) vjr[b] = (T)0;
        });
      } else if (a == RHOE) {
        T ge = er[RHOE];
        vjr[0] = -er[1] * vr[1] / rl + -er[2] * vr[2] / rl + ge * sdt[0];
#pragma unroll
        for (int d = 0; d < nd; ++d)
          vjr[1 + d] = er[1 + d] / rl + ge * sdt[1 + d];
        vjr[RHOE] = ge * sdt[RHOE];
        for_n<NS>(ns, [&](int kk) {
          vjr[RHOS + kk] = er[RHOS + kk] + ge * sdt[RHOS + kk];
        });
      } else {
        int s = a - RHOS;
#pragma unroll
        for (int b = 0; b < RHOS; ++b) vjr[b] = (T)0;
        for_n<NS>(ns, [&](int kk) {
          vjr[RHOS + kk] = -djdr(side, s, kk) * area;
        });
      }
      for_n<NV>(nvar, [&](int b) {
        T cj = ausm_jac_entry<IMP_ND>(af, side != 0, a, b, rpi, rpj, w, pr,
                                      sv, unit);
        jout[(size_t)(a * nvar + b) * n] = cj * area - vjr[b];
      });
    });
  }
}

template <typename T, int NS, bool MUSCL, bool LIMITER>
int launch_variant(int n, const ImpConsts& c, const Grid<T>& g,
                   const void* f, const void* nrm, const void* evec,
                   const void* tab, const void* cst, void* flux, void* ji,
                   void* jj, void* stream) {
  const int threads = 128;
  long long total = (long long)c.kh * n;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 0)
    edge_implicit_kernel<T, NS, MUSCL, LIMITER>
        <<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
            n, c, g, (const T*)f, (const T*)nrm, (const T*)evec,
            (const T*)tab, (const T*)cst, (T*)flux, (T*)ji, (T*)jj);
  return (int)cudaGetLastError();
}

template <typename T, int NS>
int launch_species(int n, const ImpConsts& c, const Grid<T>& g, int muscl,
                   int limiter, const void* f, const void* nrm,
                   const void* evec, const void* tab, const void* cst,
                   void* flux, void* ji, void* jj, void* stream) {
  if (!muscl)
    return launch_variant<T, NS, false, false>(n, c, g, f, nrm, evec, tab,
                                               cst, flux, ji, jj, stream);
  if (!limiter)
    return launch_variant<T, NS, true, false>(n, c, g, f, nrm, evec, tab,
                                              cst, flux, ji, jj, stream);
  return launch_variant<T, NS, true, true>(n, c, g, f, nrm, evec, tab, cst,
                                           flux, ji, jj, stream);
}

template <typename T>
int launch_edge_implicit(int n, const ImpConsts& c, int nt, double t0,
                         double dt, int muscl, int limiter, const void* f,
                         const void* nrm, const void* evec, const void* tab,
                         const void* cst, void* flux, void* ji, void* jj,
                         void* stream) {
  Grid<T> g{(T)t0, (T)dt, (T)(t0 + (nt - 1) * dt), (T)(dt * dt), nt};
#define SU2K_IMP_CASE(NS_)                                                  \
  if (c.ns == NS_)                                                          \
    return launch_species<T, NS_>(n, c, g, muscl, limiter, f, nrm, evec,    \
                                  tab, cst, flux, ji, jj, stream);
  SU2K_IMPLICIT_BY_NS(SU2K_IMP_CASE)
#undef SU2K_IMP_CASE
  return launch_species<T, 0>(n, c, g, muscl, limiter, f, nrm, evec, tab,
                              cst, flux, ji, jj, stream);
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
  if (nd != su2k::IMP_ND || ns < 1 || ns > SU2K_MAXS || kh > SU2K_MAXK
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

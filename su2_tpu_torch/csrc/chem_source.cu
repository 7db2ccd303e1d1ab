// T4: species production omega_s of the finite-rate chemistry with the
// PaSR closure (reacting_model_library.cpp:99-227, :835-920).
//
// Replaces su2_tpu/pallas/chem_source.py:62 _chem_source_call (entry
// chem_source :173): Arrhenius forward and backward rates, the ln Kc /
// ln Kp spline lookup, the vanishing-species guards, dFr/drho and the PaSR
// factor k_r = max(1/(1 + tau_mix max_j |dFr_j M_j|), lb).
//
// Bound on the H100: operations in f64.  Per node it reads T, rho,
// omega_t and S mass fractions and writes S rates (~170 B in f64), but
// evaluates R*(2 exp + 2 pow) plus up to R*S pow for the concentration
// products; at tens of FP64 instructions per pow that is ~1 kFLOP, about
// the card's ~10 FLOP/B f64 ridge, with the transcendentals on the FP64
// pipe.  At 9,072 nodes the launch's few blocks leave the card mostly idle.
// Design: one thread per node, loops over R and S; the per-reaction and
// per-species constants sit in one small device buffer read through the
// read-only cache.
#include "common.cuh"

namespace su2k {

// constant buffer layout (all scalars in T):
//   mm[S] | per reaction r: A, beta, Ta, A_b, beta_b, Ta_b, reversible,
//   has_backward (8 each) | exp_f[R][S] | exp_b[R][S] | dcoeff[S][R] |
//   participates[S][R]
template <typename T>
__global__ void chem_source_kernel(int n, int ns, int nr, Grid<T> g,
                                   const T* __restrict__ t_in,
                                   const T* __restrict__ rho_in,
                                   const T* __restrict__ ys_in,
                                   const T* __restrict__ omt_in,
                                   const T* __restrict__ tab,
                                   const T* __restrict__ cst, T c_mu,
                                   T pasr_lb, T* __restrict__ out) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const T* mm = cst;
  const T* arr = cst + ns;
  const T* exp_f = arr + 8 * nr;
  const T* exp_b = exp_f + nr * ns;
  const T* dco = exp_b + nr * ns;
  const T* part = dco + ns * nr;

  T t = t_in[p];
  T rho = rho_in[p];
  T ys[SU2K_MAXS], ysc[SU2K_MAXS], cs[SU2K_MAXS];
  for (int s = 0; s < ns; ++s) {
    ys[s] = ys_in[(size_t)p * ns + s];
    ysc[s] = clip_y(ys[s]);
    cs[s] = (T)1.0e3 * rho * clip_y(ysc[s]) / mm[s];
  }
  Bin<T> bn = spline_bin(g, t);
  T rf[SU2K_MAXR], rb[SU2K_MAXR];
  for (int r = 0; r < nr; ++r) {
    const T* a = arr + 8 * r;
    T kf = a[0] * pow(t, a[1]) * exp(-a[2] / t);
    T lnkc = spline_at(g, bn, tab + (size_t)r * g.nt,
                       tab + (size_t)(nr + r) * g.nt);
    T lnkp = spline_at(g, bn, tab + (size_t)(2 * nr + r) * g.nt,
                       tab + (size_t)(3 * nr + r) * g.nt);
    T kc_g = exp(lnkc), kp = exp(lnkp);
    T kb_g = (a[6] > (T)0.5 && kp <= (T)1.0e10) ? kf / kc_g : (T)0;
    T kb_a = a[3] * pow(t, a[4]) * exp(-a[5] / t);
    T kb = a[7] > (T)0.5 ? kb_a : kb_g;
    // concentration products with the negative-exponent guard (:880-916)
    T pf = (T)1, pb = (T)1;
    bool gf = false, gb = false;
    for (int s = 0; s < ns; ++s) {
      T ef = exp_f[r * ns + s], eb = exp_b[r * ns + s];
      if (ef != (T)0) pf *= pow(cs[s], ef);
      if (eb != (T)0) pb *= pow(cs[s], eb);
      gf |= (ef < (T)0) && (ysc[s] < (T)1.0e-15);
      gb |= (eb < (T)0) && (ysc[s] < (T)1.0e-15);
    }
    rf[r] = kf * (gf ? (T)0 : pf);
    rb[r] = kb * (gb ? (T)0 : pb);
  }
  T kr[SU2K_MAXR];
  bool pasr = omt_in != nullptr;
  for (int r = 0; r < nr; ++r) {
    kr[r] = (T)1;
    if (!pasr) continue;
    T highest = (T)0;
    for (int j = 0; j < ns; ++j) {
      T d = (T)0;
      if (ys[j] > (T)1.0e-10)
        d = (rf[r] * exp_f[r * ns + j] - rb[r] * exp_b[r * ns + j])
            / (rho * ys[j]);
      T m = fabs(d * mm[j]) * part[j * nr + r];
      highest = m > highest ? m : highest;
    }
    T tau_mix = (T)1 / (c_mu * omt_in[p]);
    T k = (T)1 / ((T)1 + tau_mix * highest);
    kr[r] = highest <= (T)0 ? (T)1 : (k > pasr_lb ? k : pasr_lb);
  }
  for (int s = 0; s < ns; ++s) {
    T acc = (T)0;
    for (int r = 0; r < nr; ++r) {
      T om = (T)1.0e-3 * mm[s] * dco[s * nr + r] * (rf[r] - rb[r]);
      acc += om * kr[r];
    }
    out[(size_t)p * ns + s] = acc;
  }
}

template <typename T>
int launch_chem_source(int n, int ns, int nr, int nt, double t0, double dt,
                       const void* t, const void* rho, const void* ys,
                       const void* omt, const void* tab, const void* cst,
                       double c_mu, double pasr_lb, void* out, void* stream) {
  Grid<T> g{(T)t0, (T)dt, (T)(t0 + (nt - 1) * dt), (T)(dt * dt), nt};
  int threads = 128;
  int blocks = (n + threads - 1) / threads;
  if (blocks > 0)
    chem_source_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        n, ns, nr, g, (const T*)t, (const T*)rho, (const T*)ys,
        (const T*)omt, (const T*)tab, (const T*)cst, (T)c_mu, (T)pasr_lb,
        (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace su2k

extern "C" int su2k_chem_source(int is_f64, int n, int ns, int nr, int nt,
                                double t0, double dt, const void* t,
                                const void* rho, const void* ys,
                                const void* omt, const void* tab,
                                const void* cst, double c_mu, double pasr_lb,
                                void* out, void* stream) {
  if (ns > SU2K_MAXS || nr > SU2K_MAXR) return (int)cudaErrorInvalidValue;
  if (is_f64)
    return su2k::launch_chem_source<double>(n, ns, nr, nt, t0, dt, t, rho,
                                            ys, omt, tab, cst, c_mu, pasr_lb,
                                            out, stream);
  return su2k::launch_chem_source<float>(n, ns, nr, nt, t0, dt, t, rho, ys,
                                         omt, tab, cst, c_mu, pasr_lb, out,
                                         stream);
}

// T3: explicit interior edge flux of the reactive RANS residual.  Per edge
// (p, p + o_k) of each stencil family k: AUSM+-up convective flux
// (numerics_direct_reactive.cpp:53-383), viscous flux with Stefan-Maxwell
// diffusion and the SST closure (:385-1684, closure :656-889), species
// h/cp at the face-mean temperature, and the convective and viscous
// spectral radii of SetTime_Step (solver_direct_reactive.cpp:5057).
//
// Replaces su2_tpu/pallas/edge_fused.py:161 fused_edge_flux_pallas_multi
// (via fused_interior_terms :561 -> :665).  The TPU kernel evaluates h/cp
// with one-hot MXU contractions of VMEM-resident tables and takes f_j as
// host-side rolls of the stack; here each thread gathers both endpoint
// columns of the stack and the spline knots from global memory.  The
// residual roll-subtract stays in torch (deterministic, no atomics).
//
// Bound on the H100: bytes, by roofline.  An edge reads 2 x 48 stack
// values and writes nVar + 2 (~450 B in f32) against ~2.5 kFLOP (the
// pivot-free S x (S+1) Gauss-Jordan of the Stefan-Maxwell system is most
// of it), ~6 FLOP/B, under the card's ~20 FLOP/B f32 ridge.  This simple
// design is slower than that bound: each thread keeps its S x (S+1)
// system and work arrays in local memory (2-4 KB of stack), and that
// traffic sets the time.  Design: one thread per (family, slot), endpoint
// columns read with the slot index as the fastest-varying address
// (coalesced rows of the feature-major stack), S <= 16.  Pad slots carry
// zero normals, so their flux is zero.  The per-edge body is edge_side
// (csrc/edge_side.cuh), which kernel K8 runs too.
#include "edge_side.cuh"

namespace su2k {

template <typename T>
__global__ void edge_flux_kernel(int n, EdgeConsts c, Grid<T> g,
                                 const T* __restrict__ f,
                                 const T* __restrict__ fam_normal,
                                 const T* __restrict__ fam_evec,
                                 const T* __restrict__ tab,
                                 const T* __restrict__ cst,
                                 T* __restrict__ flux, T* __restrict__ lc,
                                 T* __restrict__ lv) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)c.kh * n) return;
  const int k = (int)(idx / n);
  const int p = (int)(idx - (long long)k * n);
  const int nvar = c.ns + c.nd + 2;
  T fo[SU2K_MAXV], nm[SU2K_MAXD], ev[SU2K_MAXD];
  T lco, lvo;
  const int j = fam_slot(n, c, fam_normal, fam_evec, k, p, nm, ev);
  edge_side<T>(n, c, g, f, p, j, nm, ev, tab, cst, fo, lco, lvo);
  // family-major (Kh, nVar, N)
  T* out = flux + (size_t)k * nvar * n + p;
  for (int r = 0; r < nvar; ++r) out[(size_t)r * n] = fo[r];
  lc[(size_t)k * n + p] = lco;
  lv[(size_t)k * n + p] = lvo;
}

template <typename T>
int launch_edge_flux(int n, EdgeConsts c, int nt, double t0, double dt,
                     const void* f, const void* nrm, const void* evec,
                     const void* tab, const void* cst, void* flux, void* lc,
                     void* lv, void* stream) {
  Grid<T> g{(T)t0, (T)dt, (T)(t0 + (nt - 1) * dt), (T)(dt * dt), nt};
  int threads = 128;
  long long total = (long long)c.kh * n;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 0)
    edge_flux_kernel<T><<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
        n, c, g, (const T*)f, (const T*)nrm, (const T*)evec, (const T*)tab,
        (const T*)cst, (T*)flux, (T*)lc, (T*)lv);
  return (int)cudaGetLastError();
}

}  // namespace su2k

extern "C" int su2k_edge_flux(int is_f64, int n, int nd, int ns, int kh,
                              const int* offsets, int nt, double t0,
                              double dt, double m_infty, double pr_lam,
                              double pr_turb, double le_turb, double mm_sum,
                              const void* f, const void* nrm,
                              const void* evec, const void* tab,
                              const void* cst, void* flux, void* lc, void* lv,
                              void* stream) {
  if (ns > SU2K_MAXS || nd > SU2K_MAXD || kh > SU2K_MAXK)
    return (int)cudaErrorInvalidValue;
  su2k::EdgeConsts c{m_infty, pr_lam, pr_turb, le_turb, mm_sum,
                     nd, ns, kh, {0}};
  for (int k = 0; k < kh; ++k) {
    if (offsets[k] <= 0 || offsets[k] >= n) return (int)cudaErrorInvalidValue;
    c.off[k] = offsets[k];
  }
  if (is_f64)
    return su2k::launch_edge_flux<double>(n, c, nt, t0, dt, f, nrm, evec, tab,
                                          cst, flux, lc, lv, stream);
  return su2k::launch_edge_flux<float>(n, c, nt, t0, dt, f, nrm, evec, tab,
                                       cst, flux, lc, lv, stream);
}

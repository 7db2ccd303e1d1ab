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
// design is slower than that bound.  Design: one thread per (family,
// slot), endpoint columns read with the slot index as the fastest-varying
// address (coalesced rows of the feature-major stack).  Pad slots carry
// zero normals, so their flux is zero.  The per-edge body is edge_side
// (csrc/edge_side.cuh) at a compile-time (dimension, species count), its
// S x (S+1) system in registers; every other shape runs its run-time
// instance (the same body, the arrays in local memory).  The kernel
// and its launch (edge_slot, launch_edge_slots) are in edge_side.cuh,
// which K8 compiles as its first pass.
#include "edge_side.cuh"

namespace su2k {

template <typename T>
int launch_edge_flux(int n, EdgeConsts c, int nt, double t0, double dt,
                     const void* f, const void* nrm, const void* evec,
                     const void* tab, const void* cst, void* flux, void* lc,
                     void* lv, void* stream) {
  Grid<T> g{(T)t0, (T)dt, (T)(t0 + (nt - 1) * dt), (T)(dt * dt), nt};
  return launch_edge_slots<T, false>(n, c, g, (const T*)f, (const T*)nrm,
                                     (const T*)evec, (const T*)tab,
                                     (const T*)cst, (T*)flux, (T*)lc,
                                     (T*)lv, (cudaStream_t)stream);
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
  if (kh > SU2K_MAXK)
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

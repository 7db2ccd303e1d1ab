// K10, the 2D instances and the C entry point (the kernel and its notes:
// edge_implicit.cuh; the 3D instances: edge_implicit_3d.cu).
#include "edge_implicit.cuh"

namespace su2k {

template <typename T>
int launch_edge_implicit(int n, int nd, const ImpConsts& c, int nt,
                         double t0, double dt, int muscl, int limiter,
                         const void* f, const void* nrm, const void* evec,
                         const void* tab, const void* cst, void* flux,
                         void* ji, void* jj, void* stream) {
  Grid<T> g{(T)t0, (T)dt, (T)(t0 + (nt - 1) * dt), (T)(dt * dt), nt};
  if (nd == 2)
    return launch_dim<T, 2>(n, c, g, muscl, limiter, f, nrm, evec, tab, cst,
                            flux, ji, jj, stream);
  return launch_dim<T, 3>(n, c, g, muscl, limiter, f, nrm, evec, tab, cst,
                          flux, ji, jj, stream);
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
  if ((nd != 2 && nd != 3) || ns < 1 || ns > SU2K_MAXS || kh > SU2K_MAXK
      || (limiter && !muscl))
    return (int)cudaErrorInvalidValue;
  su2k::ImpConsts c{m_infty, pr_turb, le_turb, mm_sum, ns, kh, {0}};
  for (int k = 0; k < kh; ++k) {
    if (offsets[k] <= 0 || offsets[k] >= n) return (int)cudaErrorInvalidValue;
    c.off[k] = offsets[k];
  }
  if (is_f64)
    return su2k::launch_edge_implicit<double>(n, nd, c, nt, t0, dt, muscl,
                                              limiter, f, nrm, evec, tab,
                                              cst, flux, ji, jj, stream);
  return su2k::launch_edge_implicit<float>(n, nd, c, nt, t0, dt, muscl,
                                           limiter, f, nrm, evec, tab, cst,
                                           flux, ji, jj, stream);
}

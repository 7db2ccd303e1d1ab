// K8: the explicit interior edge terms summed per node, in one launch.
// For node p and each family k in order (positive offsets o_k), with
// q = p - o_k mod n and flux_k / lc_k / lv_k the per-edge outputs of
// edge_side (csrc/edge_side.cuh, the same device function kernel T3 runs):
//   res[:, p] = sum_k (flux_k[p] - flux_k[q])
//   lc[p]     = sum_k (lc_k[p] + lc_k[q]),  lv[p] likewise,
// the subtraction (addition) formed before each family's add, which is the
// roll-subtract order of ops/edge_flux.py.  Slots without an edge carry
// zero normals, so their terms are exactly zero; no atomics.
//
// Replaces su2_tpu/pallas/edge_fused.py:346 _edge_win_call (the windowed
// multi-family kernel of the >= 200k-node tier, via fused_interior_terms
// :632-659).  The TPU kernel DMAs one halo window of the stack per tile
// and rolls it in VMEM; here each thread reads its two endpoint columns
// straight from global memory (neighbouring threads read neighbouring
// columns, so the reads coalesce and the halo comes from L2).
//
// Bound on the H100: bytes, by roofline.  Per node it reads the stack
// column and the Kh normals/edge vectors and writes nVar + 2 values; the
// work is 2 Kh edge evaluations (~2.5 kFLOP each, ~6 FLOP/B for T3 alone).
// Design: one thread per node that evaluates both edges of each family
// itself (the edge (p, p + o_k) it owns and the edge (q, p) it receives),
// so every edge is computed twice, with no shared memory and no second
// pass.  A tile of shared-memory fluxes with a halo would save the second
// evaluation only when the tile is wider than the largest offset (377
// slots at 565,500 nodes), i.e. tens of KB per block of f64 fluxes; the
// simple form comes first.  Like T3, each thread keeps the S x (S+1)
// Stefan-Maxwell system in local memory, and that traffic sets the time.
#include "edge_side.cuh"

namespace su2k {

template <typename T>
__global__ void edge_win_kernel(int n, EdgeConsts c, Grid<T> g,
                                const T* __restrict__ f,
                                const T* __restrict__ fam_normal,
                                const T* __restrict__ fam_evec,
                                const T* __restrict__ tab,
                                const T* __restrict__ cst,
                                T* __restrict__ res, T* __restrict__ lc,
                                T* __restrict__ lv) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int nvar = c.ns + c.nd + 2;
  T acc[SU2K_MAXV], own[SU2K_MAXV], fo[SU2K_MAXV];
  T lc_acc = (T)0, lv_acc = (T)0, lc_own = (T)0, lv_own = (T)0;
#pragma unroll 1
  for (int k = 0; k < c.kh; ++k) {
    int q = p - c.off[k];
    if (q < 0) q += n;
#pragma unroll 1
    for (int side = 0; side < 2; ++side) {
      T lco, lvo, nm[SU2K_MAXD], ev[SU2K_MAXD];
      const int s = side == 0 ? p : q;
      const int j = fam_slot(n, c, fam_normal, fam_evec, k, s, nm, ev);
      edge_side<T>(n, c, g, f, s, j, nm, ev, tab, cst, fo, lco, lvo);
      if (side == 0) {
        for (int r = 0; r < nvar; ++r) own[r] = fo[r];
        lc_own = lco;
        lv_own = lvo;
        continue;
      }
      T lcn = lc_own + lco, lvn = lv_own + lvo;
      if (k == 0) {
        for (int r = 0; r < nvar; ++r) acc[r] = own[r] - fo[r];
        lc_acc = lcn;
        lv_acc = lvn;
      } else {
        for (int r = 0; r < nvar; ++r) acc[r] = acc[r] + (own[r] - fo[r]);
        lc_acc = lc_acc + lcn;
        lv_acc = lv_acc + lvn;
      }
    }
  }
  // feature-major (nVar, N)
  for (int r = 0; r < nvar; ++r) res[(size_t)r * n + p] = acc[r];
  lc[p] = lc_acc;
  lv[p] = lv_acc;
}

template <typename T>
int launch_edge_win(int n, EdgeConsts c, int nt, double t0, double dt,
                    const void* f, const void* nrm, const void* evec,
                    const void* tab, const void* cst, void* res, void* lc,
                    void* lv, void* stream) {
  Grid<T> g{(T)t0, (T)dt, (T)(t0 + (nt - 1) * dt), (T)(dt * dt), nt};
  int threads = 128;
  int blocks = (n + threads - 1) / threads;
  if (blocks > 0)
    edge_win_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        n, c, g, (const T*)f, (const T*)nrm, (const T*)evec, (const T*)tab,
        (const T*)cst, (T*)res, (T*)lc, (T*)lv);
  return (int)cudaGetLastError();
}

}  // namespace su2k

extern "C" int su2k_edge_win(int is_f64, int n, int nd, int ns, int kh,
                             const int* offsets, int nt, double t0, double dt,
                             double m_infty, double pr_lam, double pr_turb,
                             double le_turb, double mm_sum, const void* f,
                             const void* nrm, const void* evec,
                             const void* tab, const void* cst, void* res,
                             void* lc, void* lv, void* stream) {
  if (ns > SU2K_MAXS || nd > SU2K_MAXD || kh < 1 || kh > SU2K_MAXK)
    return (int)cudaErrorInvalidValue;
  su2k::EdgeConsts c{m_infty, pr_lam, pr_turb, le_turb, mm_sum,
                     nd, ns, kh, {0}};
  for (int k = 0; k < kh; ++k) {
    if (offsets[k] <= 0 || offsets[k] >= n) return (int)cudaErrorInvalidValue;
    c.off[k] = offsets[k];
  }
  if (is_f64)
    return su2k::launch_edge_win<double>(n, c, nt, t0, dt, f, nrm, evec, tab,
                                         cst, res, lc, lv, stream);
  return su2k::launch_edge_win<float>(n, c, nt, t0, dt, f, nrm, evec, tab,
                                      cst, res, lc, lv, stream);
}

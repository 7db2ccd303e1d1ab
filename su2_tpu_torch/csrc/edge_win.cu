// K8: the explicit interior edge terms summed per node.  For node p and
// each family k in order (positive offsets o_k), with q = p - o_k mod n
// and flux_k / lc_k / lv_k the per-slot outputs of edge_side
// (csrc/edge_side.cuh):
//   res[:, p] = sum_k (flux_k[p] - flux_k[q])
//   lc[p]     = sum_k (lc_k[p] + lc_k[q]),  lv[p] likewise,
// the subtraction (addition) formed before each family's add, which is the
// roll-subtract order of ops/edge_flux.py.  Slots without an edge carry
// zero normals, so their terms are exactly zero; no atomics.
//
// Replaces su2_tpu/pallas/edge_fused.py:346 _edge_win_call (the windowed
// multi-family kernel of the >= 200k-node tier, via fused_interior_terms
// :632-659).  The TPU kernel DMAs one halo window of the stack per tile
// and rolls it in VMEM.
//
// Bound on the H100: bytes, by roofline.  Per node it reads the stack
// column and the Kh normals/edge vectors and writes nVar + 2 values; the
// work is Kh edge evaluations (~2.5 kFLOP each, ~6 FLOP/B).  Design: two
// passes from one C call, so every edge is evaluated once.  The first,
// edge_win_slot_kernel, is T3's slot pass (edge_slot in edge_side.cuh:
// one thread per family slot, edge_side at a compile-time shape, its
// S x (S+1) system in registers) into a scratch (Kh, nVar + 2, n) the
// wrapper allocates; the second, edge_win_sum_kernel, one thread per
// (output row, node), forms the sums above from the scratch (its reads of
// q = p - o_k are the same rows shifted, so they coalesce).  The scratch
// costs one write and one read of Kh (nVar + 2) values per node, ~0.04 ms
// at 565,500 nodes in f32 against the evaluations' time.  The former
// design evaluated both edges of each family in every thread (every edge
// twice) with the system in local memory.  A one-launch form, a tile of
// slots in shared memory with a halo as wide as the largest offset (377
// slots at 565,500 nodes), evaluates the halo's edges twice (1.19x the
// evaluations at a 1,024-node tile) and was measured no faster (PERF.md).
#include "edge_side.cuh"

namespace su2k {

// row r < nvar: res[r, p] = sum_k flux[k, r, p] - flux[k, r, q_k]; rows
// nvar and nvar + 1: lc and lv, sum_k x[k, p] + x[k, q_k]
template <typename T>
__global__ void edge_win_sum_kernel(int n, int nvar, EdgeConsts c,
                                     const T* __restrict__ flux,
                                     const T* __restrict__ lcs,
                                     const T* __restrict__ lvs,
                                     T* __restrict__ res, T* __restrict__ lc,
                                     T* __restrict__ lv) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;
  if (p >= n) return;
  const bool radius = r >= nvar;
  const T* src = r == nvar ? lcs : (r > nvar ? lvs : flux + (size_t)r * n);
  const size_t stride = radius ? (size_t)n : (size_t)nvar * n;
  T acc = (T)0;
  for (int k = 0; k < c.kh; ++k) {
    int q = p - fam_offset(c, k);
    if (q < 0) q += n;
    const T* row = src + (size_t)k * stride;
    const T d = radius ? row[p] + row[q] : row[p] - row[q];
    acc = k == 0 ? d : acc + d;
  }
  T* out = r == nvar ? lc : (r > nvar ? lv : res + (size_t)r * n);
  out[p] = acc;
}

template <typename T>
int launch_edge_win(int n, EdgeConsts c, int nt, double t0, double dt,
                    const void* f, const void* nrm, const void* evec,
                    const void* tab, const void* cst, void* sflux,
                    void* slc, void* slv, void* res, void* lc, void* lv,
                    void* stream) {
  Grid<T> g{(T)t0, (T)dt, (T)(t0 + (nt - 1) * dt), (T)(dt * dt), nt};
  cudaStream_t s = (cudaStream_t)stream;
  int err = launch_edge_slots<T, true>(n, c, g, (const T*)f,
                                       (const T*)nrm, (const T*)evec,
                                       (const T*)tab, (const T*)cst,
                                       (T*)sflux, (T*)slc, (T*)slv, s);
  if (err != (int)cudaSuccess || n <= 0) return err;
  const int nvar = c.ns + c.nd + 2;
  const int threads = 256;
  dim3 grid((n + threads - 1) / threads, nvar + 2);
  edge_win_sum_kernel<T><<<grid, threads, 0, s>>>(
      n, nvar, c, (const T*)sflux, (const T*)slc, (const T*)slv, (T*)res,
      (T*)lc, (T*)lv);
  return (int)cudaGetLastError();
}

}  // namespace su2k

// sflux (Kh, nVar, n), slc, slv (Kh, n): the slot pass's scratch
extern "C" int su2k_edge_win(int is_f64, int n, int nd, int ns, int kh,
                             const int* offsets, int nt, double t0, double dt,
                             double m_infty, double pr_lam, double pr_turb,
                             double le_turb, double mm_sum, const void* f,
                             const void* nrm, const void* evec,
                             const void* tab, const void* cst, void* sflux,
                             void* slc, void* slv, void* res, void* lc,
                             void* lv, void* stream) {
  if (kh < 1 || kh > SU2K_MAXK) return (int)cudaErrorInvalidValue;
  su2k::EdgeConsts c{m_infty, pr_lam, pr_turb, le_turb, mm_sum,
                     nd, ns, kh, {0}};
  for (int k = 0; k < kh; ++k) {
    if (offsets[k] <= 0 || offsets[k] >= n) return (int)cudaErrorInvalidValue;
    c.off[k] = offsets[k];
  }
  if (is_f64)
    return su2k::launch_edge_win<double>(n, c, nt, t0, dt, f, nrm, evec, tab,
                                         cst, sflux, slc, slv, res, lc, lv,
                                         stream);
  return su2k::launch_edge_win<float>(n, c, nt, t0, dt, f, nrm, evec, tab,
                                      cst, sflux, slc, slv, res, lc, lv,
                                      stream);
}

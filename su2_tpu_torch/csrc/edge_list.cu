// K13: explicit interior edge terms of the reactive RANS residual over an
// edge list, for meshes without a static stencil.  Per edge e = (i, j):
// AUSM+-up convective flux, viscous flux with Stefan-Maxwell diffusion and
// the SST closure, species h/cp at the face-mean temperature, and the
// convective and viscous spectral radii, by edge_side (csrc/edge_side.cuh),
// the device function kernels T3 and K8 run on the family slots.
//
// Replaces su2_tpu/pallas/edge_fused.py:494 fused_edge_flux_pallas (via
// fused_interior_terms :561, the edge-list branch :677-686).  The TPU path
// gathers the (48, E) endpoint stacks f_all[:, i] and f_all[:, j] and the
// edge vectors in XLA and streams them through the kernel in 128-lane
// tiles; here each thread reads the two endpoint columns of the stack
// F (48, nP) straight through edges[e], forms coords[j] - coords[i] itself
// (the one subtraction su2_tpu does outside its kernel) and reads the
// edge's normal, so the gathered copies are never written.  The node sums
// stay in torch (MeshArrays.scatter_edges_mixed: a gather and a slot sum,
// no atomics).
//
// Bound on the H100: bytes, by roofline.  An edge needs 2 x 48 stack
// values, its two node ids, 2 d coordinates and d normal components, and
// writes nVar + 2 values, against ~2.5 kFLOP (~6 FLOP/B in f32, under the
// ~20 FLOP/B ridge).  With the stack read once per node (not per edge) the
// floor is the stack plus the per-edge arrays.  This simple design stays
// above it: in a scrambled node order the 32 threads of a warp read 32
// unrelated columns of every stack row (uncoalesced, each 4 or 8 bytes
// from its own 32-byte sector).  One thread per edge, f32 and f64, the
// per-edge body at T3's compile-time (dimension, species count) shapes, or
// its run-time instance for every other shape.
#include "edge_side.cuh"

namespace su2k {

template <typename T, int ND, int NS>
__global__ void edge_list_kernel(int n, int ne, EdgeConsts c, Grid<T> g,
                                 const T* __restrict__ f,
                                 const long long* __restrict__ edges,
                                 const T* __restrict__ normal,
                                 const T* __restrict__ coords,
                                 const T* __restrict__ tab,
                                 const T* __restrict__ cst,
                                 T* __restrict__ flux, T* __restrict__ lc,
                                 T* __restrict__ lv) {
  constexpr int MD = ND > 0 ? ND : SU2K_MAXD;
  constexpr int MV = ND > 0 ? NS + ND + 2 : SU2K_MAXV;
  const int nd = ND > 0 ? ND : c.nd;
  const int nv = ND > 0 ? NS + ND + 2 : c.ns + c.nd + 2;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= ne) return;
  const int i = (int)edges[2 * (size_t)e];
  const int j = (int)edges[2 * (size_t)e + 1];
  T nm[MD], ev[MD], fo[MV];
  for_n<ND>(nd, [&](int d) {
    nm[d] = normal[(size_t)e * nd + d];
    ev[d] = coords[(size_t)j * nd + d] - coords[(size_t)i * nd + d];
  });
  T lco, lvo;
  edge_side<ND, NS>(n, c, g, f, i, j, nm, ev, tab, cst, fo, lco, lvo);
  // feature-major (nVar, E), edge order
  for_n<(ND > 0 ? NS + ND + 2 : 0)>(nv, [&](int r) {
    flux[(size_t)r * ne + e] = fo[r];
  });
  lc[e] = lco;
  lv[e] = lvo;
}

template <typename T>
int launch_edge_list(int n, int ne, EdgeConsts c, int nt, double t0,
                     double dt, const void* f, const void* edges,
                     const void* nrm, const void* coords, const void* tab,
                     const void* cst, void* flux, void* lc, void* lv,
                     void* stream) {
  Grid<T> g{(T)t0, (T)dt, (T)(t0 + (nt - 1) * dt), (T)(dt * dt), nt};
  const int threads = 128;
  const int blocks = (ne + threads - 1) / threads;
#define SU2K_K13_CASE(ND_, NS_)                                             \
  if (c.nd == ND_ && c.ns == NS_) {                                         \
    if (blocks > 0)                                                         \
      edge_list_kernel<T, ND_, NS_>                                         \
          <<<blocks, threads, 0, (cudaStream_t)stream>>>(                   \
              n, ne, c, g, (const T*)f, (const long long*)edges,            \
              (const T*)nrm, (const T*)coords, (const T*)tab,               \
              (const T*)cst, (T*)flux, (T*)lc, (T*)lv);                     \
    return (int)cudaGetLastError();                                         \
  }
  if (!edge_shape_ok(c.nd, c.ns)) return (int)cudaErrorInvalidValue;
  SU2K_EDGE_BY_SHAPE(SU2K_K13_CASE)
#undef SU2K_K13_CASE
  // every other shape: the run-time instance
  if (blocks > 0)
    edge_list_kernel<T, 0, 0><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        n, ne, c, g, (const T*)f, (const long long*)edges, (const T*)nrm,
        (const T*)coords, (const T*)tab, (const T*)cst, (T*)flux, (T*)lc,
        (T*)lv);
  return (int)cudaGetLastError();
}

}  // namespace su2k

extern "C" int su2k_edge_list(int is_f64, int n, int ne, int nd, int ns,
                              int nt, double t0, double dt, double m_infty,
                              double pr_lam, double pr_turb, double le_turb,
                              double mm_sum, const void* f, const void* edges,
                              const void* nrm, const void* coords,
                              const void* tab, const void* cst, void* flux,
                              void* lc, void* lv, void* stream) {
  if (n < 1 || ne < 0)
    return (int)cudaErrorInvalidValue;
  su2k::EdgeConsts c{m_infty, pr_lam, pr_turb, le_turb, mm_sum,
                     nd, ns, 0, {0}};
  if (is_f64)
    return su2k::launch_edge_list<double>(n, ne, c, nt, t0, dt, f, edges,
                                          nrm, coords, tab, cst, flux, lc,
                                          lv, stream);
  return su2k::launch_edge_list<float>(n, ne, c, nt, t0, dt, f, edges, nrm,
                                       coords, tab, cst, flux, lc, lv,
                                       stream);
}

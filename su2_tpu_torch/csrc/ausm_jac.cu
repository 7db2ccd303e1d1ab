// K11: the AUSM+-up convective flux and both its Jacobians per edge
// (CUpwReactiveAUSM::ComputeResidual with the implicit part,
// numerics_direct_reactive.cpp:53-383), 2D.  Per edge e: from the two
// sides' primitives v_i, v_j (nPrim), the area normal (2) and the sides'
// dP/dU rows s_i, s_j (nVar), the flux (nVar) and the blocks jac_i, jac_j
// (nVar x nVar).  Arithmetic: ops/ausm_t.py ausm_flux_t and _jacobians,
// the plain version, through the device functions that K10 runs too
// (edge_side.cuh ausm_face, ausm_jac_entry).
//
// Replaces su2_tpu/pallas/edge_kernels.py:91 ausm_flux_jac_pallas_t (the
// feature-major layout: every array (features, E), lanes = edges, what
// the family assembly of the laminar implicit step consumes; slots of
// family k are lanes k nP .. (k + 1) nP - 1) and :34 ausm_flux_jac_pallas
// (the edge-major layout (E, features)), behind one template flag.
//
// Bound on the H100: bytes.  An edge reads 2 x 16 + 2 + 2 x 13 = 60 values
// and writes 13 + 2 x 169 = 351 (1.64 KB in f32) against ~3 kFLOP, far
// below the card's ~20 FLOP per byte.  Design: one thread per edge; the
// species count is a template constant, so the loops unroll and the four
// nVar column vectors of the Jacobians stay in registers (2 x 169 entries
// are never held); every other count up to 16 runs one run-time instance
// (NS = 0, its vectors in local memory, so no mixture is refused); each
// output row is formed and stored at once, so in
// the feature-major layout a warp's loads and stores coalesce.  A
// zero-area edge (a family pad slot) writes exact zeros and reads no
// state, so no NaN can reach a sum that a mask would not hide.
#include "edge_side.cuh"

namespace su2k {

constexpr int AUSM_ND = 2;

template <typename T, int NS, bool EDGE_MAJOR>
__global__ void __launch_bounds__(128)
ausm_jac_kernel(int ne, int ns_rt, double m_infty, const T* __restrict__ v_i,
                const T* __restrict__ v_j, const T* __restrict__ nrm,
                const T* __restrict__ s_i, const T* __restrict__ s_j,
                T* __restrict__ flux, T* __restrict__ jac_i,
                T* __restrict__ jac_j) {
  // NS = 0: the species count ns_rt known at run time (at most SU2K_MAXS),
  // the arrays at that bound
  constexpr int ND = AUSM_ND, MS = NS > 0 ? NS : SU2K_MAXS;
  constexpr int MPRIM = MS + ND + 5, MV = MS + ND + 2;
  const int ns = NS > 0 ? NS : ns_rt;
  const int NPRIM = ns + ND + 5, NV = ns + ND + 2;
  const int PRHO = ND + 2;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= ne) return;
  // element r of an e-th row of width w in either layout
  auto at = [&](int w, int r) -> size_t {
    return EDGE_MAJOR ? (size_t)e * w + r : (size_t)r * ne + e;
  };
  T nm[ND];
#pragma unroll
  for (int d = 0; d < ND; ++d) nm[d] = nrm[at(ND, d)];
  const T area = sqrt(nm[0] * nm[0] + nm[1] * nm[1]);
  if (area == (T)0) {
#pragma unroll
    for (int a = 0; a < NV; ++a) flux[at(NV, a)] = (T)0;
    for (int r = 0; r < NV * NV; ++r) {
      jac_i[at(NV * NV, r)] = (T)0;
      jac_j[at(NV * NV, r)] = (T)0;
    }
    return;
  }
  const T tiny = sizeof(T) == 8 ? (T)1e-300 : (T)1e-30;
  const T area_s = area > tiny ? area : tiny;
  T unit[ND];
#pragma unroll
  for (int d = 0; d < ND; ++d) unit[d] = nm[d] / area_s;
  T vfi[MPRIM], vfj[MPRIM], si[MV], sj[MV];
#pragma unroll
  for (int r = 0; r < NPRIM; ++r) {
    vfi[r] = v_i[at(NPRIM, r)];
    vfj[r] = v_j[at(NPRIM, r)];
  }
#pragma unroll
  for (int r = 0; r < NV; ++r) {
    si[r] = s_i[at(NV, r)];
    sj[r] = s_j[at(NV, r)];
  }
  T fo[MV], w_l[MV], w_r[MV], pr_l[MV], pr_r[MV];
  const AusmFace<T> af = ausm_face<ND>(NV, m_infty, vfi, vfj, si, sj, unit,
                                       area, fo, w_l, w_r, pr_l, pr_r);
#pragma unroll
  for (int a = 0; a < NV; ++a) flux[at(NV, a)] = fo[a];
  const T rho_i = vfi[PRHO], rho_j = vfj[PRHO];
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    T* out = side ? jac_j : jac_i;
    const T* w = side ? w_r : w_l;
    const T* pr = side ? pr_r : pr_l;
    const T* sv = side ? sj : si;
#pragma unroll
    for (int a = 0; a < NV; ++a) {
      const T rpi = rho_i * ausm_phi<ND>(vfi, a);
      const T rpj = rho_j * ausm_phi<ND>(vfj, a);
#pragma unroll
      for (int b = 0; b < NV; ++b)
        out[at(NV * NV, a * NV + b)] =
            ausm_jac_entry<ND>(af, side != 0, a, b, rpi, rpj, w, pr, sv,
                               unit) * area;
    }
  }
}

// the species counts K11 is compiled for (kernels.AUSM_SPECIES): the
// case's 9 (nVar = 13); every other count up to SU2K_MAXS runs the
// run-time instance (NS = 0)
#define SU2K_AUSM_BY_NS(X) X(9)

template <typename T, bool EDGE_MAJOR>
int launch_ausm_jac(int ne, int ns, double m_infty, const void* vi,
                    const void* vj, const void* nrm, const void* si,
                    const void* sj, void* flux, void* ji, void* jj,
                    void* stream) {
  const int threads = 128;
  const unsigned blocks = (unsigned)((ne + threads - 1) / threads);
  if (ns < 1 || ns > SU2K_MAXS) return (int)cudaErrorInvalidValue;
  if (ne <= 0) return (int)cudaSuccess;
#define SU2K_AUSM_CASE(NS_)                                                 \
  if (ns == NS_) {                                                          \
    ausm_jac_kernel<T, NS_, EDGE_MAJOR>                                     \
        <<<blocks, threads, 0, (cudaStream_t)stream>>>(                     \
            ne, ns, m_infty, (const T*)vi, (const T*)vj, (const T*)nrm,     \
            (const T*)si, (const T*)sj, (T*)flux, (T*)ji, (T*)jj);          \
    return (int)cudaGetLastError();                                         \
  }
  SU2K_AUSM_BY_NS(SU2K_AUSM_CASE)
#undef SU2K_AUSM_CASE
  ausm_jac_kernel<T, 0, EDGE_MAJOR>
      <<<blocks, threads, 0, (cudaStream_t)stream>>>(
          ne, ns, m_infty, (const T*)vi, (const T*)vj, (const T*)nrm,
          (const T*)si, (const T*)sj, (T*)flux, (T*)ji, (T*)jj);
  return (int)cudaGetLastError();
}

}  // namespace su2k

extern "C" int su2k_ausm_flux_jac(int is_f64, int edge_major, int ne, int nd,
                                  int ns, double m_infty, const void* vi,
                                  const void* vj, const void* nrm,
                                  const void* si, const void* sj, void* flux,
                                  void* ji, void* jj, void* stream) {
  if (nd != su2k::AUSM_ND) return (int)cudaErrorInvalidValue;
  if (is_f64)
    return edge_major
        ? su2k::launch_ausm_jac<double, true>(ne, ns, m_infty, vi, vj, nrm,
                                              si, sj, flux, ji, jj, stream)
        : su2k::launch_ausm_jac<double, false>(ne, ns, m_infty, vi, vj, nrm,
                                               si, sj, flux, ji, jj, stream);
  return edge_major
      ? su2k::launch_ausm_jac<float, true>(ne, ns, m_infty, vi, vj, nrm, si,
                                           sj, flux, ji, jj, stream)
      : su2k::launch_ausm_jac<float, false>(ne, ns, m_infty, vi, vj, nrm, si,
                                            sj, flux, ji, jj, stream);
}

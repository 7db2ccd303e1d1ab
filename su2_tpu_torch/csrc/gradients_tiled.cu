// K7: the stencil gradient sweep emitting feature-major rows.  For the
// feature-major field q_t (nG, n) and the K signed stencil offsets o_k, row
// g*d + dd of the output (nG*d, n) at node p is d(q_g)/dx_dd:
//   WLS: sum_k coef_k[p, dd] (q(p + o_k) - q(p))
//   GG:  (sum_k 0.5 (q(p) + q(p + o_k)) sn_k[p, dd] - q(p) nb[p, dd])
//        / (vol(p) > 0 ? vol(p) : 1)
// with the offsets taken in order and p + o_k wrapped mod n (torch.roll);
// absent neighbours carry zero coefficients.  coef/sn are the mesh's
// (K, n, d) per-offset tables, nb the (n, d) accumulated boundary normal.
//
// Replaces su2_tpu/pallas/gradients_tiled.py:55 _grad_tiled_call (the
// windowed-DMA sweep of the >= 200k-node tier).  Its 128-lane windows,
// halo planning and VMEM sizing are TPU devices and have no counterpart.
//
// Bound on the H100: bytes.  Per node it reads nG values of q, K*d
// coefficients (+ d + 1 for GG) and writes nG*d values, against ~3 K d nG
// operations: ~0.5 FLOP/B, far under the ridge.  Design: one thread per
// node, nodes fastest, so every read of q_t, of its K shifted copies
// (served from L1/L2) and every write of the output rows coalesces.  The
// thread reads its K*d coefficients once into registers (d is a template
// argument, the offset loop unrolled to its cap) and loops over the nG
// variables, so the (K, n, d) table crosses HBM once, not once per
// variable (its 36 MB at 565,500 nodes in f32 do not stay in L2).
#include "common.cuh"

#define SU2K_MAXKS 16          // stencil offsets

namespace su2k {

struct StencilOffsets {
  int off[SU2K_MAXKS];
};

template <typename T, bool GG, int ND>
__global__ void grad_rows_kernel(int n, int ng, int kk, StencilOffsets so,
                                 const T* __restrict__ q,
                                 const T* __restrict__ coef,
                                 const T* __restrict__ nb,
                                 const T* __restrict__ vol,
                                 T* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  int nbr[SU2K_MAXKS];
  T c[SU2K_MAXKS][ND];
#pragma unroll
  for (int k = 0; k < SU2K_MAXKS; ++k) {
    if (k < kk) {
      int j = p + so.off[k];
      nbr[k] = j >= n ? j - n : (j < 0 ? j + n : j);
#pragma unroll
      for (int dd = 0; dd < ND; ++dd)
        c[k][dd] = coef[((size_t)k * n + p) * ND + dd];
    }
  }
  T nbp[ND];
  T safe = (T)1;
  if (GG) {
#pragma unroll
    for (int dd = 0; dd < ND; ++dd) nbp[dd] = nb[(size_t)p * ND + dd];
    T v = vol[p];
    safe = v > (T)0 ? v : (T)1;
  }
#pragma unroll 1
  for (int g = 0; g < ng; ++g) {
    const T* qg = q + (size_t)g * n;
    const T qp = qg[p];
    T acc[ND];
#pragma unroll
    for (int k = 0; k < SU2K_MAXKS; ++k) {
      if (k < kk) {
        const T qj = qg[nbr[k]];
        const T w = GG ? (T)0.5 * (qp + qj) : qj - qp;
#pragma unroll
        for (int dd = 0; dd < ND; ++dd) {
          T t = GG ? w * c[k][dd] : c[k][dd] * w;
          acc[dd] = k == 0 ? t : acc[dd] + t;
        }
      }
    }
#pragma unroll
    for (int dd = 0; dd < ND; ++dd) {
      T r = GG ? (acc[dd] - qp * nbp[dd]) / safe : acc[dd];
      out[((size_t)g * ND + dd) * n + p] = r;
    }
  }
}

template <typename T, int ND>
void launch_nd(int gg, int n, int ng, int kk, const StencilOffsets& so,
               const void* q, const void* coef, const void* nb,
               const void* vol, void* out, cudaStream_t stream) {
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  if (gg)
    grad_rows_kernel<T, true, ND><<<blocks, threads, 0, stream>>>(
        n, ng, kk, so, (const T*)q, (const T*)coef, (const T*)nb,
        (const T*)vol, (T*)out);
  else
    grad_rows_kernel<T, false, ND><<<blocks, threads, 0, stream>>>(
        n, ng, kk, so, (const T*)q, (const T*)coef, (const T*)nb,
        (const T*)vol, (T*)out);
}

template <typename T>
int launch_grad_rows(int gg, int n, int ng, int nd, int kk,
                     const StencilOffsets& so, const void* q,
                     const void* coef, const void* nb, const void* vol,
                     void* out, void* stream) {
  if (n > 0) {
    if (nd == 2)
      launch_nd<T, 2>(gg, n, ng, kk, so, q, coef, nb, vol, out,
                      (cudaStream_t)stream);
    else
      launch_nd<T, 3>(gg, n, ng, kk, so, q, coef, nb, vol, out,
                      (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}

}  // namespace su2k

extern "C" int su2k_gradient_rows(int is_f64, int gg, int n, int ng, int nd,
                                  int kk, const int* offsets, const void* q,
                                  const void* coef, const void* nb,
                                  const void* vol, void* out, void* stream) {
  if (nd < 2 || nd > SU2K_MAXD || kk < 1 || kk > SU2K_MAXKS || ng < 1)
    return (int)cudaErrorInvalidValue;
  su2k::StencilOffsets so{{0}};
  for (int k = 0; k < kk; ++k) {
    if (offsets[k] <= -n || offsets[k] >= n) return (int)cudaErrorInvalidValue;
    so.off[k] = offsets[k];
  }
  if (is_f64)
    return su2k::launch_grad_rows<double>(gg, n, ng, nd, kk, so, q, coef, nb,
                                          vol, out, stream);
  return su2k::launch_grad_rows<float>(gg, n, ng, nd, kk, so, q, coef, nb,
                                       vol, out, stream);
}

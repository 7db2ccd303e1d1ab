// K7: the stencil gradient sweep emitting feature-major rows.  For the
// node-major field q (n, nG) and the K signed stencil offsets o_k, row
// g*d + dd of the output (nG*d, n) at node p is d(q_g)/dx_dd:
//   WLS: sum_k coef_k[p, dd] (q(p + o_k) - q(p))
//   GG:  (sum_k 0.5 (q(p) + q(p + o_k)) sn_k[p, dd] - q(p) nb[p, dd])
//        / (vol(p) > 0 ? vol(p) : 1)
// with the offsets taken in order and p + o_k wrapped mod n (torch.roll);
// absent neighbours carry zero coefficients.  coef/sn are the mesh's
// (K, n, d) per-offset tables, nb the (n, d) accumulated boundary normal.
//
// Replaces su2_tpu/pallas/gradients_tiled.py:55 _grad_tiled_call (the
// windowed-DMA sweep of the >= 200k-node tier).  Its 128-lane windows and
// VMEM sizing are TPU devices; the window below is the H100's own.
//
// Bound on the H100: bytes.  Per node it reads nG values of q, K*d
// coefficients (+ d + 1 for GG) and writes nG*d values, against ~3 K d nG
// operations: ~0.5 FLOP/B, far under the ridge.
//
// Design: two forms of one per-node body (node_rows), chosen per call by
// kernels.k7_plan on the host:
// - The window form.  A block owns T consecutive nodes [s, s + T) and
//   stages the rows q[s - hlo, s + T + hhi) (hlo, hhi: the largest
//   backward and forward offset) into shared memory with cp.async: the
//   span is one contiguous block of the node-major field, copied in
//   16-byte pieces where its global and shared addresses agree mod 16
//   (the window starts at an element offset `pad` that makes them agree
//   for its first piece), element by element elsewhere.  Where the window
//   wraps past 0 or n it is two or three pieces, each copied alone.  A
//   block has T / SU2K_K7_NPT threads; each takes nodes s + threadIdx.x +
//   j * blockDim.x, loading the next node's coefficients while it forms
//   one node's rows, and reads its
//   K taps from shared memory (index stride nG words: conflict-free lanes
//   for odd nG, the flow's 13 and the merged sweep's 15), so q crosses
//   L2 -> SM (T + hlo + hhi) / T times instead of once per tap, and the
//   host transposes nothing.  The coefficient table is read once,
//   coalesced, the first node's before the staging completes; the rows
//   (nG*d, n) are written coalesced, as K8, K10 and rows_to_grad read them.
//   kernels.k7_plan sizes T so that two blocks share an SM and the
//   windows fill whole waves of the card (at 565,500 nodes 1,024-node
//   windows would leave a third wave of 25 blocks).
// - The streamed form, for a mesh whose window does not fit shared memory
//   (kernels.k7_plan): one thread per node reading q node-major through
//   L1/L2, with the neighbours' indices wrapped per node.
// The offset count K and the dimension d are template constants for the
// stencils of SU2K_K7_BY_KD (the 2D quad channel: 4 offsets, the 3D hex
// box: 6), so the per-node coefficients and tap offsets sit in registers
// with every loop unrolled; every other count up to SU2K_K7_MAXK runs the
// run-time-K instance (K = 0) of the same body, its loops unrolled to the
// cap under k < K guards and every array declared at kernel scope.
// The per-node arithmetic and summation order are the plain version's.
#include "common.cuh"

#define SU2K_K7_MAXK 16        // stencil offsets of the run-time-K instance
#define SU2K_K7_THREADS 256    // threads per block of the streamed form
#define SU2K_K7_NPT 4          // nodes per thread of the window form
#define SU2K_K7_MAXW 2048      // nodes per window at most
// the (offset count, dimension) pairs K7 is compiled for
// (kernels.K7_STENCILS); every other count runs the run-time-K instance
#define SU2K_K7_BY_KD(X) X(4, 2) X(6, 3)

namespace su2k {

struct K7Offsets {
  int off[SU2K_K7_MAXK];
};

__host__ __device__ constexpr int k7_cap(int k) {
  return k > 0 ? k : SU2K_K7_MAXK;
}

// the rows of node p: qr points at q(p, 0) (shared memory or global),
// dq[k] is the element offset of the k-th neighbour's row from qr
template <typename T, int K, int ND, bool GG>
__device__ __forceinline__ void node_rows(
    int n, int ng, int nk, int p, const T* qr, const int (&dq)[k7_cap(K)],
    T (&c)[k7_cap(K)][ND], T (&nbp)[ND], T (&acc)[ND],
    const T* __restrict__ coef, const T* __restrict__ nb,
    const T* __restrict__ vol, T* __restrict__ out) {
  constexpr int KA = k7_cap(K);
  T safe = (T)1;
  if (GG) {
#pragma unroll
    for (int dd = 0; dd < ND; ++dd) nbp[dd] = nb[(size_t)p * ND + dd];
    T v = vol[p];
    safe = v > (T)0 ? v : (T)1;
  }
#pragma unroll 1
  for (int g = 0; g < ng; ++g) {
    const T qp = qr[g];
#pragma unroll
    for (int k = 0; k < KA; ++k) {
      if (K > 0 || k < nk) {
        const T qj = qr[dq[k] + g];
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

template <typename T, int K, int ND>
__device__ __forceinline__ void load_coef(int n, int nk, int p,
                                          const T* __restrict__ coef,
                                          T (&c)[k7_cap(K)][ND]) {
#pragma unroll
  for (int k = 0; k < k7_cap(K); ++k)
    if (K > 0 || k < nk) {
#pragma unroll
      for (int dd = 0; dd < ND; ++dd)
        c[k][dd] = coef[((size_t)k * n + p) * ND + dd];
    }
}

template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"((int)sizeof(T)));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// cnt elements src[0, cnt) -> dst[0, cnt) by the block; gmis and smis are
// the element offsets of src and dst from a 16-byte boundary
template <typename T>
__device__ __forceinline__ void stage_span(T* dst, const T* src, int cnt,
                                           int gmis, int smis) {
  constexpr int V = 16 / (int)sizeof(T);
  int head = cnt, nvec = 0;
  if (gmis == smis) {
    head = min((V - smis) % V, cnt);
    nvec = (cnt - head) / V;
  }
  for (int i = threadIdx.x; i < head; i += blockDim.x)
    cp_async_elem(dst + i, src + i);
  for (int i = threadIdx.x; i < nvec; i += blockDim.x)
    cp_async16(dst + head + i * V, src + head + i * V);
  for (int i = head + nvec * V + threadIdx.x; i < cnt; i += blockDim.x)
    cp_async_elem(dst + i, src + i);
}

// shared memory of a window of tw nodes: the staged rows and one 16-byte
// alignment pad (kernels.k7_plan computes the same)
template <typename T>
size_t k7_window_smem(int tw, int hlo, int hhi, int ng) {
  return ((size_t)(tw + hlo + hhi) * ng + 16 / sizeof(T)) * sizeof(T);
}

template <typename T, int K, int ND, bool GG>
__global__ void __launch_bounds__(SU2K_K7_MAXW / SU2K_K7_NPT)
grad_rows_window_kernel(int n, int ng, int kk, int tw, int hlo, int hhi,
                        K7Offsets so, const T* __restrict__ q,
                        const T* __restrict__ coef,
                        const T* __restrict__ nb,
                        const T* __restrict__ vol, T* __restrict__ out) {
  constexpr int KA = k7_cap(K);
  constexpr int V = 16 / (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char k7_smem[];
  T* win = reinterpret_cast<T*>(k7_smem);
  const int nk = K > 0 ? K : kk;
  const int s = blockIdx.x * tw;
  const int cnt = min(tw, n - s);
  int dq[KA];
  T c[KA][ND], c2[KA][ND], nbp[ND], acc[ND];
  // the first node's coefficients load while the window stages
  if ((int)threadIdx.x < cnt)
    load_coef<T, K, ND>(n, nk, s + threadIdx.x, coef, c);
  // the window: unwrapped nodes [s - hlo, s + cnt + hhi), row u at
  // win[pad + u * ng], each piece within [0, n) staged alone
  const int gmis0 = (int)(((uintptr_t)q / sizeof(T)) % V);
  const int rows = cnt + hlo + hhi;
  const int j0 = (s - hlo + n) % n;
  const int pad = (int)((gmis0 + (size_t)j0 * ng) % V);
  for (int u = 0; u < rows;) {
    const int j = (j0 + u) % n;
    const int len = min(rows - u, n - j);
    const size_t e = (size_t)j * ng;
    stage_span(win + pad + (size_t)u * ng, q + e, len * ng,
               (int)((gmis0 + e) % V), (int)((pad + (size_t)u * ng) % V));
    u += len;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
#pragma unroll
  for (int k = 0; k < KA; ++k)
    if (K > 0 || k < nk) dq[k] = so.off[k] * ng;
  const int bd = blockDim.x;
  const T* wrow = win + pad + (size_t)hlo * ng;
  if constexpr (K > 0) {
    // two nodes a step: the next node's coefficients load while this
    // node's rows are formed
    for (int i = threadIdx.x; i < cnt; i += 2 * bd) {
      if (i + bd < cnt) load_coef<T, K, ND>(n, nk, s + i + bd, coef, c2);
      node_rows<T, K, ND, GG>(n, ng, nk, s + i, wrow + (size_t)i * ng, dq,
                              c, nbp, acc, coef, nb, vol, out);
      if (i + bd < cnt) {
        if (i + 2 * bd < cnt)
          load_coef<T, K, ND>(n, nk, s + i + 2 * bd, coef, c);
        node_rows<T, K, ND, GG>(n, ng, nk, s + i + bd,
                                wrow + (size_t)(i + bd) * ng, dq, c2, nbp,
                                acc, coef, nb, vol, out);
      }
    }
  } else {
    for (int i = threadIdx.x; i < cnt; i += bd) {
      if (i != (int)threadIdx.x) load_coef<T, K, ND>(n, nk, s + i, coef, c);
      node_rows<T, K, ND, GG>(n, ng, nk, s + i, wrow + (size_t)i * ng, dq,
                              c, nbp, acc, coef, nb, vol, out);
    }
  }
}

template <typename T, int K, int ND, bool GG>
__global__ void __launch_bounds__(SU2K_K7_THREADS)
grad_rows_streamed_kernel(int n, int ng, int kk, K7Offsets so,
                          const T* __restrict__ q,
                          const T* __restrict__ coef,
                          const T* __restrict__ nb,
                          const T* __restrict__ vol, T* __restrict__ out) {
  constexpr int KA = k7_cap(K);
  const int nk = K > 0 ? K : kk;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  int dq[KA];
  T c[KA][ND], nbp[ND], acc[ND];
  if (p >= n) return;
  load_coef<T, K, ND>(n, nk, p, coef, c);
#pragma unroll
  for (int k = 0; k < KA; ++k)
    if (K > 0 || k < nk) {
      const int j = p + so.off[k];
      dq[k] = ((j >= n ? j - n : (j < 0 ? j + n : j)) - p) * ng;
    }
  node_rows<T, K, ND, GG>(n, ng, nk, p, q + (size_t)p * ng, dq, c, nbp,
                          acc, coef, nb, vol, out);
}

template <typename T, int K, int ND, bool GG>
int launch_k7(int n, int ng, int kk, int tw, int hlo, int hhi, size_t smem,
              const K7Offsets& so, const T* q, const T* coef, const T* nb,
              const T* vol, T* out, cudaStream_t st) {
  if (tw > 0) {
    const void* kern = (const void*)grad_rows_window_kernel<T, K, ND, GG>;
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    grad_rows_window_kernel<T, K, ND, GG>
        <<<(n + tw - 1) / tw, tw / SU2K_K7_NPT, smem, st>>>(
            n, ng, kk, tw, hlo, hhi, so, q, coef, nb, vol, out);
  } else {
    grad_rows_streamed_kernel<T, K, ND, GG>
        <<<(n + SU2K_K7_THREADS - 1) / SU2K_K7_THREADS, SU2K_K7_THREADS, 0,
           st>>>(n, ng, kk, so, q, coef, nb, vol, out);
  }
  return (int)cudaGetLastError();
}

template <typename T, int K, int ND>
int launch_k7_gg(int gg, int n, int ng, int kk, int tw, int hlo, int hhi,
                 size_t smem, const K7Offsets& so, const void* q,
                 const void* coef, const void* nb, const void* vol,
                 void* out, cudaStream_t st) {
  if (gg)
    return launch_k7<T, K, ND, true>(n, ng, kk, tw, hlo, hhi, smem, so,
                                     (const T*)q, (const T*)coef,
                                     (const T*)nb, (const T*)vol, (T*)out,
                                     st);
  return launch_k7<T, K, ND, false>(n, ng, kk, tw, hlo, hhi, smem, so,
                                    (const T*)q, (const T*)coef, nullptr,
                                    nullptr, (T*)out, st);
}

template <typename T>
int launch_grad_rows(int gg, int n, int ng, int nd, int kk, int tw, int hlo,
                     int hhi, long long smem, const K7Offsets& so,
                     const void* q, const void* coef, const void* nb,
                     const void* vol, void* out, cudaStream_t st) {
  if (tw > 0 && (smem < (long long)k7_window_smem<T>(tw, hlo, hhi, ng)
                 || smem > 227 * 1024 || tw > SU2K_K7_MAXW
                 || tw % (32 * SU2K_K7_NPT) != 0))
    return (int)cudaErrorInvalidValue;
#define SU2K_K7_CASE(K_, ND_)                                               \
  if (kk == K_ && nd == ND_)                                                \
    return launch_k7_gg<T, K_, ND_>(gg, n, ng, kk, tw, hlo, hhi,            \
                                    (size_t)smem, so, q, coef, nb, vol,     \
                                    out, st);
  SU2K_K7_BY_KD(SU2K_K7_CASE)
#undef SU2K_K7_CASE
  if (nd == 2)
    return launch_k7_gg<T, 0, 2>(gg, n, ng, kk, tw, hlo, hhi, (size_t)smem,
                                 so, q, coef, nb, vol, out, st);
  return launch_k7_gg<T, 0, 3>(gg, n, ng, kk, tw, hlo, hhi, (size_t)smem, so,
                               q, coef, nb, vol, out, st);
}

}  // namespace su2k

// tw > 0: the window form with tw nodes per block, hlo / hhi the rows
// staged before / after them and smem the block's shared memory
// (kernels.k7_plan); tw == 0: the streamed form
extern "C" int su2k_gradient_rows(int is_f64, int gg, int n, int ng, int nd,
                                  int kk, const int* offsets, int tw,
                                  int hlo, int hhi, long long smem,
                                  const void* q, const void* coef,
                                  const void* nb, const void* vol, void* out,
                                  void* stream) {
  if (nd < 2 || nd > SU2K_MAXD || kk < 1 || kk > SU2K_K7_MAXK || ng < 1
      || tw < 0 || hlo < 0 || hhi < 0 || (tw > 0 && (hlo >= n || hhi >= n)))
    return (int)cudaErrorInvalidValue;
  su2k::K7Offsets so{{0}};
  for (int k = 0; k < kk; ++k) {
    if (offsets[k] <= -n || offsets[k] >= n) return (int)cudaErrorInvalidValue;
    if (tw > 0 && (offsets[k] < -hlo || offsets[k] > hhi))
      return (int)cudaErrorInvalidValue;
    so.off[k] = offsets[k];
  }
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (is_f64)
    return su2k::launch_grad_rows<double>(gg, n, ng, nd, kk, tw, hlo, hhi,
                                          smem, so, q, coef, nb, vol, out,
                                          st);
  return su2k::launch_grad_rows<float>(gg, n, ng, nd, kk, tw, hlo, hhi, smem,
                                       so, q, coef, nb, vol, out, st);
}

// T1: mixture enthalpy h(T, Y) = sum_s clip(Y_s) h_s(T) / M_s [J/kg].
//
// Replaces su2_tpu/pallas/thermo.py:66 mixture_enthalpy_pallas (the TPU
// kernel that turns the per-cell spline bin lookup into a one-hot MXU
// contraction).  Here each thread evaluates one point and gathers its
// spline knots straight from global memory.
//
// Bound on the H100: bytes.  Per point it reads T, S mass fractions and
// writes one value (~(S+2)*8 bytes in f64) against ~10*S flops; the
// (2S, nT) table gathers hit L1/L2, since neighbouring points share bins.
// Design: one thread per point, coalesced reads of T and of the point's
// contiguous Y row, no shared memory; the launch is bandwidth-limited by
// the Y rows.
#include "common.cuh"

namespace su2k {

template <typename T>
__global__ void mixture_enthalpy_kernel(int n, int ns, Grid<T> g,
                                        const T* __restrict__ t,
                                        const T* __restrict__ ys,
                                        const T* __restrict__ h_y,
                                        const T* __restrict__ h_y2,
                                        const T* __restrict__ mm,
                                        T* __restrict__ out) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  Bin<T> bn = spline_bin(g, t[p]);
  T acc = (T)0;
  for (int s = 0; s < ns; ++s) {
    T hs = spline_at(g, bn, h_y + (size_t)s * g.nt, h_y2 + (size_t)s * g.nt)
           / mm[s];
    acc += clip_y(ys[(size_t)p * ns + s]) * hs;
  }
  out[p] = acc;
}

template <typename T>
int launch_mixture_enthalpy(int n, int ns, int nt, double t0, double dt,
                            const void* t, const void* ys, const void* h_y,
                            const void* h_y2, const void* mm, void* out,
                            void* stream) {
  Grid<T> g{(T)t0, (T)dt, (T)(t0 + (nt - 1) * dt), (T)(dt * dt), nt};
  int threads = 256;
  int blocks = (n + threads - 1) / threads;
  if (blocks > 0)
    mixture_enthalpy_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        n, ns, g, (const T*)t, (const T*)ys, (const T*)h_y, (const T*)h_y2,
        (const T*)mm, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace su2k

extern "C" int su2k_mixture_enthalpy(int is_f64, int n, int ns, int nt,
                                     double t0, double dt, const void* t,
                                     const void* ys, const void* h_y,
                                     const void* h_y2, const void* mm,
                                     void* out, void* stream) {
  if (is_f64)
    return su2k::launch_mixture_enthalpy<double>(n, ns, nt, t0, dt, t, ys,
                                                 h_y, h_y2, mm, out, stream);
  return su2k::launch_mixture_enthalpy<float>(n, ns, nt, t0, dt, t, ys, h_y,
                                              h_y2, mm, out, stream);
}

// T4: species production omega_s of the finite-rate chemistry with the
// PaSR closure (reacting_model_library.cpp:99-227, :835-920).
//
// Replaces su2_tpu/pallas/chem_source.py:62 _chem_source_call (entry
// chem_source :173): Arrhenius forward and backward rates, the ln Kc /
// ln Kp spline lookup, the vanishing-species guards, dFr/drho and the PaSR
// factor k_r = max(1/(1 + tau_mix max_j |dFr_j M_j|), lb).
//
// Bound on the H100: operations in f64.  Per node it reads T, rho,
// omega_t and S mass fractions and writes S rates (~170 B in f64), but
// evaluates R*(2 exp + 2 pow) plus up to R*S pow for the concentration
// products; at tens of FP64 instructions per pow that is ~1 kFLOP, about
// the card's ~10 FLOP/B f64 ridge, with the transcendentals on the FP64
// pipe.  At 9,072 nodes the launch's few blocks leave the card mostly idle.
//
// Design: one thread per node, blocks of SU2K_CHEM_THREADS.
// - The species and reaction counts are template constants for the
//   shapes of SU2K_CHEM_BY_SR (the 9-species, 2-reaction case and the case
//   cut to 3 species), so ys, the clipped ys, the concentrations and the
//   per-reaction rates and PaSR factors are indexed only in unrolled loops
//   and stay in registers; every other shape up to SU2K_MAXS species and
//   SU2K_MAXR reactions runs the run-time-count instance (0, 0) of the
//   same body, its arrays declared at kernel scope.
// - The per-species and per-reaction constants (molar masses, Arrhenius
//   coefficients and flags, the exponents, the net stoichiometry and the
//   participation mask) travel by value in the kernel's parameters
//   (ChemConst, __grid_constant__): every thread reads the same word at
//   the same time from the constant bank.
// - The inputs are the column views the step passes (T, rho and Y of the
//   primitive rows, omega_t of the turbulence state): up to four row
//   sources, each a pointer, a row stride and the columns a block stages
//   (kernels._chem_sources groups views of one tensor into one source).
//   A block copies its rows of each source into shared memory (odd row
//   stride), so each warp reads contiguous runs of global memory, and the
//   wrapper copies nothing.  omega (N, S) is staged in shared memory and
//   stored by the block as one contiguous span.
// - The per-node arithmetic (products of pow(c_s, e) in species order,
//   the guards, the PaSR max, the summation orders) is the plain
//   version's, but terms whose result the reaction's constants discard
//   are not evaluated: the backward rate branch its flags do not select
//   (the plain version evaluates the Arrhenius and the Keq form for every
//   reaction and selects one) and dFr/drho of species outside the
//   reaction (the plain version multiplies it by 0).  The branches read
//   kernel parameters, so a warp never diverges on them.  Built with
//   approximate math the kernel takes ~60 % of its time at 565,500 nodes
//   (PERF.md §6): its IEEE pow, exp and divisions set the rest.
#include "common.cuh"

// the (species, reaction) counts T4 is compiled for (kernels.CHEM_SHAPES)
#define SU2K_CHEM_BY_SR(X) X(9, 2) X(3, 2)
#define SU2K_CHEM_THREADS 128   // threads per block
#define SU2K_CHEM_SRCS 4        // row sources

namespace su2k {

// MS, MR: the species and reaction capacity (the compiled counts, or
// SU2K_MAXS and SU2K_MAXR for the run-time instance)
template <typename T, int MS, int MR>
struct ChemConst {
  T mm[MS];
  T arr[MR][8];   // A, beta, Ta, A_b, beta_b, Ta_b, reversible, has_backward
  T ef[MR][MS];
  T eb[MR][MS];
  T dco[MS][MR];  // nu'' - nu'
  unsigned char part[MS];   // bit r: species s takes part in reaction r
  T c_mu, pasr_lb;
};

// the row sources of the inputs: row p of source i at src[i] + p *
// stride[i], of which width[i] values are staged; field f (T, rho, Y,
// omega_t) at column fcol[f] of source fsrc[f] (fsrc[3] < 0: no PaSR)
template <typename T>
struct ChemRows {
  const T* src[SU2K_CHEM_SRCS];
  long long stride[SU2K_CHEM_SRCS];
  int width[SU2K_CHEM_SRCS];
  int fsrc[4], fcol[4];
  int nsrc;
};

template <typename T>
size_t chem_smem(const ChemRows<T>& rw, int ns) {
  int w = ns | 1;
  for (int i = 0; i < rw.nsrc; ++i) w += rw.width[i] | 1;
  return (size_t)SU2K_CHEM_THREADS * w * sizeof(T);
}

__host__ __device__ constexpr int chem_cap(int c, int cap) {
  return c > 0 ? c : cap;
}

template <typename T, int S, int R>
__global__ void __launch_bounds__(SU2K_CHEM_THREADS)
chem_source_kernel(
    int n, int ns_rt, int nr_rt, Grid<T> g, ChemRows<T> rw,
    const T* __restrict__ tab,
    const __grid_constant__
    ChemConst<T, chem_cap(S, SU2K_MAXS), chem_cap(R, SU2K_MAXR)> cc,
    T* __restrict__ out) {
  constexpr int SA = chem_cap(S, SU2K_MAXS);
  constexpr int RA = chem_cap(R, SU2K_MAXR);
  extern __shared__ __align__(16) unsigned char chem_smem_buf[];
  T* sm = reinterpret_cast<T*>(chem_smem_buf);
  const int ns = S > 0 ? S : ns_rt;
  const int nr = R > 0 ? R : nr_rt;
  const int p0 = blockIdx.x * blockDim.x;
  const int cnt = min((int)blockDim.x, n - p0);
  const bool act = (int)threadIdx.x < cnt;
  const int row = act ? (int)threadIdx.x : 0;
  T ys[SA], ysc[SA], cs[SA], rf[RA], rb[RA], kr[RA], a[8];
  int fat[4] = {0, 0, 0, 0};

  // each source's rows [p0, p0 + cnt) into shared memory, row stride
  // width | 1, and where this thread's fields sit there; the omega
  // staging rows after them
  int off = 0;
#pragma unroll
  for (int i = 0; i < SU2K_CHEM_SRCS; ++i) {
    if (i < rw.nsrc) {
      const int w = rw.width[i], ws = w | 1;
      const T* src = rw.src[i] + (size_t)p0 * rw.stride[i];
      for (int e = threadIdx.x; e < cnt * w; e += blockDim.x) {
        const int r = e / w, c = e - r * w;
        sm[off + r * ws + c] = src[(size_t)r * rw.stride[i] + c];
      }
#pragma unroll
      for (int f = 0; f < 4; ++f)
        if (rw.fsrc[f] == i) fat[f] = off + row * ws + rw.fcol[f];
      off += (int)blockDim.x * ws;
    }
  }
  T* ost = sm + off;
  const int wo = ns | 1;
  __syncthreads();
  const T t = sm[fat[0]];
  const T rho = sm[fat[1]];
  const T* yrow = sm + fat[2];
  const bool pasr = rw.fsrc[3] >= 0;
  const T omt = pasr ? sm[fat[3]] : (T)0;

  for_n<S>(ns, [&](int s) {
    ys[s] = yrow[s];
    ysc[s] = clip_y(ys[s]);
    cs[s] = (T)1.0e3 * rho * clip_y(ysc[s]) / cc.mm[s];
  });
  Bin<T> bn = spline_bin(g, t);
  for_n<R>(nr, [&](int r) {
#pragma unroll
    for (int c = 0; c < 8; ++c) a[c] = cc.arr[r][c];
    T kf = a[0] * pow(t, a[1]) * exp(-a[2] / t);
    // the backward rate: the explicit Arrhenius one, else kf / Kc where
    // the reaction is reversible and Kp <= 1e10, else 0; only the branch
    // the reaction's flags select is evaluated (the same for every node)
    T kb = (T)0;
    if (a[7] > (T)0.5) {
      kb = a[3] * pow(t, a[4]) * exp(-a[5] / t);
    } else if (a[6] > (T)0.5) {
      T lnkc = spline_at(g, bn, tab + (size_t)r * g.nt,
                         tab + (size_t)(nr + r) * g.nt);
      T lnkp = spline_at(g, bn, tab + (size_t)(2 * nr + r) * g.nt,
                         tab + (size_t)(3 * nr + r) * g.nt);
      T kc_g = exp(lnkc), kp = exp(lnkp);
      kb = kp <= (T)1.0e10 ? kf / kc_g : (T)0;
    }
    // concentration products with the negative-exponent guard (:880-916)
    T pf = (T)1, pb = (T)1;
    bool gf = false, gb = false;
    for_n<S>(ns, [&](int s) {
      T ef = cc.ef[r][s], eb = cc.eb[r][s];
      if (ef != (T)0) pf *= pow(cs[s], ef);
      if (eb != (T)0) pb *= pow(cs[s], eb);
      gf |= (ef < (T)0) && (ysc[s] < (T)1.0e-15);
      gb |= (eb < (T)0) && (ysc[s] < (T)1.0e-15);
    });
    rf[r] = kf * (gf ? (T)0 : pf);
    rb[r] = kb * (gb ? (T)0 : pb);
  });
  for_n<R>(nr, [&](int r) {
    kr[r] = (T)1;
    if (pasr) {
      T highest = (T)0;
      // species outside reaction r add |dFr M| * 0 to a max from 0: none
      // is evaluated
      for_n<S>(ns, [&](int j) {
        if ((cc.part[j] >> r) & 1) {
          T d = (T)0;
          if (ys[j] > (T)1.0e-10)
            d = (rf[r] * cc.ef[r][j] - rb[r] * cc.eb[r][j]) / (rho * ys[j]);
          T m = fabs(d * cc.mm[j]);
          highest = m > highest ? m : highest;
        }
      });
      T tau_mix = (T)1 / (cc.c_mu * omt);
      T k = (T)1 / ((T)1 + tau_mix * highest);
      kr[r] = highest <= (T)0 ? (T)1 : (k > cc.pasr_lb ? k : cc.pasr_lb);
    }
  });
  T* orow = ost + row * wo;
  for_n<S>(ns, [&](int s) {
    T acc = (T)0;
    for_n<R>(nr, [&](int r) {
      T om = (T)1.0e-3 * cc.mm[s] * cc.dco[s][r] * (rf[r] - rb[r]);
      acc += om * kr[r];
    });
    if (act) orow[s] = acc;
  });
  __syncthreads();
  T* dst = out + (size_t)p0 * ns;
  for (int e = threadIdx.x; e < cnt * ns; e += blockDim.x) {
    const int r = e / ns;
    dst[e] = ost[r * wo + (e - r * ns)];
  }
}

// the constants of the host buffer cst (kernels._chem_tables' layout:
// mm[S] | arr[R][8] | exp_f[R][S] | exp_b[R][S] | dco[S][R] | part[S][R])
template <typename T, int MS, int MR>
ChemConst<T, MS, MR> chem_consts(int ns, int nr, const double* cst,
                                 double c_mu, double pasr_lb) {
  ChemConst<T, MS, MR> cc{};
  const double* arr = cst + ns;
  const double* ef = arr + 8 * nr;
  const double* eb = ef + nr * ns;
  const double* dco = eb + nr * ns;
  const double* part = dco + ns * nr;
  for (int s = 0; s < ns; ++s) {
    cc.mm[s] = (T)cst[s];
    for (int r = 0; r < nr; ++r) {
      cc.ef[r][s] = (T)ef[r * ns + s];
      cc.eb[r][s] = (T)eb[r * ns + s];
      cc.dco[s][r] = (T)dco[s * nr + r];
      if (part[s * nr + r] != 0.0) cc.part[s] |= (unsigned char)(1u << r);
    }
  }
  for (int r = 0; r < nr; ++r)
    for (int c = 0; c < 8; ++c) cc.arr[r][c] = (T)arr[8 * r + c];
  cc.c_mu = (T)c_mu;
  cc.pasr_lb = (T)pasr_lb;
  return cc;
}

template <typename T, int S, int R>
int launch_chem_source(int n, int ns, int nr, const Grid<T>& g,
                       const ChemRows<T>& rw, const void* tab,
                       const double* cst, double c_mu, double pasr_lb,
                       void* out, cudaStream_t st) {
  constexpr int MS = S > 0 ? S : SU2K_MAXS;
  constexpr int MR = R > 0 ? R : SU2K_MAXR;
  const size_t smem = chem_smem(rw, ns);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        (const void*)chem_source_kernel<T, S, R>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (n + SU2K_CHEM_THREADS - 1) / SU2K_CHEM_THREADS;
  chem_source_kernel<T, S, R><<<blocks, SU2K_CHEM_THREADS, smem, st>>>(
      n, ns, nr, g, rw, (const T*)tab,
      chem_consts<T, MS, MR>(ns, nr, cst, c_mu, pasr_lb), (T*)out);
  return (int)cudaGetLastError();
}

template <typename T>
int chem_source_by_sr(int n, int ns, int nr, int nt, double t0, double dt,
                      const ChemRows<T>& rw, const void* tab,
                      const double* cst, double c_mu, double pasr_lb,
                      void* out, cudaStream_t st) {
  Grid<T> g{(T)t0, (T)dt, (T)(t0 + (nt - 1) * dt), (T)(dt * dt), nt};
#define SU2K_CHEM_CASE(S_, R_)                                              \
  if (ns == S_ && nr == R_)                                                 \
    return launch_chem_source<T, S_, R_>(n, ns, nr, g, rw, tab, cst, c_mu,  \
                                         pasr_lb, out, st);
  SU2K_CHEM_BY_SR(SU2K_CHEM_CASE)
#undef SU2K_CHEM_CASE
  return launch_chem_source<T, 0, 0>(n, ns, nr, g, rw, tab, cst, c_mu,
                                     pasr_lb, out, st);
}

}  // namespace su2k

// the inputs: nsrc row sources (src, stride in elements, width staged) and
// for T, rho, Y and omega_t the source and column (fsrc[3] < 0: no PaSR);
// cst: the constants on the host (kernels._chem_tables' layout)
extern "C" int su2k_chem_source(int is_f64, int n, int ns, int nr, int nt,
                                double t0, double dt, int nsrc,
                                const void* const* src,
                                const long long* stride, const int* width,
                                const int* fsrc, const int* fcol,
                                const void* tab, const double* cst,
                                double c_mu, double pasr_lb, void* out,
                                void* stream) {
  if (ns < 1 || ns > SU2K_MAXS || nr < 1 || nr > SU2K_MAXR || nsrc < 1
      || nsrc > SU2K_CHEM_SRCS)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < nsrc; ++i)
    if (width[i] < 1 || stride[i] < 1) return (int)cudaErrorInvalidValue;
  for (int f = 0; f < 4; ++f) {
    const int w = f == 2 ? ns : 1;
    if (f == 3 && fsrc[f] < 0) continue;
    if (fsrc[f] < 0 || fsrc[f] >= nsrc || fcol[f] < 0
        || fcol[f] + w > width[fsrc[f]])
      return (int)cudaErrorInvalidValue;
  }
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (is_f64) {
    su2k::ChemRows<double> rw{};
    for (int i = 0; i < nsrc; ++i) {
      rw.src[i] = (const double*)src[i];
      rw.stride[i] = stride[i];
      rw.width[i] = width[i];
    }
    for (int f = 0; f < 4; ++f) {
      rw.fsrc[f] = fsrc[f];
      rw.fcol[f] = fcol[f];
    }
    rw.nsrc = nsrc;
    return su2k::chem_source_by_sr<double>(n, ns, nr, nt, t0, dt, rw, tab,
                                           cst, c_mu, pasr_lb, out, st);
  }
  su2k::ChemRows<float> rw{};
  for (int i = 0; i < nsrc; ++i) {
    rw.src[i] = (const float*)src[i];
    rw.stride[i] = stride[i];
    rw.width[i] = width[i];
  }
  for (int f = 0; f < 4; ++f) {
    rw.fsrc[f] = fsrc[f];
    rw.fcol[f] = fcol[f];
  }
  rw.nsrc = nsrc;
  return su2k::chem_source_by_sr<float>(n, ns, nr, nt, t0, dt, rw, tab, cst,
                                        c_mu, pasr_lb, out, st);
}

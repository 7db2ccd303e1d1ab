// K12: the fused SST system assembly on a static-stencil mesh.  For every
// node p and every stencil offset o_k (neighbour j = p + o_k, wrapped mod n)
// the convective upwind terms (CUpwSca_TurbSST), the corrected viscous
// terms (CAvgGradCorrected_TurbSST) and the off-diagonal 2 x 2 block of the
// SST system; then the source terms (CSourcePieceWise_TurbSST), the strong
// wall rows and the Vol/(CFL_red dt) diagonal.  Outputs in the lane layout
// the stencil solve consumes: res (2, n), dd = (d00, d11) (2, n) and sel
// (4K, n), rows [off0, 0, 0, off1] per offset.  The arithmetic and its
// groupings are those of turbulence/sst_assemble.py assemble_plain (the
// reference body su2_tpu/pallas/sst_assemble.py:51 _assemble_body); built
// with -fmad=false, so it rounds where the plain version rounds.
//
// Replaces su2_tpu/pallas/sst_assemble.py:168 _assemble_call (one
// full-field launch over stacked (14 + 4d, npad) node rows) and :235
// _assemble_tiled_call (the same body over overlapping lane windows past
// the VMEM gate).  The stacking, the 128-lane padding and the windows are
// TPU devices: here every field is read where it lies, through its
// strides (rho and the velocity are columns of the primitive rows, the
// (k, omega) gradients a slice of the gradient set, node-major or, from
// the >= 200k-node tier's gradient rows, feature-major), and one launch
// covers any n.
//
// Rows whose neighbour is missing have zero snormal and pvec, which
// annihilates the wrapped neighbour's terms, as the reference's full-field
// roll does; rho and omega are guarded (<= 0 -> 1, 0 -> 1) as there, so no
// wrapped value brings a 0/0 into a real row.
//
// Bound on the H100: bytes.  Per node it reads 21 field values and the
// wall flag, K (d + 1) geometry values, and writes 4 + 4K values (54 rows
// of n in f32 at d = 2, K = 4) against ~90 operations per offset, far
// below the card's ~20 FLOP per byte.  Design: one thread per node, so a
// warp reads each field at p and at p + o_k (the neighbours' values from
// L1/L2) in a few cache lines, node-major or feature-major, and its stores
// of every output row coalesce; the K-offset sums stay in registers; no
// shared memory.
#include "common.cuh"

#define SU2K_SST_MAXK 16
#define SU2K_SST_NF 15

namespace su2k {

// the per-node fields, in the order of the pointer and stride arrays
enum SstField {
  F_Q, F_RHO, F_VEL, F_GQ, F_MU, F_MUT, F_DIST, F_STRAIN, F_DIVERG, F_VOL,
  F_DT, F_F1, F_F2, F_CDKW, F_COORD
};

template <typename T>
struct SstArgs {
  const T* f[SU2K_SST_NF];
  long long s[SU2K_SST_NF][3];     // element strides: node, then inner
  const unsigned char* wall;       // (n,) bool
  const T* sn;                     // (K, n, d) stencil face normals
  const T* pv;                     // (K, n) edge projection factors
  int off[SU2K_SST_MAXK];
  // sigma_k1, sigma_k2, sigma_om1, sigma_om2, beta_1, beta_2, beta_star,
  // a1, alfa_1, alfa_2, CFL_red as T; 2/3 and 20 beta_star formed in
  // double, then rounded, as the plain version's Python constants are
  T sk1, sk2, so1, so2, b1, b2, bstar, a1c, al1, al2, cfl_red, c23, c20b;
};

// value (i, j) of node p of field f
template <typename T>
__device__ __forceinline__ T fld(const SstArgs<T>& a, int f, int p,
                                 int i = 0, int j = 0) {
  return a.f[f][(long long)p * a.s[f][0] + i * a.s[f][1] + j * a.s[f][2]];
}

// the node values the sweep reads at p and at each neighbour
template <typename T, int ND>
struct SstNode {
  T qk, qw, rho, rhoq0, rhoq1, diff_k, diff_w;
  T vel[ND], gk[ND], gw[ND], x[ND];
};

template <typename T, int ND>
__device__ __forceinline__ SstNode<T, ND> sst_node(const SstArgs<T>& a,
                                                   int p) {
  SstNode<T, ND> v;
  v.qk = fld(a, F_Q, p, 0);
  const T qw = fld(a, F_Q, p, 1);
  const T rho = fld(a, F_RHO, p);
  v.qw = qw != (T)0 ? qw : (T)1;
  v.rho = rho > (T)0 ? rho : (T)1;
  const T f1 = fld(a, F_F1, p);
  const T mu = fld(a, F_MU, p);
  const T mut = fld(a, F_MUT, p);
  const T sigk = f1 * a.sk1 + ((T)1 - f1) * a.sk2;
  const T sigw = f1 * a.so1 + ((T)1 - f1) * a.so2;
  v.diff_k = mu + sigk * mut;
  v.diff_w = mu + sigw * mut;
  v.rhoq0 = v.rho * v.qk;
  v.rhoq1 = v.rho * v.qw;
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    v.vel[d] = fld(a, F_VEL, p, d);
    v.gk[d] = fld(a, F_GQ, p, 0, d);
    v.gw[d] = fld(a, F_GQ, p, 1, d);
    v.x[d] = fld(a, F_COORD, p, d);
  }
  return v;
}

template <typename T, int ND>
__global__ void sst_assemble_kernel(int n, int kk, SstArgs<T> a,
                                    T* __restrict__ res, T* __restrict__ dd,
                                    T* __restrict__ sel) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const T half = (T)0.5;
  const SstNode<T, ND> me = sst_node<T, ND>(a, p);
  const bool wall = a.wall[p] != 0;
  T res0 = (T)0, res1 = (T)0, dg0 = (T)0, dg1 = (T)0;
#pragma unroll 1
  for (int k = 0; k < kk; ++k) {
    int j = p + a.off[k];
    j = j >= n ? j - n : (j < 0 ? j + n : j);
    const SstNode<T, ND> nb = sst_node<T, ND>(a, j);
    T ns[ND];
#pragma unroll
    for (int d = 0; d < ND; ++d) ns[d] = a.sn[((size_t)k * n + p) * ND + d];
    const T pv = a.pv[(size_t)k * n + p];
    T qt = (me.vel[0] + nb.vel[0]) * ns[0];
#pragma unroll
    for (int d = 1; d < ND; ++d) qt = qt + (me.vel[d] + nb.vel[d]) * ns[d];
    qt = half * qt;
    const T a0p = half * (qt + fabs(qt));
    const T a1p = half * (qt - fabs(qt));
    const T dm0 = half * (me.diff_k + nb.diff_k);
    const T dm1 = half * (me.diff_w + nb.diff_w);
    T ge0 = (T)0, ge1 = (T)0, gn0 = (T)0, gn1 = (T)0;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      const T gmk = half * (me.gk[d] + nb.gk[d]);
      const T gmw = half * (me.gw[d] + nb.gw[d]);
      const T ev = nb.x[d] - me.x[d];
      ge0 = d == 0 ? gmk * ev : ge0 + gmk * ev;
      ge1 = d == 0 ? gmw * ev : ge1 + gmw * ev;
      gn0 = d == 0 ? gmk * ns[d] : gn0 + gmk * ns[d];
      gn1 = d == 0 ? gmw * ns[d] : gn1 + gmw * ns[d];
    }
    const T corr0 = pv * ((nb.qk - me.qk) - ge0);
    const T corr1 = pv * ((nb.qw - me.qw) - ge1);
    res0 = res0 + ((a0p * me.rhoq0 + a1p * nb.rhoq0) - dm0 * (gn0 + corr0));
    res1 = res1 + ((a0p * me.rhoq1 + a1p * nb.rhoq1) - dm1 * (gn1 + corr1));
    const T pv_rho = pv / me.rho;
    dg0 = dg0 + (a0p + dm0 * pv_rho);
    dg1 = dg1 + (a0p + dm1 * pv_rho);
    const T pv_rro = pv / nb.rho;
    const T off0 = a1p - dm0 * pv_rro;
    const T off1 = a1p - dm1 * pv_rro;
    T* s = sel + (size_t)k * 4 * n + p;
    s[0] = wall ? (T)0 : off0;
    s[n] = (T)0;
    s[2 * (size_t)n] = (T)0;
    s[3 * (size_t)n] = wall ? (T)0 : off1;
  }

  // source (CSourcePieceWise_TurbSST)
  const T f1 = fld(a, F_F1, p), f2 = fld(a, F_F2, p);
  const T cdkw = fld(a, F_CDKW, p), mut = fld(a, F_MUT, p);
  const T strain = fld(a, F_STRAIN, p), diverg = fld(a, F_DIVERG, p);
  const T vol = fld(a, F_VOL, p), dt = fld(a, F_DT, p);
  const T dist = fld(a, F_DIST, p);
  const T rho = me.rho, qk = me.qk, qw = me.qw;
  const T alfa_b = f1 * a.al1 + ((T)1 - f1) * a.al2;
  const T beta_b = f1 * a.b1 + ((T)1 - f1) * a.b2;
  T pk = mut * strain * strain - a.c23 * rho * qk * diverg;
  const T pk_hi = a.c20b * rho * qw * qk;
  pk = pk > (T)0 ? pk : (T)0;
  pk = pk < pk_hi ? pk : pk_hi;
  const T sf = strain * f2 / a.a1c;
  const T zeta = qw > sf ? qw : sf;
  T pw = strain * strain - a.c23 * zeta * diverg;
  pw = pw > (T)0 ? pw : (T)0;
  const bool active = dist > (T)1e-10;
  const T src_k = active ? pk - a.bstar * rho * qw * qk : (T)0;
  const T src_w = active ? alfa_b * rho * pw - beta_b * rho * qw * qw
                               + ((T)1 - f1) * cdkw
                         : (T)0;
  res0 = res0 - src_k * vol;
  res1 = res1 - src_w * vol;
  T d00 = dg0 + (active ? a.bstar * qw * vol : (T)0);
  T d11 = dg1 + (active ? (T)2 * beta_b * qw * vol : (T)0);

  // strong wall rows, then the Vol/dt diagonal
  if (wall) {
    res0 = (T)0;
    res1 = (T)0;
    d00 = (T)1;
    d11 = (T)1;
  }
  const bool ok = dt > (T)1e-16;
  const T delta = ok ? vol / (a.cfl_red * dt) : (T)0;
  res[p] = res0;
  res[n + p] = res1;
  dd[p] = d00 + delta;
  dd[n + p] = d11 + delta;
}

template <typename T>
int launch_sst_assemble(int n, int nd, int kk, const int* offsets,
                        const double* c, const void* const* fields,
                        const long long* strides, const void* wall,
                        const void* sn, const void* pv, void* res, void* dd,
                        void* sel, void* stream) {
  SstArgs<T> a;
  for (int f = 0; f < SU2K_SST_NF; ++f) {
    a.f[f] = (const T*)fields[f];
    for (int r = 0; r < 3; ++r) a.s[f][r] = strides[3 * f + r];
  }
  a.wall = (const unsigned char*)wall;
  a.sn = (const T*)sn;
  a.pv = (const T*)pv;
  for (int k = 0; k < SU2K_SST_MAXK; ++k) a.off[k] = k < kk ? offsets[k] : 0;
  a.sk1 = (T)c[0];
  a.sk2 = (T)c[1];
  a.so1 = (T)c[2];
  a.so2 = (T)c[3];
  a.b1 = (T)c[4];
  a.b2 = (T)c[5];
  a.bstar = (T)c[6];
  a.a1c = (T)c[7];
  a.al1 = (T)c[8];
  a.al2 = (T)c[9];
  a.cfl_red = (T)c[10];
  a.c23 = (T)(2.0 / 3.0);
  a.c20b = (T)(20.0 * c[6]);
  if (n > 0) {
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    cudaStream_t st = (cudaStream_t)stream;
    if (nd == 2)
      sst_assemble_kernel<T, 2><<<blocks, threads, 0, st>>>(
          n, kk, a, (T*)res, (T*)dd, (T*)sel);
    else
      sst_assemble_kernel<T, 3><<<blocks, threads, 0, st>>>(
          n, kk, a, (T*)res, (T*)dd, (T*)sel);
  }
  return (int)cudaGetLastError();
}

}  // namespace su2k

extern "C" int su2k_sst_assemble(int is_f64, int n, int nd, int kk,
                                 const int* offsets, const double* consts,
                                 const void* const* fields,
                                 const long long* strides, const void* wall,
                                 const void* sn, const void* pv, void* res,
                                 void* dd, void* sel, void* stream) {
  if (nd < 2 || nd > SU2K_MAXD || kk < 1 || kk > SU2K_SST_MAXK)
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < kk; ++k)
    if (offsets[k] <= -n || offsets[k] >= n) return (int)cudaErrorInvalidValue;
  if (is_f64)
    return su2k::launch_sst_assemble<double>(n, nd, kk, offsets, consts,
                                             fields, strides, wall, sn, pv,
                                             res, dd, sel, stream);
  return su2k::launch_sst_assemble<float>(n, nd, kk, offsets, consts, fields,
                                          strides, wall, sn, pv, res, dd, sel,
                                          stream);
}

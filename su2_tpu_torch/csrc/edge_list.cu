// K13: explicit interior edge terms of the reactive RANS residual over an
// edge list, for meshes without a static stencil, summed per node.  Per
// edge e = (i, j): AUSM+-up convective flux, viscous flux with
// Stefan-Maxwell diffusion and the SST closure, species h/cp at the
// face-mean temperature, and the convective and viscous spectral radii, by
// edge_side (csrc/edge_side.cuh), the device function kernels T3 and K8 run
// on the family slots.  Then, per node p, the sums over p's incident edges
// in slot order (MeshArrays.scatter_edges_mixed).
//
// Replaces su2_tpu/pallas/edge_fused.py:494 fused_edge_flux_pallas (via
// fused_interior_terms :561, the edge-list branch :677-686).  The TPU path
// gathers the (48, E) endpoint stacks f_all[:, i] and f_all[:, j] in XLA
// and streams them through the kernel in 128-lane tiles, then sums per
// node in XLA (a gather and a slot sum).  Two launches from two C calls:
//
// edge_list_kernel, the edge pass: one thread per edge, 128 edges a block.
// The block reads its edges' 256 endpoint rows of the node-major stack
// F (n, R) (contiguous runs of R values: 192 bytes at (2, 9) in f32),
// coalesced and in the widest vector that divides a row (16 bytes where
// R x sizeof(T) allows it, else 8 or 4), into a feature-major tile
// (R, 257) in shared memory, and calls edge_side unchanged with the tile
// as its stack; coords[j] - coords[i] is formed here (the one subtraction
// su2_tpu does outside its kernel).  The edge's nVar + 2 outputs go back
// through shared memory as one contiguous edge-major row of rows (E,
// nVar + 2).  The stack is never transposed and the endpoint columns never
// gathered into a copy.  The body's ~250 registers allow two blocks an
// SM; f32 at the compiled shapes is built for SU2K_K13_CAP blocks an SM
// instead (168 registers, ~90 bytes spilled; three blocks' tiles fit an
// SM at every compiled shape): 23 % faster at 425,068 edges, 2 % slower
// at 26,743 (PERF.md).  f64 and the run-time instance stay uncapped.
//
// edge_list_sum_kernel, the node sums: one thread per (node p, column c),
// c fastest, so a node's threads read one contiguous edge row, 32
// registers, a full SM of threads (a thread loading eight slots' ids, then
// their rows, took 96 registers and 3x the time: PERF.md).  From slot 0
// on, in order: rows[e, c] times node_sign_t (c < nVar) or its absolute
// value (lc, lv), e = node_edges_t[d n + p], a pad slot (e = E, sign 0)
// reading zero, as _gather_slots / _slot_sum do.  A product by +-1 or 0
// is exact, so a fused multiply-add rounds as the plain add: bit for bit
// scatter_edges_mixed.  It replaces no Pallas kernel: su2_tpu sums in XLA
// (su2_tpu/pallas/edge_fused.py:684-686).
//
// Bound on the H100: the edge pass by its body.  Its bytes (the stack once
// per node, the edge list, normals and coordinates, the rows written:
// 64 MB at 142,317 nodes in f32, 0.019 ms at 3.35 TB/s) lie below the
// ~7,000 SASS instructions of edge_side per edge (8-12 warps an SM),
// ~0.09 ms at the card's peak instruction rate for 425,068 edges.  The
// node sums by bytes: the rows, node_edges_t, node_sign_t and the output,
// 48 MB at 142,317 nodes in f32, 0.014 ms.  The per-edge body runs at
// T3's compile-time (dimension, species count) shapes, or its run-time
// instance for every other shape (4-byte pieces of the rows there).
#include "edge_side.cuh"

#define SU2K_K13_EDGES 128   // edges (threads) a block of the edge pass
#define SU2K_K13_CAP 3       // blocks an SM of the f32 compiled shapes

namespace su2k {

// rows of the stack F at (ND, NS) (ops/edge_flux.stack_rows)
__host__ __device__ constexpr int edge_rows(int nd, int ns) {
  return ns + 2 * nd + 11 + (1 + nd + ns) * nd;
}

template <typename T, int BYTES> struct Piece { using type = T; };
template <> struct Piece<float, 8> { using type = float2; };
template <> struct Piece<float, 16> { using type = float4; };
template <> struct Piece<double, 16> { using type = double2; };

// bytes of the widest piece (<= 16) that divides a row of R values
template <typename T>
__host__ __device__ constexpr int piece_bytes(int r) {
  return (r * (int)sizeof(T)) % 16 == 0 ? 16
       : ((r * (int)sizeof(T)) % 8 == 0 ? 8 : (int)sizeof(T));
}

// the tile's width: both endpoint slots of each edge, plus one (odd)
constexpr int K13_W = 2 * SU2K_K13_EDGES + 1;
// row pieces a thread loads before it stores them to the tile
constexpr int K13_BATCH = 8;

template <typename T>
__host__ __device__ constexpr size_t edge_list_smem(int r) {
  return (size_t)r * K13_W * sizeof(T);
}

// MINB: the blocks an SM ptxas fits the registers to (1: up to 255 a
// thread, 2 blocks an SM at (2, 9); SU2K_K13_CAP: 168, spilling ~90
// bytes), k13_minb's by type and shape
template <typename T, int ND, int NS, int MINB>
__global__ void __launch_bounds__(SU2K_K13_EDGES, MINB)
edge_list_kernel(int ne, EdgeConsts c, Grid<T> g,
                 const T* __restrict__ f,
                 const long long* __restrict__ edges,
                 const T* __restrict__ normal,
                 const T* __restrict__ coords,
                 const T* __restrict__ tab, const T* __restrict__ cst,
                 T* __restrict__ rows) {
  constexpr int TE = SU2K_K13_EDGES;
  constexpr int MD = ND > 0 ? ND : SU2K_MAXD;
  constexpr int MV = ND > 0 ? NS + ND + 2 : SU2K_MAXV;
  // the row length and its pieces: compile-time at a compiled shape
  constexpr int RR = ND > 0 ? edge_rows(ND, NS) : 0;
  using V = typename Piece<T, (ND > 0 ? piece_bytes<T>(RR)
                                      : (int)sizeof(T))>::type;
  constexpr int PER = sizeof(V) / sizeof(T);
  const int nd = ND > 0 ? ND : c.nd;
  const int nv = ND > 0 ? NS + ND + 2 : c.ns + c.nd + 2;
  const int nr = ND > 0 ? RR : edge_rows(c.nd, c.ns);
  const int cw = nv + 2;                // an edge's outputs
  const int cs = cw | 1;                // their stride in the tile (odd)
  extern __shared__ __align__(16) unsigned char k13_smem[];
  T* tile = reinterpret_cast<T*>(k13_smem);   // (nr, K13_W)
  __shared__ int ends[2 * TE];                // slot s < TE: i, else j
  const int t = threadIdx.x;
  const size_t e0 = (size_t)blockIdx.x * TE;
  const int cnt = ne - (int)e0 < TE ? ne - (int)e0 : TE;
  if (t < cnt) {
    ends[t] = (int)edges[2 * (e0 + t)];
    ends[TE + t] = (int)edges[2 * (e0 + t) + 1];
  }
  __syncthreads();
  // the endpoint rows, piece q of slot s at k = s * pieces + q: a warp
  // reads whole rows, contiguous; K13_BATCH loads in flight a thread
  // before their values go to the tile
  const int pieces = nr / PER;
  for (int k0 = t; k0 < 2 * TE * pieces; k0 += K13_BATCH * TE) {
    V v[K13_BATCH];
    int at[K13_BATCH];
#pragma unroll
    for (int b = 0; b < K13_BATCH; ++b) {
      const int k = k0 + b * TE;
      const int s = k / pieces, q = k - s * pieces;
      at[b] = k < 2 * TE * pieces && (s < TE ? s : s - TE) < cnt
                  ? q * PER * K13_W + s : -1;
      if (at[b] >= 0)
        v[b] = reinterpret_cast<const V*>(f + (size_t)ends[s] * nr)[q];
    }
#pragma unroll
    for (int b = 0; b < K13_BATCH; ++b) {
      const T* pv = reinterpret_cast<const T*>(&v[b]);
      if (at[b] >= 0) {
#pragma unroll
        for (int u = 0; u < PER; ++u) tile[at[b] + u * K13_W] = pv[u];
      }
    }
  }
  __syncthreads();
  T fo[MV], lco = (T)0, lvo = (T)0;
  if (t < cnt) {
    const int i = ends[t], j = ends[TE + t];
    T nm[MD], ev[MD];
    for_n<ND>(nd, [&](int d) {
      nm[d] = normal[(e0 + t) * nd + d];
      ev[d] = coords[(size_t)j * nd + d] - coords[(size_t)i * nd + d];
    });
    edge_side<ND, NS>(K13_W, c, g, tile, t, TE + t, nm, ev, tab, cst, fo,
                      lco, lvo);
  }
  __syncthreads();                      // every thread is done with the tile
  if (t < cnt) {
    for_n<(ND > 0 ? NS + ND + 2 : 0)>(nv, [&](int r) {
      tile[t * cs + r] = fo[r];
    });
    tile[t * cs + nv] = lco;
    tile[t * cs + nv + 1] = lvo;
  }
  __syncthreads();
  T* out = rows + e0 * cw;
  for (int k = t; k < cnt * cw; k += TE) {
    const int s = k / cw;
    out[k] = tile[s * cs + (k - s * cw)];
  }
}

// the blocks an SM of the instance for T at a compiled shape
template <typename T> constexpr int k13_minb() {
  return sizeof(T) == 4 ? SU2K_K13_CAP : 1;
}

template <typename T>
int launch_edge_list(int ne, EdgeConsts c, int nt, double t0, double dt,
                     const void* f, const void* edges, const void* nrm,
                     const void* coords, const void* tab, const void* cst,
                     void* rows, void* stream) {
  Grid<T> g{(T)t0, (T)dt, (T)(t0 + (nt - 1) * dt), (T)(dt * dt), nt};
  const int blocks = (ne + SU2K_K13_EDGES - 1) / SU2K_K13_EDGES;
  const size_t smem = edge_list_smem<T>(edge_rows(c.nd, c.ns));
  cudaStream_t st = (cudaStream_t)stream;
  auto launch = [&](auto kern) {
    if (blocks == 0) return (int)cudaSuccess;
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    kern<<<blocks, SU2K_K13_EDGES, smem, st>>>(
        ne, c, g, (const T*)f, (const long long*)edges, (const T*)nrm,
        (const T*)coords, (const T*)tab, (const T*)cst, (T*)rows);
    return (int)cudaGetLastError();
  };
#define SU2K_K13_CASE(ND_, NS_)                                             \
  if (c.nd == ND_ && c.ns == NS_)                                           \
    return launch(edge_list_kernel<T, ND_, NS_, k13_minb<T>()>);
  if (!edge_shape_ok(c.nd, c.ns)) return (int)cudaErrorInvalidValue;
  SU2K_EDGE_BY_SHAPE(SU2K_K13_CASE)
#undef SU2K_K13_CASE
  // every other shape: the run-time instance
  return launch(edge_list_kernel<T, 0, 0, 1>);
}

// out (n, nvar + 2): column c < nvar sum_d sign[d, p] rows[e_d, c], columns
// nvar and nvar + 1 sum_d |sign[d, p]| rows[e_d, c], e_d = slots[d n + p],
// slot 0 first; e_d = ne (a pad slot) reads zero
template <typename T>
__global__ void edge_list_sum_kernel(int n, int ne, int nvar, int deg,
                                     const T* __restrict__ rows,
                                     const long long* __restrict__ slots,
                                     const T* __restrict__ sign,
                                     T* __restrict__ out) {
  const int cw = nvar + 2;
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= (long long)n * cw) return;
  const int p = (int)(k / cw), col = (int)(k - (long long)p * cw);
  auto term = [&](int d) {
    const long long e = slots[(size_t)d * n + p];
    const T s = sign[(size_t)d * n + p];
    const T x = e < ne ? rows[(size_t)e * cw + col] : (T)0;
    return x * (col < nvar ? s : fabs(s));
  };
  T acc = term(0);
  for (int d = 1; d < deg; ++d) acc = acc + term(d);
  out[k] = acc;
}

}  // namespace su2k

// f: the node-major stack (n, R), 16-byte aligned; rows (ne, nVar + 2):
// per edge its flux, lc and lv
extern "C" int su2k_edge_list(int is_f64, int n, int ne, int nd, int ns,
                              int nt, double t0, double dt,
                              double m_infty,
                              double pr_lam, double pr_turb, double le_turb,
                              double mm_sum, const void* f, const void* edges,
                              const void* nrm, const void* coords,
                              const void* tab, const void* cst, void* rows,
                              void* stream) {
  if (n < 1 || ne < 0 || (uintptr_t)f % 16 != 0)
    return (int)cudaErrorInvalidValue;
  su2k::EdgeConsts c{m_infty, pr_lam, pr_turb, le_turb, mm_sum,
                     nd, ns, 0, {0}};
  if (is_f64)
    return su2k::launch_edge_list<double>(ne, c, nt, t0, dt, f, edges, nrm,
                                          coords, tab, cst, rows, stream);
  return su2k::launch_edge_list<float>(ne, c, nt, t0, dt, f, edges, nrm,
                                       coords, tab, cst, rows, stream);
}

// rows (ne, nvar + 2) -> out (n, nvar + 2); slots, sign (deg n,) slot-major
extern "C" int su2k_edge_list_sum(int is_f64, int n, int ne, int nvar,
                                  int deg, const void* rows,
                                  const void* slots, const void* sign,
                                  void* out, void* stream) {
  if (n < 1 || ne < 0 || nvar < 1 || deg < 1)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)n * (nvar + 2);
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t st = (cudaStream_t)stream;
  if (is_f64)
    su2k::edge_list_sum_kernel<double><<<blocks, threads, 0, st>>>(
        n, ne, nvar, deg, (const double*)rows, (const long long*)slots,
        (const double*)sign, (double*)out);
  else
    su2k::edge_list_sum_kernel<float><<<blocks, threads, 0, st>>>(
        n, ne, nvar, deg, (const float*)rows, (const long long*)slots,
        (const float*)sign, (float*)out);
  return (int)cudaGetLastError();
}

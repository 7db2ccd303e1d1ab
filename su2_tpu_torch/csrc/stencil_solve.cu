// K5 stencil_sgs_matvec and K6 stencil_fgmres: the symmetric multicolor
// block Gauss-Seidel sweep (the reference's LU-SGS made color-parallel),
// the stencil matvec, and one right-preconditioned FGMRES(m) cycle, on
// meshes whose neighbours sit at K fixed index offsets.
//
// Replaces su2_tpu/pallas/stencil_solve.py.  K5: _sgs_matvec_call :178,
// _sgs_matvec_mixed_call :206, _sgs_call :251, _matvec_call :273 and the
// windowed _tiled_sgs_matvec_call :554, _tiled_sgs_matvec_mixed_call :643,
// _tiled_sgs_call :741 (the windows fit the TPU's VMEM; a grid-stride
// kernel reads any field size from device memory).  K6: the one-launch
// cycles _fgmres_call :381 and _fgmres_mixed_call :434.
//
// Layout: blocks lane-major, row q of an (R, n) array at q*n + p (rows
// k*V*V + a*V + b of the off-diagonal blocks, a*V + b of dinv/diag), or
// for K5's color-major sweep operands at q*n + i, lane i holding node
// order[i]; vectors node-major, entry a of node p at p*V + a.  Colors: one
// int8 per node.  A neighbour p + o_k outside [0, n) is skipped: its
// block is zero by construction, where the reference multiplies a wrapped
// lane by it.
//
// Sweep semantics (the reference's _sgs_body): z starts at 0; passes run
// over the colors 0..nc-1, then nc-2..0; a pass sets
//   z_new[p] = dinv[p] (r[p] - sum_k B_k[p] z_old[p + o_k])
// at the nodes of its color and z_new[p] = z_old[p] elsewhere.  Every pass
// reads the z of the previous pass (two buffers), so masks that are not a
// proper coloring give the reference's numbers as well, with no race.
// The mixed tier stores the sweep blocks as __nv_bfloat16 (rounded to
// nearest even once per solve by the caller) and widens each with
// __bfloat162float; the matvec blocks stay at the state type.
//
// Bound on the H100: bytes.  A sweep pass reads its nodes' K*V*V blocks,
// dinv and r, and the neighbours' z; the matvec reads the K*V*V matvec
// blocks and diag.  At V = 13 the flow's mixed K5 at 142,317 nodes has to
// move ~792 MB (bf16 sweep blocks 192 MB, f32 matvec blocks 385 MB, dinv
// and diag 96 MB each, the vectors 22 MB), 0.24 ms at 3.35 TB/s; at
// 565,500 nodes four times that.  The field does not fit the 50 MB L2, so
// each of the 2nc - 1 sweep passes reads its blocks from HBM again.
//
// Design K5: one launch per pass issued from one C call (the launches are the
// barriers between passes), then the matvec.  A pass runs over the lanes of
// the color-major node list order (the nodes sorted by color,
// stencil_solve.color_order), so the nodes of its color are a contiguous run
// of lanes; the other lanes copy z_old (the two-buffer rule: masks that are
// not a proper coloring give the reference's numbers too, with no race).  At
// V >= 4 every 32 lanes are V warps, warp a forming row a of the 32
// nodes' block products: each block-row load is one coalesced read, a thread
// holds no V-vector and has ~K V independent loads in flight, and the
// node-major vectors are staged through shared memory (the former design ran
// one thread per node, which read 4 K V^2 block values and the vectors at a
// stride of V itself and moved ~1.6 TB/s).  At V = 2 and 3 a thread per lane
// stays faster (the passes are short and latency-bound).  In the mixed tier
// the bf16 sweep blocks and dinv are held in that color-major lane layout
// (made once per solve with the bf16 copy, stencil_solve.to_color_major), so
// a pass reads the contiguous block rows of its own color only: at nc = 2
// half of the field's sweep bytes per pass, where the lane-interleaved colors
// of the former design put both colors in every 32-byte sector and each pass
// moved the whole field.  At full precision the sweep reads the matvec's
// blocks in the natural layout through the node list (no second copy of the
// field).  The matvec, with the same thread layout, reads the full-precision
// blocks in the natural layout, one pass.
//
// Widths: V = 2 (the SST system), 3, and 7, 8, 13, 14 (the flow's nDim +
// nSpecies + 2 of the 3-species flat plate and the 9-species channel, in
// 2D and 3D), one template instance each; every other width from 4 to
// SU2K_VMAX = 21 (the flow's nDim + nSpecies + 2 up to 3D and 16 species)
// runs the run-time kernels (the section "run-time widths" below: width
// classes, rows staged asynchronously in shared memory, K6's sweep rows
// resident), its width a kernel argument; another width is refused.
// Every per-node V-vector (r, z, the products) of K6's cluster form
// (V <= 3) is a register array indexed only by unrolled loops, so it
// stays out of local memory; the V x V blocks are streamed, never held.
// The warp-per-row kernels hold no V-vector: a thread forms one block row,
// its loop over b unrolled to V, summed over b, then the offsets in order
// at every width, as the run-time kernels sum too.
//
// K6: at m = 10, nc = 2 a cycle has 2 + m (2nc + 1) + m (m - 1)/2 = 97
// barriers across the whole launch (sweep passes, one fused
// matvec-and-first-dot pass, the j + 1 sequential modified Gram-Schmidt
// passes and the norm), while its operands at 9,072 nodes (~2.5 MB with
// the basis at V = 2; ~50 MB at V = 13 in the mixed tier, about the size
// of L2) sit in L2.  At V = 2 latency bounds it: the barriers and each
// phase's dependent loads (~2.5 us a phase on 36 cooperative blocks of 256
// threads at 9,072 nodes); at V = 13 the work of a phase did (~22 us a
// phase with a thread per node, each thread streaming its K V^2 block
// values one after the other).
// Design K6 at V >= 4 (fgmres_rows_kernel at the compiled widths,
// fgmres_rt_kernel at the others, below): one cooperative grid of
// co-resident blocks (cudaLaunchCooperativeKernel), cg::this_grid().sync()
// as the barrier, K5's warp per block row over the color-major node list,
// the grid as many blocks as fit on every SM at once (one per 32-node
// group at most); a reduction writes block partials to device memory and
// every block sums them in the same order.
// Design K6 at V = 2 and 3: one thread-block cluster (cudaLaunchKernelEx
// with a cluster dimension) of C CTAs of 1024 threads: C = 16 where
// cudaOccupancyMaxActiveClusters says such a cluster fits on the card, else
// the portable 8 (or the size the caller names).  Every barrier is
// cg::this_cluster().sync() (barrier.cluster arrive.release /
// wait.acquire) over C SMs, ~0.75 us on the H100 against ~1.1 us for the
// cooperative grid's grid.sync(); the reductions (cluster_reduce) take
// each CTA's partial from its shared memory over distributed shared
// memory in rank order.  A thread per node, the same nodes in every
// phase.  Where every node has a thread (n <= C * 1024: the one-launch
// tier's 12,288 nodes at C = 16) and the basis fits in shared memory (the
// resident form of fgmres_cluster_kernel), each thread keeps its node's
// Krylov basis in its CTA's shared memory and w in registers, so only z
// goes through device memory; else the basis stays in device memory as in
// the rows kernel.  The sweep and matvec start the K neighbour loads at
// once (gather_nb).  A cluster needs no grid-wide co-residency, and its
// launch can be captured in a CUDA graph.  Measured at 9,072 nodes
// (PERF.md §6), a phase costs ~2.2 us: the barrier, the dependent
// loads of the sweep and matvec, and each reduction's two block barriers
// and shuffles.
// Every reduction is deterministic (each block sums the same partials in
// the same order), so the scalar recurrence (pow2 scaling, Givens
// rotations, back-substitution) runs redundantly and identically in each
// block, with no extra barrier.  Values written by other threads inside
// the launch are read with __ldcg (L2: L1 is per SM).
#include "common.cuh"

#include <cooperative_groups.h>
#include <cuda_bf16.h>

namespace cg = cooperative_groups;

#define SU2K_MAXK 8       // stencil offsets (geometry/stencil.py MAX_OFFSETS)
#define SU2K_VMAX 21      // widest block of the run-time kernels
#define SU2K_FG_CLUSTER_THREADS 1024

namespace su2k {

struct Stencil {
  int k;
  int off[SU2K_MAXK];
};

template <typename T, typename S>
__device__ __forceinline__ T widen(S x) { return (T)x; }
template <>
__device__ __forceinline__ float widen<float, __nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float fab(float x) { return fabsf(x); }
__device__ __forceinline__ double fab(double x) { return fabs(x); }
__device__ __forceinline__ float sq(float x) { return sqrtf(x); }
__device__ __forceinline__ double sq(double x) { return sqrt(x); }
__device__ __forceinline__ float pow2_floor(float x) {
  float e = floorf(log2f(x));
  return exp2f(e < -120.f ? -120.f : (e > 120.f ? 120.f : e));
}
__device__ __forceinline__ double pow2_floor(double x) {
  double e = floor(log2(x));
  return exp2(e < -120.0 ? -120.0 : (e > 120.0 ? 120.0 : e));
}

// out = sum_k B_k[p] x[p + o_k], node p's blocks at lane `lane` of the
// (K*V*V, n) rows (p itself in the natural layout); the products of one
// block row are summed over b, then the offsets in order (the reference's
// _offdiag)
template <typename T, typename S, int V>
__device__ __forceinline__ void offdiag_at(const S* __restrict__ sel,
                                           const T* x, int n, int p,
                                           int lane, const Stencil& st,
                                           T (&out)[V]) {
#pragma unroll
  for (int a = 0; a < V; ++a) out[a] = (T)0;
  for (int kk = 0; kk < st.k; ++kk) {
    const int q = p + st.off[kk];
    if (q < 0 || q >= n) continue;
    T xq[V];
#pragma unroll
    for (int b = 0; b < V; ++b) xq[b] = x[(size_t)q * V + b];
    const S* blk = sel + (size_t)kk * V * V * n + lane;
#pragma unroll
    for (int a = 0; a < V; ++a) {
      T y = (T)0;
#pragma unroll
      for (int b = 0; b < V; ++b)
        y += widen<T, S>(blk[(size_t)(a * V + b) * n]) * xq[b];
      out[a] += y;
    }
  }
}

// out = blk[lane] x (one V x V block per node)
template <typename T, int V>
__device__ __forceinline__ void bapply_at(const T* __restrict__ blk, int n,
                                          int lane, const T (&x)[V],
                                          T (&out)[V]) {
#pragma unroll
  for (int a = 0; a < V; ++a) {
    T s = (T)0;
#pragma unroll
    for (int b = 0; b < V; ++b)
      s += blk[(size_t)(a * V + b) * n + lane] * x[b];
    out[a] = s;
  }
}

// w[p] = diag[p] z[p] + sum_k B_k[p] z[p + o_k]
template <typename T, int V>
__device__ __forceinline__ void matvec_at(const T* __restrict__ selm,
                                          const T* __restrict__ diag,
                                          const T* z, int n, int p,
                                          const Stencil& st, T (&w)[V]) {
  T zp[V], od[V];
#pragma unroll
  for (int a = 0; a < V; ++a) zp[a] = z[(size_t)p * V + a];
  offdiag_at<T, T, V>(selm, z, n, p, p, st, od);
  bapply_at<T, V>(diag, n, p, zp, w);
#pragma unroll
  for (int a = 0; a < V; ++a) w[a] += od[a];
}

// ------------------------------------------------------------------- K5
// Thread layout of K5's kernels: a group of 32 lanes (nodes) is handled by
// V warps, warp a forming row a of every block product of those 32 nodes
// (threadIdx.x = lane, threadIdx.y = row a, threadIdx.z = group), so each
// load of a block row is one coalesced read of 32 neighbouring lanes and a
// thread holds no V-vector.  The group's vectors (r and the neighbours' z,
// node-major) are staged through shared memory first, one element per
// thread (32 V elements of each vector for V x 32 threads), and the row
// results are exchanged there before the dinv product.
// groups per block at width v: as many as fit 512 threads (8 at V = 2, 1
// at V = 13); past 16 one group of 32 v threads (544 to 672)
__host__ __device__ constexpr int k5_groups(int v) {
  return v > 16 ? 1 : 512 / (32 * v);
}

// shared memory of a K5 block: per group K staged neighbour vectors, r
// (or z itself in the matvec) and the rows' results, each 32 x v; at most
// 40 KB at a compiled width (K = 8, double), under the 48 KB a launch gets
// unasked
template <typename T>
size_t k5_smem(int v, int k) {
  return (size_t)k5_groups(v) * (k + 2) * 32 * v * sizeof(T);
}

// One color pass over the color-major node list: lane i is node
// p = order[i], so the nodes of one color are a contiguous run of lanes.
// A lane of the pass's color sets z_new[p] = dinv (r - sum_k B_k z_old);
// its sweep blocks and dinv sit at lane i (cm: the color-major copy) or at
// lane p (the natural layout).  Any other lane copies z_old[p] (0 in the
// first pass), the two-buffer rule.  Row a's sums run in the order of the
// other kernels (offdiag_at, bapply_at).
template <typename T, typename S, int V>
__global__ void __launch_bounds__(512, 2)
sgs_pass_kernel(int n, Stencil st, int color, int first, int cm,
                const S* __restrict__ selp, const T* __restrict__ dinv,
                const int8_t* __restrict__ colors,
                const int* __restrict__ order, const T* __restrict__ r,
                const T* zold, T* znew) {
  extern __shared__ __align__(16) unsigned char k5_raw[];
  const int v = V;
  const int l = threadIdx.x, a = threadIdx.y, g = threadIdx.z;
  const int k = st.k;
  T* gx = reinterpret_cast<T*>(k5_raw) + (size_t)g * (k + 2) * 32 * v;
  T* gr = gx + (size_t)k * 32 * v;     // r of the group's nodes
  T* gacc = gr + 32 * v;               // r - sum_k B_k z_old, by row
  const int i0 = (blockIdx.x * k5_groups(v) + g) * 32;
  {
    // stage: element e = (node e / v, entry e % v) of each vector
    const int e = a * 32 + l, ls = e / v, b = e - ls * v;
    const int is = i0 + ls;
    if (is < n) {
      const int ps = order[is];
      if (colors[ps] == color) {
        gr[e] = r[(size_t)ps * v + b];
        for (int kk = 0; kk < k && !first; ++kk) {
          const int q = ps + st.off[kk];
          gx[kk * 32 * v + e] =
              q < 0 || q >= n ? (T)0 : zold[(size_t)q * v + b];
        }
      }
    }
  }
  __syncthreads();
  const int i = i0 + l;
  const int p = i < n ? order[i] : 0;
  const bool mine = i < n && colors[p] == color;
  const int lane = cm ? i : p;
  if (mine) {
    T acc = gr[l * v + a];
    if (!first) {
      T od = (T)0;
      for (int kk = 0; kk < k; ++kk) {
        const int q = p + st.off[kk];
        if (q < 0 || q >= n) continue;
        const S* blk = selp + ((size_t)kk * v * v + a * v) * n + lane;
        const T* x = gx + kk * 32 * v + l * v;
        T y = (T)0;
#pragma unroll
        for (int b = 0; b < V; ++b)
          y += widen<T, S>(blk[(size_t)b * n]) * x[b];
        od += y;
      }
      acc = acc - od;
    }
    gacc[l * v + a] = acc;
  }
  __syncthreads();
  if (i < n) {
    T zn;
    if (mine) {
      const T* dr = dinv + (size_t)a * v * n + lane;
      zn = (T)0;
#pragma unroll
      for (int b = 0; b < V; ++b)
        zn += dr[(size_t)b * n] * gacc[l * v + b];
    } else {
      zn = first ? (T)0 : zold[(size_t)p * v + a];
    }
    znew[(size_t)p * v + a] = zn;
  }
}

// w[p] = diag[p] z[p] + sum_k B_k[p] z[p + o_k], natural layout; the
// group's 32 nodes are consecutive, so each staged vector is one
// contiguous run of 32 v entries
template <typename T, int V>
__global__ void __launch_bounds__(512, 2)
matvec_kernel(int n, Stencil st, const T* __restrict__ selm,
              const T* __restrict__ diag, const T* __restrict__ x,
              T* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char k5_raw[];
  const int v = V;
  const int l = threadIdx.x, a = threadIdx.y, g = threadIdx.z;
  const int k = st.k;
  T* gx = reinterpret_cast<T*>(k5_raw) + (size_t)g * (k + 2) * 32 * v;
  T* gz = gx + (size_t)k * 32 * v;     // z of the group's own nodes
  const int p0 = (blockIdx.x * k5_groups(v) + g) * 32;
  {
    const int e = a * 32 + l;
    const int ps = p0 + e / v;
    if (ps < n) {
      gz[e] = x[(size_t)p0 * v + e];
      for (int kk = 0; kk < k; ++kk) {
        const int q = ps + st.off[kk];
        gx[kk * 32 * v + e] =
            q < 0 || q >= n ? (T)0 : x[(size_t)p0 * v + e
                                       + (ptrdiff_t)st.off[kk] * v];
      }
    }
  }
  __syncthreads();
  const int p = p0 + l;
  if (p >= n) return;
  T od = (T)0;
  for (int kk = 0; kk < k; ++kk) {
    const int q = p + st.off[kk];
    if (q < 0 || q >= n) continue;
    const T* blk = selm + ((size_t)kk * v * v + a * v) * n + p;
    const T* xq = gx + kk * 32 * v + l * v;
    T t = (T)0;
#pragma unroll
    for (int b = 0; b < V; ++b)
      t += blk[(size_t)b * n] * xq[b];
    od += t;
  }
  const T* dr = diag + (size_t)a * v * n + p;
  T w = (T)0;
#pragma unroll
  for (int b = 0; b < V; ++b)
    w += dr[(size_t)b * n] * gz[l * v + b];
  y[(size_t)p * v + a] = w + od;
}

// V <= 3: one thread per lane holds its node's V-vectors in registers (a
// node's block products are only 4 K V^2 <= 36 K values, and staging and
// barriers would lengthen the dependent load chain of these small,
// latency-bound passes); the same color-major lanes and two-buffer rule
template <typename T, typename S, int V>
__global__ void sgs_pass_lane_kernel(int n, Stencil st, int color, int first,
                                     int cm, const S* __restrict__ selp,
                                     const T* __restrict__ dinv,
                                     const int8_t* __restrict__ colors,
                                     const int* __restrict__ order,
                                     const T* __restrict__ r, const T* zold,
                                     T* znew) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int p = order[i];
  T zn[V];
  if (colors[p] == color) {
    const int lane = cm ? i : p;
    T acc[V];
#pragma unroll
    for (int a = 0; a < V; ++a) acc[a] = r[(size_t)p * V + a];
    if (!first) {
      T od[V];
      offdiag_at<T, S, V>(selp, zold, n, p, lane, st, od);
#pragma unroll
      for (int a = 0; a < V; ++a) acc[a] = acc[a] - od[a];
    }
    bapply_at<T, V>(dinv, n, lane, acc, zn);
  } else {
#pragma unroll
    for (int a = 0; a < V; ++a)
      zn[a] = first ? (T)0 : zold[(size_t)p * V + a];
  }
#pragma unroll
  for (int a = 0; a < V; ++a) znew[(size_t)p * V + a] = zn[a];
}

template <typename T, int V>
__global__ void matvec_lane_kernel(int n, Stencil st,
                                   const T* __restrict__ selm,
                                   const T* __restrict__ diag,
                                   const T* __restrict__ x,
                                   T* __restrict__ y) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  T w[V];
  matvec_at<T, V>(selm, diag, x, n, p, st, w);
#pragma unroll
  for (int a = 0; a < V; ++a) y[(size_t)p * V + a] = w[a];
}

// K5 at the compiled width V
template <typename T, typename S, int V>
int launch_sgs_matvec(int n, const Stencil& st, int ncolor, int do_sweep,
                      int do_matvec, int cm, const S* selp, const T* selm,
                      const T* dinv, const T* diag, const int8_t* colors,
                      const int* order, const T* r, T* z, T* w, T* zbuf,
                      cudaStream_t stream) {
  constexpr bool ROWS = V > 3;   // a warp per block row
  const int G = ROWS ? k5_groups(V) : 8;
  const dim3 threads = ROWS ? dim3(32, V, G) : dim3(32 * G);
  const int blocks = (n + 32 * G - 1) / (32 * G);
  const size_t smem = k5_smem<T>(V, st.k);
  if (n <= 0) return 0;
  const T* x = r;
  if (do_sweep) {
    const int npass = 2 * ncolor - 1;
    const T* zold = nullptr;
    for (int i = 0; i < npass; ++i) {
      const int c = i < ncolor ? i : 2 * ncolor - 2 - i;
      T* dst = ((npass - 1 - i) & 1) ? zbuf : z;   // the last pass writes z
      if constexpr (ROWS)
        sgs_pass_kernel<T, S, V><<<blocks, threads, smem, stream>>>(
            n, st, c, i == 0, cm, selp, dinv, colors, order, r, zold, dst);
      else
        sgs_pass_lane_kernel<T, S, V><<<blocks, threads, 0, stream>>>(
            n, st, c, i == 0, cm, selp, dinv, colors, order, r, zold, dst);
      zold = dst;
    }
    x = z;
  }
  if (do_matvec) {
    if constexpr (ROWS)
      matvec_kernel<T, V><<<blocks, threads, smem, stream>>>(n, st, selm,
                                                             diag, x, w);
    else
      matvec_lane_kernel<T, V><<<blocks, threads, 0, stream>>>(n, st, selm,
                                                               diag, x, w);
  }
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------- K6
template <typename T, typename S>
struct FgArgs {
  int n, ncolor, m;
  Stencil st;
  T tol;
  const S* selp;
  const T* selm;
  const T* dinv;
  const T* diag;
  const int8_t* colors;
  const int* order;   // V >= 7: the nodes sorted by color (color_order)
  int cm;             // V >= 7: selp and dinv in order's color-major lanes
  const T* b;
  T* x;
  T* stats;     // [relative residual, iterations]
  T* ws;        // V (m+1), Z (m), sweep scratch, w: each n*V
  T* part;      // rows kernel: 2 * gridDim.x block partials
  int v;        // the block width (the run-time kernel reads it)
};

template <typename T, bool MAX>
__device__ __forceinline__ T warp_red(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    T u = __shfl_down_sync(0xffffffffu, v, o);
    v = MAX ? (u > v ? u : v) : v + u;
  }
  return v;
}

// sum (or max) of v over the grid, returned to every thread; one grid
// barrier.  Partials alternate between two buffers, so a block that runs
// ahead never overwrites partials another block has yet to read.
template <typename T, bool MAX>
__device__ T grid_reduce(cg::grid_group& grid, T v, T* part, int& buf,
                         T* wsum, T* bcast) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  v = warp_red<T, MAX>(v);
  if (lane == 0) wsum[wid] = v;
  __syncthreads();
  T* pb = part + (size_t)buf * gridDim.x;
  if (wid == 0) {
    T s = lane < (int)(blockDim.x >> 5) ? wsum[lane] : (T)0;
    s = warp_red<T, MAX>(s);
    if (lane == 0) pb[blockIdx.x] = s;
  }
  grid.sync();
  if (wid == 0) {
    T s = (T)0;
    for (int i = lane; i < (int)gridDim.x; i += 32) {
      T u = __ldcg(pb + i);
      s = MAX ? (u > s ? u : s) : s + u;
    }
    s = warp_red<T, MAX>(s);
    if (lane == 0) *bcast = s;
  }
  __syncthreads();
  T tot = *bcast;
  buf ^= 1;
  return tot;
}

// The same over the cluster, returned to every thread; one cluster
// barrier.  Each CTA's partial goes into its own shared memory (cpart: two
// slots, alternating, so a CTA that runs ahead never overwrites a partial
// another CTA has yet to read); after the barrier lane r of warp 0 reads
// CTA r's partial over distributed shared memory and the warp sums them
// with warp_red's tree: the same sum, bit for bit, in every CTA.
template <typename T, bool MAX>
__device__ T cluster_reduce(cg::cluster_group& cl, T v, T* cpart, int& buf,
                            T* wsum, T* bcast) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  v = warp_red<T, MAX>(v);
  if (lane == 0) wsum[wid] = v;
  __syncthreads();
  if (wid == 0) {
    T s = lane < (int)(blockDim.x >> 5) ? wsum[lane] : (T)0;
    s = warp_red<T, MAX>(s);
    if (lane == 0) cpart[buf] = s;
  }
  cl.sync();
  if (wid == 0) {
    T s = lane < (int)cl.num_blocks()
              ? *cl.map_shared_rank(cpart + buf, (unsigned)lane)
              : (T)0;
    s = warp_red<T, MAX>(s);
    if (lane == 0) *bcast = s;
  }
  __syncthreads();
  T tot = *bcast;
  buf ^= 1;
  return tot;
}

__host__ __device__ constexpr int fg_smem_words(int m) {
  return 50 + 5 * m + m * m;
}

// The scalar part of Arnoldi step j, run by one thread of every block (the
// same numbers in each): h_{j+1,j} = |w| from h = |w|^2 (or the identity
// column once the cycle stopped), the earlier Givens rotations on the new
// column rc, the new rotation, the residual estimate |g_{j+1}| and the
// rotated column into cols; sc = [active, iterations, residual, vact,
// vden] (krylov.fgmres's recurrence).
template <typename T>
__device__ void fg_column(int j, int m, bool active, T h, T norm0, T tol,
                          T* sc, T* rc, T* cs, T* sn, T* g, T* cols) {
  const T tiny = (T)1e-300;   // 0 in float, as in the reference
  const T hj1 = active ? sq(h) : (T)0;
  sc[3] = sc[0];
  sc[4] = hj1 > tiny ? hj1 : tiny;
  sc[1] += sc[0];
  rc[j + 1] = hj1;
  for (int i = 0; i < j; ++i) {
    T t = cs[i] * rc[i] + sn[i] * rc[i + 1];
    rc[i + 1] = -sn[i] * rc[i] + cs[i] * rc[i + 1];
    rc[i] = t;
  }
  const T denom = sq(rc[j] * rc[j] + rc[j + 1] * rc[j + 1]);
  const T safe = denom > tiny ? denom : tiny;
  const T cj = denom == (T)0 ? (T)1 : rc[j] / safe;
  const T sj = denom == (T)0 ? (T)0 : rc[j + 1] / safe;
  cs[j] = cj;
  sn[j] = sj;
  const T gj1 = -sj * g[j];
  g[j] = cj * g[j];
  g[j + 1] = gj1;
  const T cur = fab(gj1);
  if (active) sc[2] = cur;
  sc[0] = (active && cur / norm0 >= tol) ? (T)1 : (T)0;
  for (int i = 0; i < j; ++i) cols[j * m + i] = rc[i];
  cols[j * m + j] = cj * rc[j] + sj * rc[j + 1];
}

// back-substitution on the rotated R into y; block 0 writes the stats
// [relative residual, iterations]
template <typename T>
__device__ void fg_solve_y(int m, T norm0, const T* sc, const T* g,
                           const T* cols, T* y, T* stats) {
  for (int j = m - 1; j >= 0; --j) {
    T acc = g[j];
    for (int i = j + 1; i < m; ++i) acc = acc - cols[i * m + j] * y[i];
    const T rjj = cols[j * m + j];
    y[j] = rjj == (T)0 ? (T)0 : acc / rjj;
  }
  if (blockIdx.x == 0) {
    stats[0] = sc[2] / norm0;
    stats[1] = sc[1];
  }
}

// K6 at V = 2, 3: x's K neighbour V-vectors of node p, every load started
// at once (the offsets unrolled to SU2K_MAXK under a kk < k guard), so a
// pass waits for one L2 round trip instead of one per offset; zero where
// the neighbour is skipped.  Written by other CTAs in the launch: __ldcg.
template <typename T, int V>
__device__ __forceinline__ void gather_nb(const T* x, int n, int p,
                                          const Stencil& st,
                                          T (&xq)[SU2K_MAXK][V]) {
#pragma unroll
  for (int kk = 0; kk < SU2K_MAXK; ++kk) {
    const int q = p + st.off[kk];
    const bool ok = kk < st.k && q >= 0 && q < n;
#pragma unroll
    for (int b = 0; b < V; ++b)
      xq[kk][b] = ok ? __ldcg(x + (size_t)q * V + b) : (T)0;
  }
}

// out = sum_k B_k[p] xq[k] over the neighbours inside [0, n), summed as
// offdiag_at sums (over b, then the offsets in order)
template <typename T, typename S, int V>
__device__ __forceinline__ void offdiag_nb(const S* __restrict__ sel, int n,
                                           int p, const Stencil& st,
                                           const T (&xq)[SU2K_MAXK][V],
                                           T (&out)[V]) {
#pragma unroll
  for (int a = 0; a < V; ++a) out[a] = (T)0;
#pragma unroll
  for (int kk = 0; kk < SU2K_MAXK; ++kk) {
    const int q = p + st.off[kk];
    if (kk >= st.k || q < 0 || q >= n) continue;
    const S* blk = sel + (size_t)kk * V * V * n + p;
#pragma unroll
    for (int a = 0; a < V; ++a) {
      T y = (T)0;
#pragma unroll
      for (int b = 0; b < V; ++b)
        y += widen<T, S>(blk[(size_t)(a * V + b) * n]) * xq[kk][b];
      out[a] += y;
    }
  }
}

// one color pass of K6's sweep at node p (first: z_old is 0, r - 0 = r),
// gather_nb's loads started before the color test
template <typename T, typename S, int V>
__device__ __forceinline__ void sweep_nb(const S* __restrict__ selp,
                                         const T* __restrict__ dinv,
                                         const int8_t* __restrict__ colors,
                                         const T (&r)[V], const T* zold,
                                         T* znew, int n, int p,
                                         const Stencil& st, int color,
                                         bool first) {
  T xq[SU2K_MAXK][V], zo[V], zn[V];
  if (!first) {
    gather_nb<T, V>(zold, n, p, st, xq);
#pragma unroll
    for (int a = 0; a < V; ++a) zo[a] = __ldcg(zold + (size_t)p * V + a);
  }
  if (colors[p] == color) {
    T acc[V];
    if (first) {
#pragma unroll
      for (int a = 0; a < V; ++a) acc[a] = r[a];
    } else {
      T od[V];
      offdiag_nb<T, S, V>(selp, n, p, st, xq, od);
#pragma unroll
      for (int a = 0; a < V; ++a) acc[a] = r[a] - od[a];
    }
    bapply_at<T, V>(dinv, n, p, acc, zn);
  } else {
#pragma unroll
    for (int a = 0; a < V; ++a) zn[a] = first ? (T)0 : zo[a];
  }
#pragma unroll
  for (int a = 0; a < V; ++a) znew[(size_t)p * V + a] = zn[a];
}

// matvec_at with gather_nb's loads
template <typename T, int V>
__device__ __forceinline__ void matvec_nb(const T* __restrict__ selm,
                                          const T* __restrict__ diag,
                                          const T* z, int n, int p,
                                          const Stencil& st, T (&w)[V]) {
  T xq[SU2K_MAXK][V], zp[V], od[V];
  gather_nb<T, V>(z, n, p, st, xq);
#pragma unroll
  for (int a = 0; a < V; ++a) zp[a] = __ldcg(z + (size_t)p * V + a);
  offdiag_nb<T, T, V>(selm, n, p, st, xq, od);
  bapply_at<T, V>(diag, n, p, zp, w);
#pragma unroll
  for (int a = 0; a < V; ++a) w[a] += od[a];
}

// f(p) for each node p of this thread in K6's cluster kernel: its own
// node (RES: a thread per node), else its nodes grid-stride
template <bool RES, typename F>
__device__ __forceinline__ void fg_each(int tid, int nth, int n, F&& f) {
  if (RES) {
    if (tid < n) f(tid);
  } else {
    for (int p = tid; p < n; p += nth) f(p);
  }
}

// K6 at V = 2, 3: the cycle in one cluster, a thread per node, the same
// nodes in every phase (the module comment); every barrier is a cluster
// barrier.  RES, the resident form (every node has a thread of its own,
// n <= C * 1024, and the threads' bases fit in shared memory): the basis
// v_0 .. v_{m-1} of the thread's node lives in its CTA's shared memory and
// w in its registers, so the Gram-Schmidt passes (j + 2 of the
// m (2 nc + 1) + m (m - 1)/2 + 2 barriers of step j) read and write no
// device memory, and only z (read by the neighbours in the sweep passes and
// the matvec) goes through it.  Else both live in device memory (ws) and
// each thread walks its nodes grid-stride.  The arithmetic is the same in
// both forms.
template <typename T, typename S, int V, bool RES>
__global__ void __launch_bounds__(SU2K_FG_CLUSTER_THREADS, 1)
fgmres_cluster_kernel(FgArgs<T, S> A) {
  cg::cluster_group cl = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char fg_smem[];
  T* sh = reinterpret_cast<T*>(fg_smem);
  const int n = A.n, m = A.m;
  T* cpart = sh + fg_smem_words(m);   // 2 partial slots
  T* vsm = cpart + 2;                 // RES: the basis, [i][a][thread]
  T* wsum = sh;              // 32 warp partials
  T* bc = sh + 32;           // reduction broadcast
  T* sc = sh + 40;           // active, iters, res_hist, vact, vden
  T* rc = sh + 48;           // m + 1: the new Hessenberg column
  T* cs = rc + m + 1;        // m
  T* sn = cs + m;            // m
  T* g = sn + m;             // m + 1
  T* y = g + m + 1;          // m
  T* cols = y + m;           // m * m: rotated column j, row i at j*m + i
  const size_t nv = (size_t)n * V;
  T* vb = A.ws;                       // !RES: the basis, [i][node][a]
  T* zb = vb + (size_t)(m + 1) * nv;
  T* zs = zb + (size_t)m * nv;
  T* wv = zs + nv;                    // !RES: w
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nth = gridDim.x * blockDim.x;
  const int npass = 2 * A.ncolor - 1;
  const T tiny = (T)1e-300;   // 0 in float, as in the reference
  int buf = 0;
  T wr[V];                            // RES: w
  // entry a of the basis vector v_i and of w at node p
  auto vv = [&](int i, int p, int a) -> T& {
    if constexpr (RES)
      return vsm[((size_t)i * V + a) * blockDim.x + threadIdx.x];
    else
      return vb[(size_t)i * nv + (size_t)p * V + a];
  };
  auto ww = [&](int p, int a) -> T& {
    if constexpr (RES)
      return wr[a];
    else
      return wv[(size_t)p * V + a];
  };

  // exact power-of-two scaling of b (krylov._pow2_scale)
  T amax = (T)0;
  fg_each<RES>(tid, nth, n, [&](int p) {
#pragma unroll
    for (int a = 0; a < V; ++a) {
      T u = fab(A.b[(size_t)p * V + a]);
      amax = u > amax ? u : amax;
    }
  });
  amax = cluster_reduce<T, true>(cl, amax, cpart, buf, wsum, bc);
  const T s = amax > (T)0 ? pow2_floor(amax > tiny ? amax : tiny) : (T)1;

  T ss = (T)0;
  fg_each<RES>(tid, nth, n, [&](int p) {
#pragma unroll
    for (int a = 0; a < V; ++a) {
      T bv = A.b[(size_t)p * V + a] / s;
      ss += bv * bv;
    }
  });
  const T beta = sq(cluster_reduce<T, false>(cl, ss, cpart, buf, wsum, bc));
  const T norm0 = beta > tiny ? beta : tiny;
  fg_each<RES>(tid, nth, n, [&](int p) {
#pragma unroll
    for (int a = 0; a < V; ++a)
      vv(0, p, a) = (A.b[(size_t)p * V + a] / s) / norm0;
  });
  if (threadIdx.x == 0) {
    sc[0] = (beta / norm0 >= A.tol) ? (T)1 : (T)0;
    sc[1] = (T)0;
    sc[2] = beta;
    sc[3] = (T)0;
    sc[4] = (T)1;
    g[0] = beta;
  }
  __syncthreads();

  for (int j = 0; j < m; ++j) {
    T* zj = zb + (size_t)j * nv;
    const bool vact = sc[3] != (T)0;
    const T vden = sc[4];
    // v_j: the normalised w (v_{j-1} once the cycle stopped)
    if (j > 0)
      fg_each<RES>(tid, nth, n, [&](int p) {
#pragma unroll
        for (int a = 0; a < V; ++a)
          vv(j, p, a) = vact ? ww(p, a) / vden : vv(j - 1, p, a);
      });
    // z_j = sweep(v_j)
    const T* zold = nullptr;
    for (int i = 0; i < npass; ++i) {
      const int c = i < A.ncolor ? i : 2 * A.ncolor - 2 - i;
      T* dst = ((npass - 1 - i) & 1) ? zs : zj;
      fg_each<RES>(tid, nth, n, [&](int p) {
        T r[V];
#pragma unroll
        for (int a = 0; a < V; ++a) r[a] = vv(j, p, a);
        sweep_nb<T, S, V>(A.selp, A.dinv, A.colors, r, zold, dst, n, p,
                          A.st, c, i == 0);
      });
      cl.sync();
      zold = dst;
    }
    // w = A z_j, fused with the first Gram-Schmidt dot (v_0, w)
    T part = (T)0;
    fg_each<RES>(tid, nth, n, [&](int p) {
      T w[V];
      matvec_nb<T, V>(A.selm, A.diag, zj, n, p, A.st, w);
#pragma unroll
      for (int a = 0; a < V; ++a) {
        ww(p, a) = w[a];
        part += vv(0, p, a) * w[a];
      }
    });
    T h = cluster_reduce<T, false>(cl, part, cpart, buf, wsum, bc);
    const bool active = sc[0] != (T)0;
    // modified Gram-Schmidt: w -= h_ij v_i, then the next dot (or |w|^2)
    for (int i = 0; i <= j; ++i) {
      const T hij = active ? h : (i == j ? (T)1 : (T)0);
      const T hm = active ? hij : (T)0;
      if (threadIdx.x == 0) rc[i] = hij;
      part = (T)0;
      fg_each<RES>(tid, nth, n, [&](int p) {
#pragma unroll
        for (int a = 0; a < V; ++a) {
          T t = ww(p, a) - hm * vv(i, p, a);
          ww(p, a) = t;
          part += (i < j) ? vv(i + 1, p, a) * t : t * t;
        }
      });
      h = cluster_reduce<T, false>(cl, part, cpart, buf, wsum, bc);
    }
    if (threadIdx.x == 0)
      fg_column(j, m, active, h, norm0, A.tol, sc, rc, cs, sn, g, cols);
    __syncthreads();
  }

  // the last partials have been read; a CTA leaves only once every CTA
  // of the cluster has got here (its shared memory is read remotely)
  asm volatile("barrier.cluster.arrive;" ::: "memory");
  // back-substitution on the rotated R, then x = s * sum_j y_j z_j
  if (threadIdx.x == 0) fg_solve_y(m, norm0, sc, g, cols, y, A.stats);
  __syncthreads();
  fg_each<RES>(tid, nth, n, [&](int p) {
#pragma unroll
    for (int a = 0; a < V; ++a) {
      const size_t e = (size_t)p * V + a;
      T d = zb[e] * y[0];
      // the basis entries 8 at a time, loaded before they are summed
      for (int j0 = 1; j0 < m; j0 += 8) {
        T zz[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          zz[u] = j0 + u < m ? zb[(size_t)(j0 + u) * nv + e] : (T)0;
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (j0 + u < m) d = d + y[j0 + u] * zz[u];
      }
      A.x[e] = d * s;
    }
  });
  asm volatile("barrier.cluster.wait;" ::: "memory");
}

// K6 at the compiled V = 7, 8, 13, 14: the same cycle with K5's thread
// layout in the sweep passes and the matvec.  A block is G = k5_groups(v) groups of 32 lanes,
// v warps each (1-D: thread t is lane t % 32 of row (t / 32) % v of group
// t / (32 v)); warp a forms row a of the 32 nodes' block products, so each
// block-row load is one coalesced read, and the node-major vectors are
// staged through shared memory.  The blocks walk the 32-node groups
// (grid-stride, the same groups in every pass); a sweep pass runs over the
// lanes of the color-major node list order (the nodes sorted by color), so
// its color's nodes are a contiguous run of lanes and their rows of the
// bf16 blocks (cm: the color-major copy) are contiguous too.  The vector
// updates of the Gram-Schmidt passes and the reductions run flat over the
// n V entries.  Every value another thread wrote inside the launch is read
// through L2 (__ldcg): the phases map entries to threads differently.
__host__ __device__ constexpr int fg_rows_threads(int v) {
  return 32 * v * k5_groups(v);
}

// shared words of the staging area: per group (K + 2) vectors of 32 v
// (sized for SU2K_MAXK offsets, so the grid does not depend on K)
__host__ __device__ constexpr int fg_rows_stage_words(int v) {
  return k5_groups(v) * (SU2K_MAXK + 2) * 32 * v;
}

// 3 blocks per SM: the one-launch tier's largest field (npad <= 12,288
// at m = 10, stencil_solve._fgmres_cap) is 384 groups, so at V = 13 every
// group of a pass runs in one wave on 396 co-resident blocks; at 2 blocks
// per SM (72 registers) 264 blocks took two rounds in some blocks and one
// FGMRES(10) cycle at 9,072 nodes took ~1.0 ms instead of ~0.72.
template <typename T, typename S, int V>
__global__ void __launch_bounds__(fg_rows_threads(V), 3)
fgmres_rows_kernel(FgArgs<T, S> A) {
  const int v = V;
  const int G = k5_groups(v);
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char fg_smem[];
  T* sh = reinterpret_cast<T*>(fg_smem);
  const int n = A.n, m = A.m;
  T* wsum = sh;              // 32 warp partials
  T* bc = sh + 32;           // reduction broadcast
  T* sc = sh + 40;           // active, iters, res_hist, vact, vden
  T* rc = sh + 48;           // m + 1: the new Hessenberg column
  T* cs = rc + m + 1;        // m
  T* sn = cs + m;            // m
  T* g = sn + m;             // m + 1
  T* y = g + m + 1;          // m
  T* cols = y + m;           // m * m: rotated column j, row i at j*m + i
  const int t = threadIdx.x;
  const int l = t & 31, a = (t >> 5) % v, gl = (t >> 5) / v;
  const int k = A.st.k;
  // this group's staging: K neighbour vectors, r (or z), the row results
  T* gx = sh + fg_smem_words(m) + (size_t)gl * (SU2K_MAXK + 2) * 32 * v;
  T* gr = gx + (size_t)k * 32 * v;
  T* gacc = gr + 32 * v;
  const size_t nv = (size_t)n * v;
  T* vb = A.ws;
  T* zb = vb + (size_t)(m + 1) * nv;
  T* zs = zb + (size_t)m * nv;
  T* wv = zs + nv;
  const long long tid = (long long)blockIdx.x * blockDim.x + t;
  const long long nth = (long long)gridDim.x * blockDim.x;
  const int ngroup = (n + 31) / 32;
  const int npass = 2 * A.ncolor - 1;
  const T tiny = (T)1e-300;   // 0 in float, as in the reference
  int buf = 0;

  // exact power-of-two scaling of b (krylov._pow2_scale)
  T amax = (T)0;
  for (long long e = tid; e < (long long)nv; e += nth) {
    T u = fab(A.b[e]);
    amax = u > amax ? u : amax;
  }
  amax = grid_reduce<T, true>(grid, amax, A.part, buf, wsum, bc);
  const T s = amax > (T)0 ? pow2_floor(amax > tiny ? amax : tiny) : (T)1;
  T ss = (T)0;
  for (long long e = tid; e < (long long)nv; e += nth) {
    T bv = A.b[e] / s;
    ss += bv * bv;
  }
  const T beta = sq(grid_reduce<T, false>(grid, ss, A.part, buf, wsum, bc));
  const T norm0 = beta > tiny ? beta : tiny;
  for (long long e = tid; e < (long long)nv; e += nth)
    vb[e] = (A.b[e] / s) / norm0;
  if (t == 0) {
    sc[0] = (beta / norm0 >= A.tol) ? (T)1 : (T)0;
    sc[1] = (T)0;
    sc[2] = beta;
    sc[3] = (T)0;
    sc[4] = (T)1;
    g[0] = beta;
  }
  __syncthreads();

  for (int j = 0; j < m; ++j) {
    T* vj = vb + (size_t)j * nv;
    T* zj = zb + (size_t)j * nv;
    const bool vact = sc[3] != (T)0;
    const T vden = sc[4];
    // v_j: written in the phase before (v_0) or in the first pass's phase
    // (j > 0: entry e of the normalised w, or v_{j-1} once the cycle
    // stopped) by the flat entry mapping, so the first pass, which reads
    // other nodes' entries, forms it on the fly with the same operations
    auto vnew = [&](size_t e) {
      if (j == 0) return (A.b[e] / s) / norm0;
      return vact ? __ldcg(wv + e) / vden : __ldcg(vj - nv + e);
    };
    if (j > 0)
      for (long long e = tid; e < (long long)nv; e += nth) vj[e] = vnew(e);
    // z_j = sweep(v_j)
    const T* zold = nullptr;
    for (int i = 0; i < npass; ++i) {
      const int color = i < A.ncolor ? i : 2 * A.ncolor - 2 - i;
      const bool first = i == 0;
      T* dst = ((npass - 1 - i) & 1) ? zs : zj;
      for (int base = blockIdx.x * G; base < ngroup; base += gridDim.x * G) {
        const int i0 = (base + gl) * 32;
        {
          // stage: element e = (node e / v, entry e % v) of each vector
          const int e = a * 32 + l, ls = e / v, b = e - ls * v;
          const int is = i0 + ls;
          if (is < n) {
            const int ps = A.order[is];
            if (A.colors[ps] == color) {
              const size_t idx = (size_t)ps * v + b;
              gr[e] = first ? vnew(idx) : __ldcg(vj + idx);
              for (int kk = 0; kk < k && !first; ++kk) {
                const int q = ps + A.st.off[kk];
                gx[kk * 32 * v + e] =
                    q < 0 || q >= n ? (T)0 : __ldcg(zold + (size_t)q * v + b);
              }
            }
          }
        }
        __syncthreads();
        const int ii = i0 + l;
        const int p = ii < n ? A.order[ii] : 0;
        const bool mine = ii < n && A.colors[p] == color;
        const int lane = A.cm ? ii : p;
        if (mine) {
          T acc = gr[l * v + a];
          if (!first) {
            T od = (T)0;
            for (int kk = 0; kk < k; ++kk) {
              const int q = p + A.st.off[kk];
              if (q < 0 || q >= n) continue;
              const S* blk = A.selp + ((size_t)kk * v * v + a * v) * n + lane;
              const T* x = gx + kk * 32 * v + l * v;
              T yv = (T)0;
#pragma unroll
              for (int b = 0; b < V; ++b)
                yv += widen<T, S>(blk[(size_t)b * n]) * x[b];
              od += yv;
            }
            acc = acc - od;
          }
          gacc[l * v + a] = acc;
        }
        __syncthreads();
        if (ii < n) {
          T zn;
          if (mine) {
            const T* dr = A.dinv + (size_t)a * v * n + lane;
            zn = (T)0;
#pragma unroll
            for (int b = 0; b < V; ++b)
              zn += dr[(size_t)b * n] * gacc[l * v + b];
          } else {
            zn = first ? (T)0 : __ldcg(zold + (size_t)p * v + a);
          }
          dst[(size_t)p * v + a] = zn;
        }
        __syncthreads();
      }
      grid.sync();
      zold = dst;
    }
    // w = A z_j (natural layout, 32 consecutive nodes a group), fused with
    // the first Gram-Schmidt dot (v_0, w)
    T part = (T)0;
    for (int base = blockIdx.x * G; base < ngroup; base += gridDim.x * G) {
      const int p0 = (base + gl) * 32;
      T* gz = gr;                       // z of the group's own nodes
      {
        const int e = a * 32 + l;
        const int ps = p0 + e / v;
        if (ps < n) {
          gz[e] = __ldcg(zj + (size_t)p0 * v + e);
          for (int kk = 0; kk < k; ++kk) {
            const int q = ps + A.st.off[kk];
            gx[kk * 32 * v + e] =
                q < 0 || q >= n ? (T)0
                                : __ldcg(zj + (size_t)p0 * v + e
                                         + (ptrdiff_t)A.st.off[kk] * v);
          }
        }
      }
      __syncthreads();
      const int p = p0 + l;
      if (p < n) {
        T od = (T)0;
        for (int kk = 0; kk < k; ++kk) {
          const int q = p + A.st.off[kk];
          if (q < 0 || q >= n) continue;
          const T* blk = A.selm + ((size_t)kk * v * v + a * v) * n + p;
          const T* xq = gx + kk * 32 * v + l * v;
          T tv = (T)0;
#pragma unroll
          for (int b = 0; b < V; ++b)
            tv += blk[(size_t)b * n] * xq[b];
          od += tv;
        }
        const T* dr = A.diag + (size_t)a * v * n + p;
        T w = (T)0;
#pragma unroll
        for (int b = 0; b < V; ++b)
          w += dr[(size_t)b * n] * gz[l * v + b];
        w = w + od;
        const size_t e = (size_t)p * v + a;
        wv[e] = w;
        part += __ldcg(vb + e) * w;
      }
      __syncthreads();
    }
    T h = grid_reduce<T, false>(grid, part, A.part, buf, wsum, bc);
    const bool active = sc[0] != (T)0;
    // modified Gram-Schmidt: w -= h_ij v_i, then the next dot (or |w|^2)
    for (int i = 0; i <= j; ++i) {
      const T hij = active ? h : (i == j ? (T)1 : (T)0);
      const T hm = active ? hij : (T)0;
      if (t == 0) rc[i] = hij;
      const T* vi = vb + (size_t)i * nv;
      part = (T)0;
      for (long long e = tid; e < (long long)nv; e += nth) {
        T tv = __ldcg(wv + e) - hm * __ldcg(vi + e);
        wv[e] = tv;
        part += (i < j) ? __ldcg(vi + nv + e) * tv : tv * tv;
      }
      h = grid_reduce<T, false>(grid, part, A.part, buf, wsum, bc);
    }
    if (t == 0)
      fg_column(j, m, active, h, norm0, A.tol, sc, rc, cs, sn, g, cols);
    __syncthreads();
  }

  // back-substitution on the rotated R, then x = s * sum_j y_j z_j
  if (t == 0) fg_solve_y(m, norm0, sc, g, cols, y, A.stats);
  __syncthreads();
  for (long long e = tid; e < (long long)nv; e += nth) {
    T d = __ldcg(zb + e) * y[0];
    for (int j = 1; j < m; ++j) d = d + y[j] * __ldcg(zb + (size_t)j * nv + e);
    A.x[e] = d * s;
  }
}

// ------------------------------------------------------ run-time widths
// K5 and K6 at every block width from 4 to SU2K_VMAX that has no compiled
// instance (4-6, 9-12, 15-21: the flow's nDim + nSpecies + 2 at the
// mixtures other than 3 and 9 species), and at any width of that range
// where the caller forces them (rt).  Bound on the H100: bytes, as above.
// Design:
// - Width classes.  Each kernel is instantiated for the class bounds VB
//   of SU2K_BY_CLASS (6, 12, 16, 21); width v runs the smallest class with
//   VB >= v, each block row's loop unrolled to VB under a b < v guard.  K5 keeps
//   the compiled kernels' thread layout and order (a warp per block row,
//   k5_groups(v) groups of 32 lanes a block, the group's vectors staged in
//   shared memory), bounded for 512 threads at 3 blocks an SM up to the 16
//   class (672 at 2 at 21): 40 registers (at 2 blocks an SM they took
//   46-53, and v = 9 and 13 fit a block less an SM).  The vectors sit at
//   a row stride vp = v | 1 (odd: the lanes' reads of entry b fall in 32
//   banks; at v = 16 a stride of v puts them in 2).
// - K6 (fgmres_rt_kernel): fgmres_rows_kernel's cycle with one 32-node
//   group a block of v warps.  Resident form: each block copies its
//   groups' sweep blocks and dinv into shared memory once (cp.async: the
//   16-byte chunks that cover each block row's run in the color-major
//   layout, a copy a lane through the node list in the natural one) and
//   keeps them for the cycle's m (2 nc - 1) passes, which read no sweep
//   block from device memory; streamed form (where they do not fit:
//   kernels.k6_plan, a pure function of the width, offsets, types,
//   layout, n and grid) the passes read them as the compiled kernel does.
//   Its block-row products unroll SU2K_RT_K6_CH terms at a time: fully
//   unrolled, its cycle spilled at 64 registers.  The 21 class holds no
//   resident rows (fg_rt_resident).
// - Measured and dropped (PERF.md §6): K5's and K6's streamed block rows
//   staged in shared memory by cp.async in a ring of 2-4 units of a
//   persistent grid ran 1.1-2.6x the direct loads' time on the H100.
// Every block row is summed over b, then over the offsets in order, as in
// the compiled kernels, so K5's (z, A z) is bit for bit the compiled
// instance's at a compiled width.
#define SU2K_RT_K6_CH 4     // K6's block-row terms unrolled at a time

// bytes of K6's run-time shared memory before the resident rows: the
// scalars and one group's staged vectors (K neighbour z, r, the row
// results; sized for SU2K_MAXK at a row stride of v | 1); kernels.k6_plan's
// base, which the launch checks
template <typename T>
constexpr int fg_rt_base(int v, int m) {
  return ((fg_smem_words(m) + (SU2K_MAXK + 2) * 32 * (v | 1))
              * (int)sizeof(T) + 15) / 16 * 16;
}

// kernels.k6_plan, in this order (RT_PLAN_FIELDS)
struct RtPlan {
  int vb;       // the width class
  int res;      // the resident form
  int gpb;      // resident: groups a block holds
  int grp;      // resident: bytes of a group's rows
  int slot_s;   // resident: bytes of a sweep-block row, of a dinv row
  int slot_t;
  int base;     // bytes of shared memory before the resident rows
  int smem;     // dynamic shared memory of the launch
  int grid;     // blocks of the cooperative grid
};

// K5's bounds: 512 threads at 3 blocks an SM (40 registers) up to the 16
// class, 672 at 2 for the 21 class
__host__ __device__ constexpr int rt_threads(int vb) {
  return vb <= 16 ? 512 : 32 * vb;
}
__host__ __device__ constexpr int rt_blocks(int vb) {
  return vb <= 16 ? 3 : 2;
}
// K6's: the 6 class's blocks of at most 192 threads 4 an SM at 80
// registers, the 12 and 16 classes' 512 threads 2 (64 registers; at v = 9
// and 10 every group of the one-launch tier in one wave), the 21 class's
// 672 threads 1 (80; at 2, 40 registers, it spilled), which hold no
// resident rows (a group's take 88 KB and more there)
__host__ __device__ constexpr int fg_rt_threads(int vb) {
  return vb <= 6 ? 32 * vb : rt_threads(vb);
}
__host__ __device__ constexpr int fg_rt_blocks(int vb) {
  return vb <= 6 ? 4 : (vb <= 16 ? 2 : 1);
}
__host__ __device__ constexpr bool fg_rt_resident(int vb) { return vb <= 16; }

// out = sum_b widen(blk[b n]) x[b] over b < v (a block row of the
// (rows, n) lane layout from device memory), CH terms unrolled at a time,
// in the compiled kernels' order
template <typename T, typename E, int VB, int CH = VB>
__device__ __forceinline__ T row_dot_g(const E* __restrict__ blk, int n,
                                       const T* x, int v) {
  T y = (T)0;
#pragma unroll 1
  for (int b0 = 0; b0 < VB; b0 += CH) {
#pragma unroll
    for (int bb = 0; bb < CH; ++bb) {
      const int b = b0 + bb;
      if (b < v) y += widen<T, E>(blk[(size_t)b * n]) * x[b];
    }
  }
  return y;
}

// K5's sweep pass at a run-time width v (sgs_pass_kernel's arithmetic)
template <typename T, typename S, int VB>
__global__ void __launch_bounds__(rt_threads(VB), rt_blocks(VB))
sgs_pass_rt_kernel(int n, Stencil st, int color, int first, int cm,
                   const S* __restrict__ selp, const T* __restrict__ dinv,
                   const int8_t* __restrict__ colors,
                   const int* __restrict__ order, const T* __restrict__ r,
                   const T* zold, T* znew, int v) {
  extern __shared__ __align__(16) unsigned char k5_raw[];
  const int vp = v | 1;
  const int l = threadIdx.x, a = threadIdx.y, g = threadIdx.z;
  const int k = st.k;
  T* gx = reinterpret_cast<T*>(k5_raw) + (size_t)g * (k + 2) * 32 * vp;
  T* gr = gx + (size_t)k * 32 * vp;    // r of the group's nodes
  T* gacc = gr + 32 * vp;              // r - sum_k B_k z_old, by row
  const int i0 = (blockIdx.x * k5_groups(v) + g) * 32;
  {
    // stage: element e = (node e / v, entry e % v) of each vector
    const int e = a * 32 + l, ls = e / v, b = e - ls * v;
    const int is = i0 + ls;
    if (is < n) {
      const int ps = order[is];
      if (colors[ps] == color) {
        gr[ls * vp + b] = r[(size_t)ps * v + b];
        for (int kk = 0; kk < k && !first; ++kk) {
          const int q = ps + st.off[kk];
          gx[kk * 32 * vp + ls * vp + b] =
              q < 0 || q >= n ? (T)0 : zold[(size_t)q * v + b];
        }
      }
    }
  }
  __syncthreads();
  const int i = i0 + l;
  const int p = i < n ? order[i] : 0;
  const bool mine = i < n && colors[p] == color;
  const int lane = cm ? i : p;
  if (mine) {
    T acc = gr[l * vp + a];
    if (!first) {
      T od = (T)0;
      for (int kk = 0; kk < k; ++kk) {
        const int q = p + st.off[kk];
        if (q < 0 || q >= n) continue;
        od += row_dot_g<T, S, VB>(selp + ((size_t)kk * v * v + a * v) * n
                                      + lane,
                                  n, gx + kk * 32 * vp + l * vp, v);
      }
      acc = acc - od;
    }
    gacc[l * vp + a] = acc;
  }
  __syncthreads();
  if (i < n) {
    znew[(size_t)p * v + a] =
        mine ? row_dot_g<T, T, VB>(dinv + (size_t)a * v * n + lane, n,
                                   gacc + l * vp, v)
             : (first ? (T)0 : zold[(size_t)p * v + a]);
  }
}

// K5's matvec at a run-time width v (matvec_kernel's arithmetic)
template <typename T, int VB>
__global__ void __launch_bounds__(rt_threads(VB), rt_blocks(VB))
matvec_rt_kernel(int n, Stencil st, const T* __restrict__ selm,
                 const T* __restrict__ diag, const T* __restrict__ x,
                 T* __restrict__ y, int v) {
  extern __shared__ __align__(16) unsigned char k5_raw[];
  const int vp = v | 1;
  const int l = threadIdx.x, a = threadIdx.y, g = threadIdx.z;
  const int k = st.k;
  T* gx = reinterpret_cast<T*>(k5_raw) + (size_t)g * (k + 2) * 32 * vp;
  T* gz = gx + (size_t)k * 32 * vp;    // z of the group's own nodes
  const int p0 = (blockIdx.x * k5_groups(v) + g) * 32;
  {
    const int e = a * 32 + l, ls = e / v, b = e - ls * v;
    const int ps = p0 + ls;
    if (ps < n) {
      gz[ls * vp + b] = x[(size_t)p0 * v + e];
      for (int kk = 0; kk < k; ++kk) {
        const int q = ps + st.off[kk];
        gx[kk * 32 * vp + ls * vp + b] =
            q < 0 || q >= n ? (T)0 : x[(size_t)q * v + b];
      }
    }
  }
  __syncthreads();
  const int p = p0 + l;
  if (p >= n) return;
  T od = (T)0;
  for (int kk = 0; kk < k; ++kk) {
    const int q = p + st.off[kk];
    if (q < 0 || q >= n) continue;
    od += row_dot_g<T, T, VB>(selm + ((size_t)kk * v * v + a * v) * n + p,
                              n, gx + kk * 32 * vp + l * vp, v);
  }
  const T w = row_dot_g<T, T, VB>(diag + (size_t)a * v * n + p, n,
                                  gz + l * vp, v);
  y[(size_t)p * v + a] = w + od;
}

// shared memory of a run-time K5 block: per group K staged neighbour
// vectors, r (or z) and the rows' results, each 32 vp; past the 48 KB a
// launch gets unasked at v = 4 and 17-21 in f64 (k5_smem_attr asks)
template <typename T>
size_t k5_rt_smem(int v, int k) {
  return (size_t)k5_groups(v) * (k + 2) * 32 * (v | 1) * sizeof(T);
}

template <typename K>
cudaError_t k5_smem_attr(K* kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// K5 at a run-time width v, class VB: one launch per pass, then the
// matvec, as launch_sgs_matvec
template <typename T, typename S, int VB>
int launch_sgs_matvec_rt(int v, int n, const Stencil& st, int ncolor,
                         int do_sweep, int do_matvec, int cm, const S* selp,
                         const T* selm, const T* dinv, const T* diag,
                         const int8_t* colors, const int* order, const T* r,
                         T* z, T* w, T* zbuf, cudaStream_t stream) {
  const int G = k5_groups(v);
  const dim3 threads(32, v, G);
  const int blocks = (n + 32 * G - 1) / (32 * G);
  const size_t smem = k5_rt_smem<T>(v, st.k);
  if (n <= 0) return 0;
  cudaError_t err = k5_smem_attr(sgs_pass_rt_kernel<T, S, VB>, smem);
  if (err == cudaSuccess) err = k5_smem_attr(matvec_rt_kernel<T, VB>, smem);
  if (err != cudaSuccess) return (int)err;
  const T* x = r;
  if (do_sweep) {
    const int npass = 2 * ncolor - 1;
    const T* zold = nullptr;
    for (int i = 0; i < npass; ++i) {
      const int c = i < ncolor ? i : 2 * ncolor - 2 - i;
      T* dst = ((npass - 1 - i) & 1) ? zbuf : z;   // the last pass writes z
      sgs_pass_rt_kernel<T, S, VB><<<blocks, threads, smem, stream>>>(
          n, st, c, i == 0, cm, selp, dinv, colors, order, r, zold, dst, v);
      zold = dst;
    }
    x = z;
  }
  if (do_matvec)
    matvec_rt_kernel<T, VB><<<blocks, threads, smem, stream>>>(
        n, st, selm, diag, x, w, v);
  return (int)cudaGetLastError();
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// 16 bytes from global src (16-byte aligned) to shared dst, of which only
// the first `bytes` are read (the rest zero-filled)
__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
template <int B>
__device__ __forceinline__ void cp_small(void* dst, const void* src,
                                         int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(B), "r"(bytes)
               : "memory");
}
// every copy this thread started, complete
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" :::
                   "memory");
}

// bytes a lane's copy of an E takes through the node list
template <typename E>
__host__ __device__ constexpr int gather_bytes() {
  return sizeof(E) < 4 ? 4 : (int)sizeof(E);
}

// Copy rows [0, nrows) of the (rows, n) array x to dst (row r at
// dst + r slot): contig, lanes [i0, i0 + nl) as the 16-byte chunks that
// cover their run (chunks past x's end cut; x starts on a 16-byte
// boundary); else lane l as node ids[l] (l < nl).  Thread tid of nth.
template <typename E>
__device__ __forceinline__ void rows_copy(unsigned char* dst, int slot,
                                          const E* x, size_t total, int n,
                                          int nrows, bool contig, int i0,
                                          int nl, const int* ids, int tid,
                                          int nth) {
  const uintptr_t lim = (uintptr_t)(x + total);
  if (contig) {
    constexpr int CH = 32 * (int)sizeof(E) / 16 + 1;
    for (int c = tid; c < nrows * CH; c += nth) {
      const int r = c / CH, ch = c - r * CH;
      const E* run = x + (size_t)r * n + i0;
      const uintptr_t at = ((uintptr_t)run & ~(uintptr_t)15) + ch * 16;
      if (at >= (uintptr_t)(run + nl) || at >= lim) continue;
      cp16(dst + (size_t)r * slot + ch * 16, (const void*)at,
           lim - at < 16 ? (int)(lim - at) : 16);
    }
  } else {
    constexpr int EC = gather_bytes<E>();
    for (int e = tid; e < nrows * 32; e += nth) {
      const int r = e >> 5, l = e & 31;
      if (l >= nl) continue;
      const uintptr_t at = (uintptr_t)(x + (size_t)r * n + ids[l]) &
                           ~(uintptr_t)(EC - 1);
      cp_small<EC>(dst + (size_t)r * slot + l * EC, (const void*)at,
                   lim - at < (uintptr_t)EC ? (int)(lim - at) : EC);
    }
  }
}

// Where lane l's element of row rr of such a copy sits: byte
// rr slot + lo + ((sh0 + rr dn) & msk) (a row's address modulo 16 moves
// by n sizeof(E) a row)
struct RowAt {
  int lo, sh0, dn, msk;
};
template <typename E>
__device__ __forceinline__ RowAt row_at(const E* x, int n, bool contig,
                                        int key, int l) {
  RowAt at;
  at.dn = (int)(((unsigned long long)n * sizeof(E)) & 15);
  at.sh0 = (int)((uintptr_t)(x + key) & 15);
  at.lo = l * (contig ? (int)sizeof(E) : gather_bytes<E>());
  at.msk = contig ? 15 : gather_bytes<E>() - 1;
  return at;
}

// row_dot_g over rows rr0 + b of such a copy in shared memory
template <typename T, typename E, int VB, int CH>
__device__ __forceinline__ T row_dot_s(const unsigned char* rows, int slot,
                                       const RowAt& at, int rr0, const T* x,
                                       int v) {
  T y = (T)0;
#pragma unroll 1
  for (int b0 = 0; b0 < VB; b0 += CH) {
#pragma unroll
    for (int bb = 0; bb < CH; ++bb) {
      const int b = b0 + bb;
      if (b < v) {
        const int rr = rr0 + b;
        const E w = *reinterpret_cast<const E*>(
            rows + (size_t)rr * slot + at.lo +
            ((at.sh0 + rr * at.dn) & at.msk));
        y += widen<T, E>(w) * x[b];
      }
    }
  }
  return y;
}

// K6 at a run-time width: fgmres_rows_kernel's cycle (the same phases,
// reductions and scalar recurrence) with one 32-node group a block of v
// warps; P.res: the resident form (the block's groups' sweep blocks and
// dinv in shared memory for the whole launch), else the streamed one.
// Entries are int-indexed (launch_fgmres_rt: n v < 2^31).
template <typename T, typename S, int VB>
__global__ void __launch_bounds__(fg_rt_threads(VB), fg_rt_blocks(VB))
fgmres_rt_kernel(FgArgs<T, S> A, RtPlan P) {
  constexpr int CH = SU2K_RT_K6_CH;
  constexpr bool RES = fg_rt_resident(VB);
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char fg_smem[];
  T* sh = reinterpret_cast<T*>(fg_smem);
  const int n = A.n, m = A.m, v = A.v, vp = v | 1, k = A.st.k;
  T* wsum = sh;              // 32 warp partials
  T* bc = sh + 32;           // reduction broadcast
  T* sc = sh + 40;           // active, iters, res_hist, vact, vden
  T* rc = sh + 48;           // m + 1: the new Hessenberg column
  T* cs = rc + m + 1;        // m
  T* sn = cs + m;            // m
  T* g = sn + m;             // m + 1
  T* y = g + m + 1;          // m
  T* cols = y + m;           // m * m: rotated column j, row i at j*m + i
  // the group's vectors (row stride vp): K neighbour z, r (or z), results
  T* gx = sh + fg_smem_words(m);
  T* gr = gx + SU2K_MAXK * 32 * vp;
  T* gacc = gr + 32 * vp;
  unsigned char* resid = fg_smem + P.base;
  const int t = threadIdx.x, l = t & 31, a = t >> 5;
  const int nv = n * v;
  T* vb = A.ws;
  T* zb = vb + (size_t)(m + 1) * nv;
  T* zs = zb + (size_t)m * nv;
  T* wv = zs + nv;
  const int tid = blockIdx.x * blockDim.x + t;
  const int nth = gridDim.x * blockDim.x;
  const int ngroup = (n + 31) / 32;
  const int npass = 2 * A.ncolor - 1;
  const T tiny = (T)1e-300;   // 0 in float, as in the reference
  const size_t kvv = (size_t)k * v * v;
  int buf = 0;

  // the resident form: the block's groups' sweep blocks (K v v rows of
  // P.slot_s bytes) and dinv (v v rows of P.slot_t), copied once
  if (RES && P.res) {
    int* ids = reinterpret_cast<int*>(gacc);
    for (int gi = blockIdx.x, jr = 0; gi < ngroup; gi += gridDim.x, ++jr) {
      const int i0 = gi * 32, nl = n - i0 < 32 ? n - i0 : 32;
      __syncthreads();
      if (t < 32) ids[t] = t < nl ? A.order[i0 + t] : 0;
      __syncthreads();
      unsigned char* rg = resid + (size_t)jr * P.grp;
      rows_copy<S>(rg, P.slot_s, A.selp, kvv * n, n, (int)kvv, A.cm, i0, nl,
                   ids, t, blockDim.x);
      rows_copy<T>(rg + kvv * P.slot_s, P.slot_t, A.dinv, (size_t)v * v * n,
                   n, v * v, A.cm, i0, nl, ids, t, blockDim.x);
    }
    cp_wait_all();
    __syncthreads();
  }

  // exact power-of-two scaling of b (krylov._pow2_scale)
  T amax = (T)0;
  for (int e = tid; e < nv; e += nth) {
    T u = fab(A.b[e]);
    amax = u > amax ? u : amax;
  }
  amax = grid_reduce<T, true>(grid, amax, A.part, buf, wsum, bc);
  const T s = amax > (T)0 ? pow2_floor(amax > tiny ? amax : tiny) : (T)1;
  T ss = (T)0;
  for (int e = tid; e < nv; e += nth) {
    T bv = A.b[e] / s;
    ss += bv * bv;
  }
  const T beta = sq(grid_reduce<T, false>(grid, ss, A.part, buf, wsum, bc));
  const T norm0 = beta > tiny ? beta : tiny;
  for (int e = tid; e < nv; e += nth) vb[e] = (A.b[e] / s) / norm0;
  if (t == 0) {
    sc[0] = (beta / norm0 >= A.tol) ? (T)1 : (T)0;
    sc[1] = (T)0;
    sc[2] = beta;
    sc[3] = (T)0;
    sc[4] = (T)1;
    g[0] = beta;
  }
  __syncthreads();

  for (int j = 0; j < m; ++j) {
    T* vj = vb + (size_t)j * nv;
    T* zj = zb + (size_t)j * nv;
    const bool vact = sc[3] != (T)0;
    const T vden = sc[4];
    // v_j: written in the phase before (v_0) or in the first pass's phase
    // (j > 0: entry e of the normalised w, or v_{j-1} once the cycle
    // stopped) by the flat entry mapping, so the first pass, which reads
    // other nodes' entries, forms it on the fly with the same operations
    auto vnew = [&](int e) {
      if (j == 0) return (A.b[e] / s) / norm0;
      return vact ? __ldcg(wv + e) / vden : __ldcg(vj - nv + e);
    };
    if (j > 0)
      for (int e = tid; e < nv; e += nth) vj[e] = vnew(e);
    // z_j = sweep(v_j)
    const T* zold = nullptr;
    for (int i = 0; i < npass; ++i) {
      const int color = i < A.ncolor ? i : 2 * A.ncolor - 2 - i;
      const bool first = i == 0;
      T* dst = ((npass - 1 - i) & 1) ? zs : zj;
      for (int gi = blockIdx.x, jr = 0; gi < ngroup;
           gi += gridDim.x, ++jr) {
        const int i0 = gi * 32;
        {
          // stage: element e = (node e / v, entry e % v) of each vector
          const int ls = t / v, b = t - ls * v, is = i0 + ls;
          if (is < n) {
            const int ps = A.order[is];
            if (A.colors[ps] == color) {
              const int idx = ps * v + b;
              gr[ls * vp + b] = first ? vnew(idx) : __ldcg(vj + idx);
              for (int kk = 0; kk < k && !first; ++kk) {
                const int q = ps + A.st.off[kk];
                gx[kk * 32 * vp + ls * vp + b] =
                    q < 0 || q >= n ? (T)0 : __ldcg(zold + q * v + b);
              }
            }
          }
        }
        __syncthreads();
        const int ii = i0 + l;
        const int p = ii < n ? A.order[ii] : 0;
        const bool mine = ii < n && A.colors[p] == color;
        const int lane = A.cm ? ii : p;
        const int key = A.cm ? i0 : p;   // the resident copy's first lane
        const unsigned char* rg = resid + (size_t)jr * P.grp;
        if (mine) {
          T acc = gr[l * vp + a];
          if (!first) {
            const RowAt at = row_at<S>(A.selp, n, A.cm, key, l);
            T od = (T)0;
            for (int kk = 0; kk < k; ++kk) {
              const int q = p + A.st.off[kk];
              if (q < 0 || q >= n) continue;
              const T* x = gx + kk * 32 * vp + l * vp;
              const int row = kk * v * v + a * v;
              od += RES && P.res
                        ? row_dot_s<T, S, VB, CH>(rg, P.slot_s, at, row, x, v)
                        : row_dot_g<T, S, VB, CH>(
                              A.selp + (size_t)row * n + lane, n, x, v);
            }
            acc = acc - od;
          }
          gacc[l * vp + a] = acc;
        }
        __syncthreads();
        if (ii < n) {
          T zn;
          if (mine) {
            const RowAt at = row_at<T>(A.dinv, n, A.cm, key, l);
            zn = RES && P.res
                     ? row_dot_s<T, T, VB, CH>(rg + kvv * P.slot_s,
                                               P.slot_t, at, a * v,
                                               gacc + l * vp, v)
                     : row_dot_g<T, T, VB, CH>(
                           A.dinv + (size_t)a * v * n + lane, n,
                           gacc + l * vp, v);
          } else {
            zn = first ? (T)0 : __ldcg(zold + p * v + a);
          }
          dst[p * v + a] = zn;
        }
        __syncthreads();
      }
      grid.sync();
      zold = dst;
    }
    // w = A z_j (natural layout, 32 consecutive nodes a group), fused with
    // the first Gram-Schmidt dot (v_0, w)
    T part = (T)0;
    for (int gi = blockIdx.x; gi < ngroup; gi += gridDim.x) {
      const int p0 = gi * 32;
      {
        const int ls = t / v, b = t - ls * v, ps = p0 + ls;
        if (ps < n) {
          gr[ls * vp + b] = __ldcg(zj + ps * v + b);
          for (int kk = 0; kk < k; ++kk) {
            const int q = ps + A.st.off[kk];
            gx[kk * 32 * vp + ls * vp + b] =
                q < 0 || q >= n ? (T)0 : __ldcg(zj + q * v + b);
          }
        }
      }
      __syncthreads();
      const int p = p0 + l;
      if (p < n) {
        T od = (T)0;
        for (int kk = 0; kk < k; ++kk) {
          const int q = p + A.st.off[kk];
          if (q < 0 || q >= n) continue;
          od += row_dot_g<T, T, VB, CH>(
              A.selm + ((size_t)kk * v * v + a * v) * n + p, n,
              gx + kk * 32 * vp + l * vp, v);
        }
        T w = row_dot_g<T, T, VB, CH>(A.diag + (size_t)a * v * n + p, n,
                                      gr + l * vp, v);
        w = w + od;
        const int e = p * v + a;
        wv[e] = w;
        part += __ldcg(vb + e) * w;
      }
      __syncthreads();
    }
    T h = grid_reduce<T, false>(grid, part, A.part, buf, wsum, bc);
    const bool active = sc[0] != (T)0;
    // modified Gram-Schmidt: w -= h_ij v_i, then the next dot (or |w|^2)
    for (int i = 0; i <= j; ++i) {
      const T hij = active ? h : (i == j ? (T)1 : (T)0);
      const T hm = active ? hij : (T)0;
      if (t == 0) rc[i] = hij;
      const T* vi = vb + (size_t)i * nv;
      part = (T)0;
      for (int e = tid; e < nv; e += nth) {
        T tv = __ldcg(wv + e) - hm * __ldcg(vi + e);
        wv[e] = tv;
        part += (i < j) ? __ldcg(vi + nv + e) * tv : tv * tv;
      }
      h = grid_reduce<T, false>(grid, part, A.part, buf, wsum, bc);
    }
    if (t == 0)
      fg_column(j, m, active, h, norm0, A.tol, sc, rc, cs, sn, g, cols);
    __syncthreads();
  }

  // back-substitution on the rotated R, then x = s * sum_j y_j z_j
  if (t == 0) fg_solve_y(m, norm0, sc, g, cols, y, A.stats);
  __syncthreads();
  for (int e = tid; e < nv; e += nth) {
    T d = __ldcg(zb + e) * y[0];
    for (int jz = 1; jz < m; ++jz)
      d = d + y[jz] * __ldcg(zb + (size_t)jz * nv + e);
    A.x[e] = d * s;
  }
}

// blocks of K6's run-time kernel (32 v threads, smem bytes) co-resident on
// the card, at most cap; the largest dynamic shared memory a block may
// ask for granted to it
template <typename T, typename S, int VB>
cudaError_t fg_rt_fit(int v, size_t smem, int cap, int* blocks) {
  auto kern = fgmres_rt_kernel<T, S, VB>;
  int dev = 0, coop = 0, sms = 0, per_sm = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  if (smem > (size_t)optin) return cudaErrorInvalidValue;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, 32 * v,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int b = per_sm * sms < cap ? per_sm * sms : cap;
  *blocks = b > 0 ? b : 1;
  return cudaSuccess;
}

// K6's cooperative grid at a run-time width, class VB: the co-resident
// blocks at the streamed form's shared memory P.smem (kernels.k6_plan
// decides the form for this grid), at most one per group and the partial
// buffers' capacity
template <typename T, typename S, int VB>
int grid_rt(int v, int n, int m, const RtPlan& P, int part_cap) {
  if (P.vb != VB || P.base != fg_rt_base<T>(v, m) || P.smem < P.base)
    return -(int)cudaErrorInvalidValue;
  const int ngroup = (n + 31) / 32;
  int blocks = 0;
  const cudaError_t err = fg_rt_fit<T, S, VB>(
      v, P.smem, ngroup < part_cap / 2 ? ngroup : part_cap / 2, &blocks);
  return err == cudaSuccess ? blocks : -(int)err;
}

// K6 at a run-time width with kernels.k6_plan's plan (its grid and form);
// a grid the plan's shared memory does not keep co-resident is refused
template <typename T, typename S, int VB>
int launch_fgmres_rt(FgArgs<T, S> A, const RtPlan& P, int part_cap,
                     cudaStream_t stream) {
  const int ngroup = (A.n + 31) / 32;
  if ((long long)A.n * A.v > 0x7fffffffLL || P.vb != VB ||
      P.base != fg_rt_base<T>(A.v, A.m) || P.smem < P.base || P.grid < 1 ||
      P.grid > part_cap / 2 || P.grid > ngroup ||
      (P.res && (!fg_rt_resident(VB) ||
                 P.gpb < (ngroup + P.grid - 1) / P.grid)))
    return (int)cudaErrorInvalidValue;
  int fit = 0;
  cudaError_t err = fg_rt_fit<T, S, VB>(A.v, P.smem, P.grid, &fit);
  if (err != cudaSuccess) return (int)err;
  if (fit < P.grid) return (int)cudaErrorCooperativeLaunchTooLarge;
  RtPlan plan = P;
  void* args[] = {&A, &plan};
  err = cudaLaunchCooperativeKernel(
      (const void*)fgmres_rt_kernel<T, S, VB>, dim3(P.grid), dim3(32 * A.v),
      args, P.smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The run-time width classes (kernels.STENCIL_RT_CLASSES): width v runs
// the instance of the first class bound VB >= v
#define SU2K_BY_CLASS(v, CALL)                            \
  if ((v) <= 6) { constexpr int VB = 6; return CALL; }    \
  if ((v) <= 12) { constexpr int VB = 12; return CALL; }  \
  if ((v) <= 16) { constexpr int VB = 16; return CALL; }  \
  { constexpr int VB = 21; return CALL; }

// The grid of K6's rows kernel at a compiled width V >= 7: every block
// co-resident (the cooperative launch's condition) and at
// most the partial buffers' capacity: as many blocks as fit on all the
// card's SMs at once (by the occupancy of its registers and shared
// memory, at this width's block and staging size), at most one per G
// 32-node groups.  Wider blocks take more registers per thread, so fewer
// blocks fit on an SM.
template <typename T, typename S, int V>
cudaError_t fgmres_grid(int n, int m, int part_cap, int* blocks,
                        size_t* smem, int* threads) {
  constexpr int v = V;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  *threads = fg_rows_threads(v);
  *smem = (size_t)(fg_smem_words(m) + fg_rows_stage_words(v)) * sizeof(T);
  const void* kern = (const void*)fgmres_rows_kernel<T, S, V>;
  if (*smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
    if (err != cudaSuccess) return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      *threads, *smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int per_block = 32 * k5_groups(v);
  int b = (n + per_block - 1) / per_block;
  b = b < per_sm * sms ? b : per_sm * sms;  // co-resident
  b = b < part_cap / 2 ? b : part_cap / 2;
  *blocks = b > 0 ? b : 1;
  return cudaSuccess;
}

// the launch configuration of K6's cluster kernel (V <= 3): one cluster of
// c CTAs of SU2K_FG_CLUSTER_THREADS threads; at points at storage for its
// one attribute
inline cudaLaunchConfig_t fg_cluster_config(int c, size_t smem,
                                            cudaStream_t stream,
                                            cudaLaunchAttribute* at) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c);
  cfg.blockDim = dim3(SU2K_FG_CLUSTER_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = c;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cfg;
}

// The cluster size of K6's kernel kern at V <= 3 with smem bytes of
// dynamic shared memory: want (1 to 16), or with want 0 the non-portable
// 16 where cudaOccupancyMaxActiveClusters says one such cluster fits on
// this card, else the portable 8; an error where the card cannot launch
// clusters or the size does not fit.
template <typename K>
cudaError_t fg_cluster_size(K* kern, size_t smem, int want, int* csize) {
  int dev = 0, ok = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&ok, cudaDevAttrClusterLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!ok) return cudaErrorNotSupported;
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tries[2] = {want ? want : 16, want ? want : 8};
  for (int c : tries) {
    cudaLaunchAttribute at[1];
    cudaLaunchConfig_t cfg = fg_cluster_config(c, smem, 0, at);
    int fit = 0;
    err = cudaOccupancyMaxActiveClusters(&fit, kern, &cfg);
    if (err != cudaSuccess) return err;
    if (fit >= 1) {
      *csize = c;
      return cudaSuccess;
    }
  }
  return cudaErrorInvalidConfiguration;
}

// K6's cluster at V <= 3: the resident form (fgmres_cluster_kernel with
// RES) where its cluster gives every node a thread and its shared memory
// holds the basis, else the form with the basis in device memory; *kern,
// the cluster size and the dynamic shared memory of the launch
template <typename T, typename S, int V>
cudaError_t fg_cluster_plan(int n, int m, int want,
                            void (**kern)(FgArgs<T, S>), int* csize,
                            size_t* smem) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const size_t base = (size_t)(fg_smem_words(m) + 2) * sizeof(T);
  const size_t res = base + (size_t)m * V * SU2K_FG_CLUSTER_THREADS
                              * sizeof(T);
  if (res <= (size_t)optin) {
    err = fg_cluster_size(fgmres_cluster_kernel<T, S, V, true>, res, want,
                          csize);
    if (err == cudaSuccess && n <= *csize * SU2K_FG_CLUSTER_THREADS) {
      *kern = fgmres_cluster_kernel<T, S, V, true>;
      *smem = res;
      return cudaSuccess;
    }
  }
  *kern = fgmres_cluster_kernel<T, S, V, false>;
  *smem = base;
  return fg_cluster_size(fgmres_cluster_kernel<T, S, V, false>, base, want,
                         csize);
}

template <typename T, typename S, int V>
int launch_fgmres(FgArgs<T, S> A, int part_cap, int cluster,
                  cudaStream_t stream) {
  cudaError_t err;
  if constexpr (V <= 3) {
    void (*kern)(FgArgs<T, S>) = nullptr;
    int c = 0;
    size_t smem = 0;
    err = fg_cluster_plan<T, S, V>(A.n, A.m, cluster, &kern, &c, &smem);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute at[1];
    cudaLaunchConfig_t cfg = fg_cluster_config(c, smem, stream, at);
    err = cudaLaunchKernelEx(&cfg, kern, A);
  } else {
    int blocks = 0, threads = 0;
    size_t smem = 0;
    err = fgmres_grid<T, S, V>(A.n, A.m, part_cap, &blocks, &smem, &threads);
    if (err != cudaSuccess) return (int)err;
    void* args[] = {&A};
    err = cudaLaunchCooperativeKernel((const void*)fgmres_rows_kernel<T, S, V>,
                                      dim3(blocks), dim3(threads), args, smem,
                                      stream);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// blocks of K6's launch at a compiled width: the cluster size at V = 2,
// 3, the cooperative grid at V >= 7
template <typename T, typename S, int V>
int grid_of(int n, int m, int part_cap, int cluster) {
  int blocks = 0, threads = 0;
  size_t smem = 0;
  cudaError_t err;
  if constexpr (V <= 3) {
    void (*kern)(FgArgs<T, S>) = nullptr;
    err = fg_cluster_plan<T, S, V>(n, m, cluster, &kern, &blocks, &smem);
  } else
    err = fgmres_grid<T, S, V>(n, m, part_cap, &blocks, &smem, &threads);
  return err == cudaSuccess ? blocks : -(int)err;
}

// the block widths K5 and K6 are compiled for (kernels.STENCIL_WIDTHS): 2
// (the SST's k-omega system) and 3, and the flow's nDim + nSpecies + 2 of
// the 3-species flat plate in 2D (7) and 3D (8) and of the 9-species
// channel in 2D (13) and on the 3D box (14); CALL names the width V.
// Every other width from 4 to SU2K_VMAX, and every width of that range
// with rt, runs RTCALL (the run-time kernels, by class: SU2K_BY_CLASS);
// another width returns BAD
#define SU2K_BY_WIDTH(v, rt, CALL, RTCALL, BAD)         \
  switch (rt ? 0 : v) {                                 \
    case 2: { constexpr int V = 2; return CALL; }       \
    case 3: { constexpr int V = 3; return CALL; }       \
    case 7: { constexpr int V = 7; return CALL; }       \
    case 8: { constexpr int V = 8; return CALL; }       \
    case 13: { constexpr int V = 13; return CALL; }     \
    case 14: { constexpr int V = 14; return CALL; }     \
    default: {                                          \
      if (v < 4 || v > SU2K_VMAX) return BAD;           \
      SU2K_BY_CLASS(v, RTCALL)                          \
    }                                                   \
  }

template <typename T, typename S>
int fgmres_v(int v, int rt, int n, const Stencil& st, int ncolor, int m,
             double tol, const void* selp, const void* selm,
             const void* dinv, const void* diag, const void* colors,
             const void* order, int cm, const void* b, void* x, void* stats,
             void* ws, void* part, int part_cap, int cluster,
             const RtPlan& P, cudaStream_t stream) {
  FgArgs<T, S> A{n, ncolor, m, st, (T)tol, (const S*)selp, (const T*)selm,
                 (const T*)dinv, (const T*)diag, (const int8_t*)colors,
                 (const int*)order, cm, (const T*)b, (T*)x, (T*)stats,
                 (T*)ws, (T*)part, v};
  SU2K_BY_WIDTH(v, rt,
                (launch_fgmres<T, S, V>(A, part_cap, cluster, stream)),
                (launch_fgmres_rt<T, S, VB>(A, P, part_cap, stream)),
                (int)cudaErrorInvalidValue)
}

template <typename T, typename S>
int fgmres_grid_v(int v, int rt, int n, int m, int part_cap, int cluster,
                  const RtPlan& P) {
  SU2K_BY_WIDTH(v, rt, (grid_of<T, S, V>(n, m, part_cap, cluster)),
                (grid_rt<T, S, VB>(v, n, m, P, part_cap)),
                -(int)cudaErrorInvalidValue)
}

template <typename T, typename S>
int sgs_matvec_v(int v, int rt, int n, const Stencil& st, int ncolor,
                 int do_sweep, int do_matvec, int cm, const void* selp,
                 const void* selm, const void* dinv, const void* diag,
                 const void* colors, const void* order, const void* r,
                 void* z, void* w, void* zbuf, cudaStream_t stream) {
#define SU2K_SGS_ARGS                                                      \
  n, st, ncolor, do_sweep, do_matvec, cm, (const S*)selp, (const T*)selm,  \
      (const T*)dinv, (const T*)diag, (const int8_t*)colors,               \
      (const int*)order, (const T*)r, (T*)z, (T*)w, (T*)zbuf
  SU2K_BY_WIDTH(v, rt, (launch_sgs_matvec<T, S, V>(SU2K_SGS_ARGS, stream)),
                (launch_sgs_matvec_rt<T, S, VB>(v, SU2K_SGS_ARGS, stream)),
                (int)cudaErrorInvalidValue)
#undef SU2K_SGS_ARGS
}

inline bool make_stencil(int k, const int* offs, Stencil& st) {
  if (k < 1 || k > SU2K_MAXK) return false;
  st.k = k;
  for (int i = 0; i < SU2K_MAXK; ++i) st.off[i] = i < k ? offs[i] : 0;
  return true;
}

}  // namespace su2k

// K6's plan at a run-time width (kernels.k6_plan: the RtPlan fields as
// ints), or null at a compiled width
inline su2k::RtPlan rt_plan(const int* plan) {
  su2k::RtPlan P = {};
  if (plan) {
    int* f = reinterpret_cast<int*>(&P);
    for (int i = 0; i < (int)(sizeof(P) / sizeof(int)); ++i) f[i] = plan[i];
  }
  return P;
}

// sel_bf16: the sweep blocks selp are __nv_bfloat16 (float state only);
// order: the color-major node list (int32, n); cm: selp and dinv are in
// the color-major lane layout (lane i = node order[i]), else natural; rt:
// the run-time kernels at any width from 4 to SU2K_VMAX (else they run
// the widths with no compiled instance only)
extern "C" int su2k_stencil_sgs_matvec(
    int is_f64, int sel_bf16, int v, int n, int k, const int* offs,
    int ncolor, int do_sweep, int do_matvec, int cm, const void* selp,
    const void* selm, const void* dinv, const void* diag, const void* colors,
    const void* order, const void* r, void* z, void* w, void* zbuf,
    void* stream, int rt) {
  su2k::Stencil st;
  if (!su2k::make_stencil(k, offs, st) || (is_f64 && sel_bf16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_f64)
    return su2k::sgs_matvec_v<double, double>(
        v, rt, n, st, ncolor, do_sweep, do_matvec, cm, selp, selm, dinv,
        diag, colors, order, r, z, w, zbuf, s);
  if (sel_bf16)
    return su2k::sgs_matvec_v<float, __nv_bfloat16>(
        v, rt, n, st, ncolor, do_sweep, do_matvec, cm, selp, selm, dinv,
        diag, colors, order, r, z, w, zbuf, s);
  return su2k::sgs_matvec_v<float, float>(
      v, rt, n, st, ncolor, do_sweep, do_matvec, cm, selp, selm, dinv, diag,
      colors, order, r, z, w, zbuf, s);
}

// order, cm: at v >= 4 the color-major node list (int32, n) and whether
// selp and dinv are in its lane layout (else natural); ignored at v <= 3,
// which read the natural layout.  part: the rows kernels' block partials
// (part_cap values).  cluster: at v <= 3 the cluster size (1 to 16), or 0
// for 16 where it fits on the card, else 8.  rt: as in
// su2k_stencil_sgs_matvec; plan: kernels.k6_plan's (the grid and the
// form), read at a run-time width only
extern "C" int su2k_stencil_fgmres(
    int is_f64, int sel_bf16, int v, int n, int k, const int* offs,
    int ncolor, int m, double tol, const void* selp, const void* selm,
    const void* dinv, const void* diag, const void* colors,
    const void* order, int cm, const void* b, void* x, void* stats,
    void* ws, void* part, int part_cap, int cluster, void* stream, int rt,
    const int* plan) {
  su2k::Stencil st;
  if (!su2k::make_stencil(k, offs, st) || (is_f64 && sel_bf16) || m < 1 ||
      n < 1 || (v > 3 && order == nullptr) || (v <= 3 && cm) ||
      cluster < 0 || cluster > 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const su2k::RtPlan P = rt_plan(plan);
  if (is_f64)
    return su2k::fgmres_v<double, double>(v, rt, n, st, ncolor, m, tol,
                                          selp, selm, dinv, diag, colors,
                                          order, cm, b, x, stats, ws, part,
                                          part_cap, cluster, P, s);
  if (sel_bf16)
    return su2k::fgmres_v<float, __nv_bfloat16>(
        v, rt, n, st, ncolor, m, tol, selp, selm, dinv, diag, colors, order,
        cm, b, x, stats, ws, part, part_cap, cluster, P, s);
  return su2k::fgmres_v<float, float>(v, rt, n, st, ncolor, m, tol, selp,
                                      selm, dinv, diag, colors, order, cm, b,
                                      x, stats, ws, part, part_cap, cluster,
                                      P, s);
}

// the blocks su2k_stencil_fgmres launches for these arguments on the
// current device: at v <= 3 the cluster's CTAs (of 1024 threads), at a
// compiled v >= 7 the cooperative grid (of 32 v k5_groups(v) threads), at
// a run-time width the co-resident blocks of 32 v threads at the streamed
// form's shared memory (plan: kernels.k6_plan's, for any grid); or minus
// a cudaError_t
extern "C" int su2k_stencil_fgmres_grid(int is_f64, int sel_bf16, int v,
                                        int n, int m, int part_cap,
                                        int cluster, int rt,
                                        const int* plan) {
  if ((is_f64 && sel_bf16) || m < 1 || n < 1 || cluster < 0 || cluster > 16)
    return -(int)cudaErrorInvalidValue;
  const su2k::RtPlan P = rt_plan(plan);
  if (is_f64)
    return su2k::fgmres_grid_v<double, double>(v, rt, n, m, part_cap,
                                               cluster, P);
  if (sel_bf16)
    return su2k::fgmres_grid_v<float, __nv_bfloat16>(v, rt, n, m, part_cap,
                                                     cluster, P);
  return su2k::fgmres_grid_v<float, float>(v, rt, n, m, part_cap, cluster,
                                           P);
}
